// What kernels 2 and 6's bf16 bodies share (stw_layer.cu temporal_layer_wgmma,
// stw_layer_bwd.cu temporal_layer_bwd_wgmma): the token gather of the
// temporal layer and the operands read from the caller's parameters.
//
// A 64-row tile holds two sequences of SEQ frame slots: row r is frame
// r % SEQ of sequence 2 tile + r / SEQ, a sequence being one pixel of one
// sample (B H W sequences of T <= SEQ frames). Its token lies in x (B, T, H,
// W, C) at ((b T + t) H W + pixel) C: no pad of T and no permute, rows past T
// or past the last sequence read as zeros and are not written. The padding
// slots are masked by the bias table (-inf in rows and columns past T), so
// the kernels test no row in the attention.
#pragma once

#include "common.cuh"

namespace {

constexpr int SEQ = 32;  // frame slots of a sequence in a tile: two sequences a 64-row tile

// Token index of row r of 64-row tile `tile`, or -1 (past T, or past the
// nseq = B HW sequences).
__device__ __forceinline__ long long seq_token(int tile, int r, int T, int HW, int nseq) {
  const int s = 2 * tile + r / SEQ, t = r % SEQ;
  if (t >= T || s >= nseq) return -1;
  return ((long long)(s / HW) * T + t) * HW + s % HW;
}

// The inner LayerNorm of row r of a tile of 64-column, 128-byte-swizzled
// bf16 boxes holding h = ChanLN(x) (s2: this thread's part of the row's sum
// of h), four threads a row, this one taking chunks q0, q0 + 4, ...: hn =
// bf16((h - mean) / std ln_scale + ln_bias) in place (zero when !live, a
// row past T), and with dst (the row's token in a (tokens, C) matrix) there.
__device__ __forceinline__ void inner_layer_norm(uint8_t* tile, int r, int q0, int C, float s2,
                                                 float eps, const float* ln_scale,
                                                 const float* ln_bias, bool live, bf16* dst) {
  constexpr int BOX_BYTES = 64 * 128;
  const int nq = C / 8;
  s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
  s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
  const float mean = s2 / C;
  float var = 0.f;
  for (int q = q0; q < nq; q += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (q >> 3) * BOX_BYTES + sw128(r, q & 7));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mean;
      var += d * d;
    }
  }
  var += __shfl_xor_sync(0xffffffffu, var, 1);
  var += __shfl_xor_sync(0xffffffffu, var, 2);
  const float rstd = rsqrtf(var / C + eps);
  for (int q = q0; q < nq; q += 4) {
    uint4* ptr = reinterpret_cast<uint4*>(tile + (q >> 3) * BOX_BYTES + sw128(r, q & 7));
    uint4 v = *ptr;
    bf16* e = reinterpret_cast<bf16*>(&v);
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_scale + 8 * q));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_scale + 8 * q + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_bias + 8 * q));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_bias + 8 * q + 4));
    const float ls[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float lb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(live ? (__bfloat162float(e[i]) - mean) * rstd * ls[i] + lb[i] : 0.f);
    *ptr = v;
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + 8 * q) = v;
  }
}

// The operands as the kernels read them: Wqkv (3 hid, C) and Wout (C, hid)
// in bf16 (TMA reads them), gamma | ln_scale | ln_bias (3 C) float32, the
// bias table bm (heads, SEQ, SEQ) bf16: bf16(bias) for rows and columns < T,
// -inf past T (the reference casts the bias to the compute dtype before
// adding it to the scores), and bmt, its transpose in the last two dims (the
// backward's key rows read it). The plain version: fused_stw.temporal_operands_plain.
struct OperandPtrs {
  bf16* wq;
  bf16* wo;
  float* vec;
  bf16* bm;
  bf16* bmt;
};

// Their layout at the start of the entries' scratch, in this order, each
// region 256-byte aligned.
struct TemporalOperands {
  size_t wq, wo, vec, bm, bmt, total;
  TemporalOperands(int C, int heads) {
    size_t at = 0;
    auto take = [&at](size_t bytes) {
      const size_t off = at;
      at += (bytes + 255) / 256 * 256;
      return off;
    };
    const size_t hid = (size_t)heads * 32;
    wq = take(3 * hid * C * 2);
    wo = take(hid * C * 2);
    vec = take(3ull * C * 4);
    bm = take((size_t)heads * SEQ * SEQ * 2);
    bmt = take((size_t)heads * SEQ * SEQ * 2);
    total = at;
  }
  OperandPtrs at(uint8_t* base) const {
    return {reinterpret_cast<bf16*>(base + wq), reinterpret_cast<bf16*>(base + wo),
            reinterpret_cast<float*>(base + vec), reinterpret_cast<bf16*>(base + bm),
            reinterpret_cast<bf16*>(base + bmt)};
  }
};

// Element i of a float32 (code 0) or bf16 (code 1) array.
__device__ __forceinline__ float load_as_float(const void* p, int code, long long i) {
  return code ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// One launch writes every operand of TemporalOperands from the caller's
// tensors: weights in wdtype, the three vectors in vdtype, bias (heads, T, T)
// in bdtype (0 float32, 1 bf16).
__global__ void temporal_operands_kernel(const void* __restrict__ wqkv,
                                         const void* __restrict__ wout, int wdtype,
                                         const void* __restrict__ gamma,
                                         const void* __restrict__ ln_scale,
                                         const void* __restrict__ ln_bias, int vdtype,
                                         const void* __restrict__ bias, int bdtype, OperandPtrs d,
                                         int C, int heads, int T) {
  const long long hid = heads * 32, nq = 3 * hid * C, no = hid * C, nt = heads * SEQ * SEQ;
  const long long n = nq + no + 3LL * C + 2 * nt;
  bf16 *wq = d.wq, *wo = d.wo, *bm = d.bm, *bmt = d.bmt;
  float* vec = d.vec;
  const bf16 ninf = __ushort_as_bfloat16(0xff80);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long j = i;
    if (j < nq) {
      wq[j] = __float2bfloat16(load_as_float(wqkv, wdtype, j));
      continue;
    }
    j -= nq;
    if (j < no) {
      wo[j] = __float2bfloat16(load_as_float(wout, wdtype, j));
      continue;
    }
    j -= no;
    if (j < 3LL * C) {
      const void* src = j < C ? gamma : j < 2LL * C ? ln_scale : ln_bias;
      vec[j] = load_as_float(src, vdtype, j % C);
      continue;
    }
    j -= 3LL * C;
    const bool trans = j >= nt;
    j %= nt;
    const int h = (int)(j / (SEQ * SEQ)), r = (int)(j / SEQ % SEQ), c = (int)(j % SEQ);
    const int q = trans ? c : r, k = trans ? r : c;  // the table's query row and key column
    const long long at = ((long long)h * T + q) * T + k;
    const bf16 v = q < T && k < T ? __float2bfloat16(load_as_float(bias, bdtype, at)) : ninf;
    (trans ? bmt : bm)[j] = v;
  }
}

inline cudaError_t temporal_operands(const void* wqkv, const void* wout, int wdtype,
                                     const void* gamma, const void* ln_scale, const void* ln_bias,
                                     int vdtype, const void* bias, int bdtype, OperandPtrs d,
                                     int C, int heads, int T, cudaStream_t stream) {
  const long long n = 4LL * heads * 32 * C + 3LL * C + 2LL * heads * SEQ * SEQ;
  const long long want = (n + 255) / 256;
  temporal_operands_kernel<<<(int)(want < 512 ? want : 512), 256, 0, stream>>>(
      wqkv, wout, wdtype, gamma, ln_scale, ln_bias, vdtype, bias, bdtype, d, C, heads, T);
  return cudaGetLastError();
}

}  // namespace
