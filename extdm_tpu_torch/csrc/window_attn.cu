// Small-sequence attention on projected heads (kernel 12):
//
//   window_attention  replaces extdm_tpu/ops/pallas_attn.py
//                     fused_window_attention (_attention_pallas ->
//                     _make_kernel): out = softmax(q k^T + bias + mask) v per
//                     sequence and head, q already scaled and rotated,
//                     q/k/v/out (BW, H, N, D), bias (H, N, N) and the
//                     deduplicated shift masks (M, N, N) float32, sequence i
//                     taking masks[ids[i % nW]].
//
// It is the attention core of the unfused window layer (3-D windows, N = 64)
// and of the unfused temporal layer (N = T = 30): the route for the layers the
// whole-layer kernels 1 and 2 do not take (C > 256). Bound on the H100: bytes
// at these sizes (4 N D flops per query row against 8 D bytes of q, k, v and
// out); the scores never leave the chip. One block per group of G sequences
// and one head: the block stages each sequence's q, k and v in shared memory
// (N <= 64, D <= 32), takes one softmax per row in float32 with the row's
// own max, and writes its outputs once. Sequences stay apart: each 16-row
// tile of queries scores only its own sequence's keys (the TPU kernel's
// packing of sequences into one large product with a -inf off-diagonal
// filled the MXU; here a 64-row tile is G sequences side by side). In bf16
// q k^T and P v run on the tensor cores (mma.sync m16n8k16, float
// accumulators; P is rounded to bf16 as the A operand); in float32 each warp
// takes one query row with FMAs.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 128;   // 4 warps: a 64-row tile of queries
constexpr int MAXN = 64;
constexpr int MAXD = 32;
constexpr int PAD = 8;    // extra bf16 per staged row: spreads banks

struct Args {
  const float* bias;   // (H, N, N)
  const float* masks;  // (M, N, N) or null
  const int* ids;      // (nW) or null
  int BW, H, N, D, nW, G;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---- bf16: sequence s = blockIdx.x * G + j occupies rows j * Np .. of the
// block's tile (Np = N rounded up to 16); warp w takes rows 16 w .. 16 w + 15.
__global__ void __launch_bounds__(NT) attn_mma_kernel(const bf16* __restrict__ q,
                                                     const bf16* __restrict__ k,
                                                     const bf16* __restrict__ v,
                                                     bf16* __restrict__ out, Args a) {
  constexpr int QS = MAXD + PAD;       // row stride of q, k: [row][d]
  constexpr int VS = MAXN + PAD;       // row stride of v^T: [d][key]
  __shared__ __align__(16) bf16 qs[MAXN * QS];
  __shared__ __align__(16) bf16 ks[MAXN * QS];
  __shared__ __align__(16) bf16 vt[MAXD * VS * (MAXN / 16)];  // one v^T per sequence slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int N = a.N, D = a.D, h = blockIdx.y;
  const int Np = (N + 15) / 16 * 16, DK = (D + 15) / 16 * 16;
  const long long s0 = (long long)blockIdx.x * a.G;

  // stage: rows past N, dims past D and sequences past BW are zero
  for (int e = tid; e < a.G * Np * DK; e += NT) {
    const int d = e % DK, r = e / DK, j = r / Np, n = r % Np;
    const long long s = s0 + j;
    bf16 qv = __float2bfloat16(0.f), kv = qv, vv = qv;
    if (s < a.BW && n < N && d < D) {
      const long long off = ((s * a.H + h) * N + n) * D + d;
      qv = q[off];
      kv = k[off];
      vv = v[off];
    }
    qs[r * QS + d] = qv;
    ks[r * QS + d] = kv;
    vt[(j * MAXD + d) * VS + n] = vv;
  }
  __syncthreads();

  const int r0 = 16 * warp;  // first row of this warp's tile
  const int j = r0 / Np;     // its sequence slot
  const long long s = s0 + j;
  if (r0 >= a.G * Np || s >= a.BW) return;
  const int kbase = j * Np, nk = Np / 8;  // the sequence's first key row, its n8 key tiles
  float sc[MAXN / 8][4];
#pragma unroll
  for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
  for (int kk = 0; kk < DK; kk += 16) {
    const bf16* a_lo = qs + (r0 + g) * QS + kk + 2 * t4;
    const bf16* a_hi = a_lo + 8 * QS;
    const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
    for (int t = 0; t < MAXN / 8; ++t)
      if (t < nk) {
        const bf16* bp = ks + (kbase + 8 * t + g) * QS + kk + 2 * t4;
        mma_bf16(sc[t], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
      }
  }
  const float* bias_h = a.bias + (long long)h * N * N;
  const float* mask = a.masks != nullptr ? a.masks + (long long)a.ids[s % a.nW] * N * N : nullptr;
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int iq = r0 - kbase + g + 8 * (e >> 1), c = 8 * t + 2 * t4 + (e & 1);
      float val = neg_inf();  // a key past N, or a padding row
      if (t < nk && iq < N && c < N) {
        val = sc[t][e] + bias_h[iq * N + c];
        if (mask != nullptr) val += mask[iq * N + c];
      }
      sc[t][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // a row lives in the 4 lanes that share g
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    if (mx[hh] == neg_inf()) mx[hh] = 0.f;  // padding row
  }
#pragma unroll
  for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[t][e] = expf(sc[t][e] - mx[e >> 1]);
      sum[e >> 1] += sc[t][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    sum[hh] = sum[hh] > 0.f ? 1.f / sum[hh] : 0.f;
  }
  float oc[MAXD / 8][4];
#pragma unroll
  for (int t = 0; t < MAXD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oc[t][e] = 0.f;
  const bf16* vj = vt + j * MAXD * VS;
#pragma unroll
  for (int kk = 0; kk < MAXN / 16; ++kk) {  // 16 keys per step: score tiles 2 kk, 2 kk + 1
    if (2 * kk >= nk) break;
    const uint32_t a0 = pack_bf16(sc[2 * kk][0] * sum[0], sc[2 * kk][1] * sum[0]);
    const uint32_t a1 = pack_bf16(sc[2 * kk][2] * sum[1], sc[2 * kk][3] * sum[1]);
    const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0] * sum[0], sc[2 * kk + 1][1] * sum[0]);
    const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2] * sum[1], sc[2 * kk + 1][3] * sum[1]);
#pragma unroll
    for (int t = 0; t < MAXD / 8; ++t)
      if (8 * t < DK) {
        const bf16* bp = vj + (8 * t + g) * VS + 16 * kk + 2 * t4;
        mma_bf16(oc[t], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
      }
  }
#pragma unroll
  for (int t = 0; t < MAXD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int iq = r0 - kbase + g + 8 * (e >> 1), d = 8 * t + 2 * t4 + (e & 1);
      if (iq < N && d < D)
        out[((s * a.H + h) * N + iq) * D + d] = __float2bfloat16(oc[t][e]);
    }
}

// ---- float32: one warp per query row of the block's G sequences.
__global__ void __launch_bounds__(NT) attn_fma_kernel(const float* __restrict__ q,
                                                     const float* __restrict__ k,
                                                     const float* __restrict__ v,
                                                     float* __restrict__ out, Args a) {
  constexpr int RS = MAXD + 1;
  __shared__ float qs[MAXN * RS], ks[MAXN * RS], vs[MAXN * RS];
  __shared__ float ps[NT / 32][MAXN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, h = blockIdx.y;
  const long long s0 = (long long)blockIdx.x * a.G;
  const int rows = a.G * N;
  for (int e = tid; e < rows * D; e += NT) {
    const int d = e % D, r = e / D;
    const long long s = s0 + r / N;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (s < a.BW) {
      const long long off = ((s * a.H + h) * N + r % N) * D + d;
      qv = q[off];
      kv = k[off];
      vv = v[off];
    }
    qs[r * RS + d] = qv;
    ks[r * RS + d] = kv;
    vs[r * RS + d] = vv;
  }
  __syncthreads();
  const float* bias_h = a.bias + (long long)h * N * N;
  float* p = ps[warp];
  for (int r = warp; r < rows; r += NT / 32) {
    const long long s = s0 + r / N;
    if (s >= a.BW) break;
    const int iq = r % N, kbase = r - iq;
    const float* mask = a.masks != nullptr ? a.masks + (long long)a.ids[s % a.nW] * N * N : nullptr;
    float sv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      sv[u] = neg_inf();
      if (c < N) {
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qs[r * RS + d], ks[(kbase + c) * RS + d], acc);
        acc += bias_h[iq * N + c];
        if (mask != nullptr) acc += mask[iq * N + c];
        sv[u] = acc;
      }
    }
    const float mx = warp_max(fmaxf(sv[0], sv[1]));
    float e0 = lane < N ? expf(sv[0] - mx) : 0.f, e1 = lane + 32 < N ? expf(sv[1] - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    p[lane] = e0 * inv;
    p[lane + 32] = e1 * inv;
    __syncwarp();
    if (lane < D) {
      float acc = 0.f;
      for (int c = 0; c < N; ++c) acc = fmaf(p[c], vs[(kbase + c) * RS + lane], acc);
      out[((s * a.H + h) * N + iq) * D + lane] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// q, k, v, out (BW, H, N, D) in the dtype; bias (H, N, N) float32; masks
// (M, N, N) float32 and ids (nW) int32, or both null; G sequences per block.
extern "C" int window_attention(int dtype, const void* q, const void* k, const void* v,
                                const float* bias, const float* masks, const int* ids, void* out,
                                int BW, int H, int N, int D, int nW, int G, void* stream) {
  if (N < 1 || N > MAXN || D < 1 || D > MAXD || G < 1 || G * ((N + 15) / 16 * 16) > MAXN ||
      (masks != nullptr && (ids == nullptr || nW < 1)))
    return (int)cudaErrorInvalidValue;
  if (BW == 0 || H == 0) return 0;
  const Args a{bias, masks, ids, BW, H, N, D, nW, G};
  const dim3 grid((BW + G - 1) / G, H);
  if (dtype == 1)
    attn_mma_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>((const bf16*)q, (const bf16*)k,
                                                          (const bf16*)v, (bf16*)out, a);
  else if (dtype == 0)
    attn_fma_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>((const float*)q, (const float*)k,
                                                          (const float*)v, (float*)out, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
