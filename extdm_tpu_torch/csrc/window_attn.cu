// Small-sequence attention on projected heads (kernel 12):
//
//   window_attention  replaces extdm_tpu/ops/pallas_attn.py
//                     fused_window_attention (_attention_pallas ->
//                     _make_kernel): out = softmax(q k^T + bias + mask) v per
//                     sequence and head, q already scaled and rotated,
//                     q/k/v (BW, H, N, D) by strides, bias (H, N, N) by
//                     strides (float32 or bf16), the deduplicated shift masks
//                     (M, N, N) float32, sequence i taking masks[ids[i % nW]];
//                     out written in (BW, N, H, D) order.
//
// It is the attention core of the unfused window and temporal layers
// (N = 64 and N = T = 30): the route for the layers the whole-layer kernels
// do not take. At these sizes the work is tiny (4 N D flops per query row
// against 8 D bytes of q, k, v and out; 256-512 sequence-heads a launch), so
// what bounds it on the H100 is latency: the launch, one round trip to
// memory and the block's serial chain. The design keeps that chain short.
// One block per group of G sequences and one head (G N rows <= 64, 4 warps,
// a 16-row query tile each). At entry q, k and v start for shared memory by
// 16-byte cp.async straight from the head-split views (strides, last dim
// contiguous; rows of 80 bytes so that fragment loads and ldmatrix hit
// distinct banks), and while they fly each thread loads the bias (and mask)
// values of its own scores into registers, by strides and in the bias's own
// type, so the wrapper makes no copy of a permuted or bf16 bias; each value
// is read once per block. One wait, one barrier. In bf16 q k^T and
// P v run on the tensor cores (mma.sync m16n8k16, float accumulators), v's
// fragments come by ldmatrix.trans from its row-major tile, the scores stay
// in registers with a float32 softmax and each row's own max, and the output
// goes out in (BW, N, H, D) order so the layer's head merge is a view. In
// float32 (the check path) each warp takes one query row with FMAs.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // 4 warps: a 64-row tile of queries
constexpr int MAXN = 64;
constexpr int MAXD = 32;
constexpr int RS = MAXD + 8;  // bf16 row stride of the staged q, k, v: 80 bytes

struct Args {
  const void* bias;              // (H, N, N) by strides bh, bi, bj, in BT
  const float* masks;            // (M, N, N) contiguous, or null
  const int* ids;                // (nW) or null
  int qb, qh, qn, kb, kh, kn, vb, vh, vn;  // q, k, v strides (sequence, head, row), elements
  int bh, bi, bj;
  int BW, H, N, D, nW, G, vec;   // vec: rows start on 16-byte boundaries, D % 8 == 0
  int pairs;                     // bias and mask values (j, j + 1) load as one: unit bj,
                                 // aligned rows, N even
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename BT>
__device__ __forceinline__ float bias_at(const Args& a, int h, int i, int j) {
  return to_f(__ldg(reinterpret_cast<const BT*>(a.bias) +
                    ((long long)h * a.bh + (long long)i * a.bi + (long long)j * a.bj)));
}

// Bias values (i, j) and (i, j + 1) in one load (Args::pairs).
__device__ __forceinline__ float2 bias_pair(const float* b, long long off) {
  return __ldg(reinterpret_cast<const float2*>(b + off));
}
__device__ __forceinline__ float2 bias_pair(const bf16* b, long long off) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(b + off)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- bf16: sequence s = blockIdx.x * G + j occupies rows j * Np .. of the
// block's tile (Np = N rounded up to 16); warp w takes rows 16 w .. 16 w + 15.
template <typename BT>
__global__ void __launch_bounds__(NT) attn_mma_kernel(const bf16* __restrict__ q,
                                                     const bf16* __restrict__ k,
                                                     const bf16* __restrict__ v,
                                                     bf16* __restrict__ out, Args a) {
  __shared__ __align__(16) bf16 qs[MAXN * RS];
  __shared__ __align__(16) bf16 ks[MAXN * RS];
  __shared__ __align__(16) bf16 vs[MAXN * RS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int N = a.N, D = a.D, h = blockIdx.y;
  const int Np = (N + 15) / 16 * 16, DK = (D + 15) / 16 * 16;
  const long long s0 = (long long)blockIdx.x * a.G;
  const int r0 = 16 * warp;  // first row of this warp's tile
  const int j = r0 / Np;     // its sequence slot
  const long long s = s0 + j;
  const bool live = r0 < a.G * Np && s < a.BW;
  const int kbase = j * Np, nk = Np / 8;  // the sequence's first key row, its n8 key tiles

  // the sequence's mask id first: its mask rows depend on it
  int mask_id = 0;
  if (live && a.masks != nullptr) mask_id = __ldg(a.ids + s % a.nW);

  // stage q, k, v: rows past N, dims past D and sequences past BW are zero
  if (a.vec) {
    const int chunks = DK / 8;
    for (int e = tid; e < a.G * Np * chunks; e += NT) {
      const int c = e % chunks, r = e / chunks, jj = r / Np, n = r % Np;
      const long long ss = s0 + jj;
      const bool ok = ss < a.BW && n < N && 8 * c < D;
      const uint32_t dst = (uint32_t)(r * RS + 8 * c) * 2;
      const long long qo = ss * a.qb + h * (long long)a.qh + n * (long long)a.qn + 8 * c;
      const long long ko = ss * a.kb + h * (long long)a.kh + n * (long long)a.kn + 8 * c;
      const long long vo = ss * a.vb + h * (long long)a.vh + n * (long long)a.vn + 8 * c;
      cp_async16(smem_addr(qs) + dst, ok ? q + qo : q, ok);
      cp_async16(smem_addr(ks) + dst, ok ? k + ko : k, ok);
      cp_async16(smem_addr(vs) + dst, ok ? v + vo : v, ok);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < a.G * Np * DK; e += NT) {
      const int d = e % DK, r = e / DK, jj = r / Np, n = r % Np;
      const long long ss = s0 + jj;
      bf16 qv = __float2bfloat16(0.f), kv = qv, vv = qv;
      if (ss < a.BW && n < N && d < D) {
        qv = q[ss * a.qb + h * (long long)a.qh + n * (long long)a.qn + d];
        kv = k[ss * a.kb + h * (long long)a.kh + n * (long long)a.kn + d];
        vv = v[ss * a.vb + h * (long long)a.vh + n * (long long)a.vn + d];
      }
      qs[r * RS + d] = qv;
      ks[r * RS + d] = kv;
      vs[r * RS + d] = vv;
    }
  }

  // bias and mask of this thread's scores, into registers while the copies
  // fly; -inf off the sequence
  float bb[MAXN / 8][4], mm[MAXN / 8][4];
  if (live && a.pairs) {  // c is even, and c < N means c + 1 < N
    const BT* bias = reinterpret_cast<const BT*>(a.bias) + (long long)h * a.bh;
    const float* mask = a.masks + (long long)mask_id * N * N;
#pragma unroll
    for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int iq = r0 - kbase + g + 8 * hh, c = 8 * t + 2 * t4;
        const bool ok = t < nk && iq < N && c < N;
        const float2 b = ok ? bias_pair(bias, (long long)iq * a.bi + c)
                            : make_float2(neg_inf(), neg_inf());
        const float2 m = ok && a.masks != nullptr
                             ? __ldg(reinterpret_cast<const float2*>(mask + iq * N + c))
                             : make_float2(0.f, 0.f);
        bb[t][2 * hh] = b.x, bb[t][2 * hh + 1] = b.y, mm[t][2 * hh] = m.x, mm[t][2 * hh + 1] = m.y;
      }
  } else if (live) {
    const float* mask = a.masks + (long long)mask_id * N * N;
#pragma unroll
    for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int iq = r0 - kbase + g + 8 * (e >> 1), c = 8 * t + 2 * t4 + (e & 1);
        const bool ok = t < nk && iq < N && c < N;
        bb[t][e] = ok ? bias_at<BT>(a, h, iq, c) : neg_inf();
        mm[t][e] = ok && a.masks != nullptr ? __ldg(mask + iq * N + c) : 0.f;
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;

  float sc[MAXN / 8][4];
#pragma unroll
  for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
  for (int kk = 0; kk < DK; kk += 16) {
    const bf16* a_lo = qs + (r0 + g) * RS + kk + 2 * t4;
    const bf16* a_hi = a_lo + 8 * RS;
    const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
    for (int t = 0; t < MAXN / 8; ++t)
      if (t < nk) {
        const bf16* bp = ks + (kbase + 8 * t + g) * RS + kk + 2 * t4;
        mma_bf16(sc[t], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
      }
  }
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int t = 0; t < MAXN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[t][e] += bb[t][e] + mm[t][e];  // -inf: a key past N, or a padding row
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
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
  // ldmatrix.trans row addresses: lane i gives row (key) i % 8 + 8 ((i / 8) % 2)
  // of dims 8 (i / 16) .. + 7, so r[0], r[1] are b0, b1 of a d-tile, r[2], r[3] of the next
  const int vkey = kbase + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t vrow = smem_addr(vs) + (uint32_t)((vkey * RS + 8 * (lane >> 4)) * 2);
#pragma unroll
  for (int kk = 0; kk < MAXN / 16; ++kk) {  // 16 keys per step: score tiles 2 kk, 2 kk + 1
    if (2 * kk >= nk) break;
    const uint32_t a0 = pack_bf16(sc[2 * kk][0] * sum[0], sc[2 * kk][1] * sum[0]);
    const uint32_t a1 = pack_bf16(sc[2 * kk][2] * sum[1], sc[2 * kk][3] * sum[1]);
    const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0] * sum[0], sc[2 * kk + 1][1] * sum[0]);
    const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2] * sum[1], sc[2 * kk + 1][3] * sum[1]);
#pragma unroll
    for (int tp = 0; tp < MAXD / 16; ++tp)
      if (16 * tp < DK) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + (uint32_t)((16 * kk * RS + 16 * tp) * 2));
        mma_bf16(oc[2 * tp], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(oc[2 * tp + 1], a0, a1, a2, a3, b[2], b[3]);
      }
  }
#pragma unroll
  for (int t = 0; t < MAXD / 8; ++t)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int iq = r0 - kbase + g + 8 * hh, d = 8 * t + 2 * t4;
      if (iq >= N || d >= D) continue;
      bf16* o = out + ((s * N + iq) * a.H + h) * (long long)D + d;
      if (d + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(oc[t][2 * hh], oc[t][2 * hh + 1]);
      } else {
        o[0] = __float2bfloat16(oc[t][2 * hh]);
        if (d + 1 < D) o[1] = __float2bfloat16(oc[t][2 * hh + 1]);
      }
    }
}

// ---- float32: one warp per query row of the block's G sequences.
template <typename BT>
__global__ void __launch_bounds__(NT) attn_fma_kernel(const float* __restrict__ q,
                                                     const float* __restrict__ k,
                                                     const float* __restrict__ v,
                                                     float* __restrict__ out, Args a) {
  constexpr int FS = MAXD + 1;
  __shared__ float qs[MAXN * FS], ks[MAXN * FS], vs[MAXN * FS];
  __shared__ float ps[NT / 32][MAXN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, D = a.D, h = blockIdx.y;
  const long long s0 = (long long)blockIdx.x * a.G;
  const int rows = a.G * N;
  for (int e = tid; e < rows * D; e += NT) {
    const int d = e % D, r = e / D, n = r % N;
    const long long s = s0 + r / N;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (s < a.BW) {
      qv = q[s * a.qb + h * (long long)a.qh + n * (long long)a.qn + d];
      kv = k[s * a.kb + h * (long long)a.kh + n * (long long)a.kn + d];
      vv = v[s * a.vb + h * (long long)a.vh + n * (long long)a.vn + d];
    }
    qs[r * FS + d] = qv;
    ks[r * FS + d] = kv;
    vs[r * FS + d] = vv;
  }
  __syncthreads();
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
        for (int d = 0; d < D; ++d) acc = fmaf(qs[r * FS + d], ks[(kbase + c) * FS + d], acc);
        acc += bias_at<BT>(a, h, iq, c);
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
      for (int c = 0; c < N; ++c) acc = fmaf(p[c], vs[(kbase + c) * FS + lane], acc);
      out[((s * N + iq) * a.H + h) * (long long)D + lane] = acc;
    }
    __syncwarp();
  }
}

template <typename BT>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, const Args& a,
           cudaStream_t stream) {
  const dim3 grid((a.BW + a.G - 1) / a.G, a.H);
  if (dtype == 1)
    attn_mma_kernel<BT><<<grid, NT, 0, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (bf16*)out, a);
  else if (dtype == 0)
    attn_fma_kernel<BT><<<grid, NT, 0, stream>>>((const float*)q, (const float*)k,
                                                (const float*)v, (float*)out, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch's operands come packed in one int64 array (its fields below),
// read here on the host before the launch: one argument instead of 27 keeps
// the wrapper's per-call host time down. q, k, v (BW, H, N, D) in the dtype,
// each by its (sequence, head, row) strides in elements with unit stride
// along D; vec = 1 when every row starts on a 16-byte boundary and D % 8 ==
// 0 (bf16: 16-byte copies); bias (H, N, N) by strides, float32 (bias_bf16 =
// 0) or bf16; masks (M, N, N) float32 and ids (nW) int32, or both 0; out
// (BW, N, H, D) contiguous; G sequences per block.
enum Param { Q, K, V, BIAS, MASKS, IDS, OUT, QB, QH, QN, KB, KH, KN, VB, VH, VN, VEC, BIAS_BF16,
             BH, BI, BJ, BW_, H_, N_, D_, NW, G_, NPARAMS };

extern "C" int window_attention(int dtype, const long long* params, void* stream) {
  const long long* p = params;
  const int N = (int)p[N_], D = (int)p[D_], G = (int)p[G_], BW = (int)p[BW_], H = (int)p[H_];
  const int nW = (int)p[NW], vec = (int)p[VEC], bias_bf16 = (int)p[BIAS_BF16];
  const void* bias = reinterpret_cast<const void*>(p[BIAS]);
  const float* masks = reinterpret_cast<const float*>(p[MASKS]);
  const int* ids = reinterpret_cast<const int*>(p[IDS]);
  if (N < 1 || N > MAXN || D < 1 || D > MAXD || G < 1 || G * ((N + 15) / 16 * 16) > MAXN ||
      (masks != nullptr && (ids == nullptr || nW < 1)) || (vec && D % 8))
    return (int)cudaErrorInvalidValue;
  if (BW == 0 || H == 0) return 0;
  const int bh = (int)p[BH], bi = (int)p[BI], bj = (int)p[BJ];
  const int esize = bias_bf16 ? 2 : 4;
  const int pairs = bj == 1 && bh % 2 == 0 && bi % 2 == 0 && N % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(bias) % (2 * esize) == 0;
  const Args a{bias, masks, ids, (int)p[QB], (int)p[QH], (int)p[QN], (int)p[KB], (int)p[KH],
               (int)p[KN], (int)p[VB], (int)p[VH], (int)p[VN], bh, bi, bj,
               BW, H, N, D, nW, G, vec, pairs};
  const void* q = reinterpret_cast<const void*>(p[Q]);
  const void* k = reinterpret_cast<const void*>(p[K]);
  const void* v = reinterpret_cast<const void*>(p[V]);
  void* out = reinterpret_cast<void*>(p[OUT]);
  if (bias_bf16) return launch<bf16>(dtype, q, k, v, out, a, (cudaStream_t)stream);
  return launch<float>(dtype, q, k, v, out, a, (cudaStream_t)stream);
}
