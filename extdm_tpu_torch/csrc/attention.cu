// Whole attention layers of the diffusion UNet, one thread block per
// attention window (STW) or per group of pixels' T-frame sequences
// (temporal: 64 / T sequences share a block, 2 at T = 30):
//
//   stw_layer       replaces extdm_tpu/ops/pallas_stw.py fused_stw_layer
//                   (_fused_padded -> _make_kernel): x + proj(softmax(
//                   rope(q) rope(k)^T + bias + mask) v) with qkv = ChanLN(x) Wqkv,
//                   over 3-D windows of a padded, rolled (B, T, H, W, C) tensor.
//   stw_layer_wm    replaces pallas_stw.py _fused_padded_wm (_make_kernel_wm):
//                   the same layer over pre-windowed (B, nW, N, C) tokens, with
//                   the per-window expanded shift masks (nW, N, N); the
//                   partition and its reverse are copies outside the kernel.
//   temporal_layer  replaces pallas_stw.py fused_temporal_layer
//                   (_temporal_impl -> _make_temporal_kernel): x + a + proj(
//                   attn(LN(a))) with a = ChanLN(x), attention over T per pixel.
//
// Bound on the H100: operations. Per token the q/k/v and output products
// cost 2*C*4*heads*dh flops against 2*C bytes in and out, far above the
// card's ~295 flops/byte balance point in bf16. The design keeps every
// intermediate on chip: the block loads its tokens once, normalises them in
// shared memory, and loops over heads. Per head it forms q/k/v (rows x dh
// each) against the head's slice of Wqkv, staged 32 input channels at a
// time; applies the rotary embedding; computes softmax(q k^T + bias + mask)
// v over each row's own sequence with a true per-row max; and folds the
// head's output straight into the block's output tile through its slice of
// Wproj, held in registers across heads. Only x is read and only the layer
// output is written.
//
// In bf16 every product runs on the tensor cores (mma.sync m16n8k16, float
// accumulators). q/k/v and the output fold: each warp owns 16 rows and half
// of the columns. Attention: warps 0-3 each own 16 query rows against all
// keys; the scores stay in registers, are masked to the row's sequence and
// soft-maxed across the 4 lanes that share a row, and are reused directly as
// the A operand of P V (v is staged transposed). In float32 (the tight
// reference checks) the products are FMA loops: a 4-row x 16-column thread
// grid, and one warp per query row for the attention. Weights stay in
// PyTorch's Linear layout (out, in) and are transposed while staged.
//
// The window-major layer runs the same body: only the token addresses
// differ (window w's tokens are rows w*N .. w*N+N-1, contiguous), so loads
// and stores are whole contiguous rows of the block's slab, and its mask is
// row w % nW of the expanded masks instead of a deduplicated mask by id.
//
// Limits (the wrapper checks them): rows <= 64, dh <= 32, C <= 256, and in
// bf16 C a multiple of 32.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KC = 32;   // k-chunk of the q/k/v product
constexpr int RPT = 4;   // FMA path: rows per thread (rows <= 16 * RPT)
constexpr int QPT = 6;   // FMA path: q/k/v columns per thread (3 * dh <= 16 * QPT)
constexpr int PAD = 8;   // extra bf16 per row of a tensor-core operand (spreads banks)

struct LayerArgs {
  const float* gamma;     // (C) ChanLayerNorm scale
  const float* ln_scale;  // (C) temporal LayerNorm scale (temporal only)
  const float* ln_bias;   // (C)
  const float* bproj;     // (C) or null
  const float* bias;      // (heads, L, L)
  const float* masks;     // (n_unique, L, L) or null
  const int* mask_ids;    // (n_windows) or null; window-major: null, masks are (nW, N, N)
  const float* cos_t;     // (L, rot)
  const float* sin_t;     // (L, rot)
  int D1, D2, D3;         // stw: padded T, H, W; temporal: T, H*W, 1; window-major: nW, 1, 1
  int wd, wh, ww;         // stw window; temporal: (T, 1, 1)
  int G, nseq;            // sequences per block, sequences in all (temporal; stw: 1, -)
  int C, heads, dh, rot;
  float eps;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layout of one block, in bytes; the host sizes the launch
// with the same struct.
struct Layout {
  int Npad, HS, DK, NQ;  // rows rounded to 16, row stride of hs, dh rounded to 16, n8 tiles of q/k/v
  size_t rowstat, hs, wbuf, qs, ks, vs, ps, os, qb, kb, vt, total;
  __host__ __device__ Layout(int N, int C, int dh, bool mma, int tsize) {
    Npad = (N + 15) / 16 * 16;
    HS = C + PAD;
    DK = (dh + 15) / 16 * 16;
    NQ = (3 * dh + 7) / 8;
    rowstat = 64 * sizeof(long long);  // rowoff comes first
    hs = rowstat + 2 * 64 * sizeof(float);
    wbuf = align16(hs + (size_t)Npad * HS * tsize);
    const size_t wq = mma ? (size_t)8 * NQ * (KC + PAD) * 2 : (size_t)KC * (3 * dh + 1) * 4;
    const size_t wp = mma ? (size_t)C * (DK + PAD) * 2 : (size_t)dh * (C + 1) * 4;
    qs = align16(wbuf + (wq > wp ? wq : wp));
    ks = qs + (size_t)N * (dh + 1) * 4;
    vs = ks + (size_t)N * (dh + 1) * 4;
    ps = vs + (size_t)N * (dh + 1) * 4;
    os = align16(ps + (size_t)(NT / 32) * 64 * 4);
    const size_t op = mma ? (size_t)Npad * (DK + PAD) * 2 : (size_t)N * dh * 4;
    qb = align16(os + op);  // tensor-core path: bf16 q, k [row][d] and v^T [d][row]
    kb = qb + (mma ? op : 0);
    vt = kb + (mma ? op : 0);
    total = vt + (mma ? (size_t)DK * (Npad + PAD) * 2 : 0);
  }
};

// MODE 0: shifted-window layer; MODE 1: temporal layer; MODE 2: window-major
// shifted-window layer (one block per pre-windowed window). OJ >= C / 16 sizes
// the output tile each thread keeps across heads (4 * OJ floats): the FMA
// path's columns tx + 16j, or the tensor-core path's n8 tiles of one
// column half. A narrow OJ frees registers for more resident blocks.
template <typename T, int MODE, int OJ>
__global__ void __launch_bounds__(NT, OJ <= 8 ? 3 : 2)
    attn_layer_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ wqkv,
                      const T* __restrict__ wproj, LayerArgs a) {
  constexpr bool MMA = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;            // FMA thread grid
  const int g = lane >> 2, t4 = lane & 3;            // tensor-core fragment coordinates
  const int mt = warp & 3, half = warp >> 2;         // warp's 16-row tile, column half
  const int C = a.C, dh = a.dh, hid = a.heads * a.dh, q3 = 3 * a.dh;
  const int L = a.wd * a.wh * a.ww;                  // sequence length
  const int N = a.G * L;                             // rows: G sequences of L tokens
  const Layout lay(N, C, dh, MMA, sizeof(T));
  const int HS = lay.HS, VS = dh + 1, OS = lay.DK + PAD;

  long long* rowoff = reinterpret_cast<long long*>(smem);  // token offset, -1: none
  float* rowstat = reinterpret_cast<float*>(smem + lay.rowstat);  // ChanLN mean, rstd
  T* hs = reinterpret_cast<T*>(smem + lay.hs);                    // normalised tokens
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ks = reinterpret_cast<float*>(smem + lay.ks);
  float* vs = reinterpret_cast<float*>(smem + lay.vs);
  float* prow = reinterpret_cast<float*>(smem + lay.ps) + warp * 64;  // this warp's probabilities

  // ---- token addresses
  int mask_row = -1;
  if (MODE == 0) {
    const int nWt = a.D1 / a.wd, nWh = a.D2 / a.wh, nWw = a.D3 / a.ww;
    const int nW = nWt * nWh * nWw;
    const int b = blockIdx.x / nW, wi = blockIdx.x % nW;
    const int td = wi / (nWh * nWw), th = (wi / nWw) % nWh, tw = wi % nWw;
    for (int n = tid; n < N; n += NT) {
      const int i0 = n / (a.wh * a.ww), i1 = (n / a.ww) % a.wh, i2 = n % a.ww;
      const long long t = td * a.wd + i0, h = th * a.wh + i1, w = tw * a.ww + i2;
      rowoff[n] = (((b * (long long)a.D1 + t) * a.D2 + h) * a.D3 + w) * C;
    }
    if (a.masks != nullptr) mask_row = a.mask_ids[wi];
  } else if (MODE == 2) {
    for (int n = tid; n < N; n += NT) rowoff[n] = ((long long)blockIdx.x * N + n) * C;
    if (a.masks != nullptr) mask_row = blockIdx.x % a.D1;
  } else {
    for (int n = tid; n < N; n += NT) {
      const int seq = blockIdx.x * a.G + n / L, b = seq / a.D2, m = seq % a.D2;
      rowoff[n] = seq < a.nseq ? ((b * (long long)a.D1 + n % L) * a.D2 + m) * C : -1;
    }
  }
  if (MMA) {  // padding rows and columns of the bf16 operands stay zero
    bf16* ops = reinterpret_cast<bf16*>(smem + lay.os);
    for (int e = tid; e < (int)(lay.total - lay.os) / 2; e += NT) ops[e] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // ---- load tokens (coalesced along channels); rows past N are zero
  for (int e = tid; e < lay.Npad * C; e += NT) {
    const int n = e / C, c = e % C;
    hs[n * HS + c] = (n < N && rowoff[n] >= 0) ? x[rowoff[n] + c] : from_f<T>(0.f);
  }
  __syncthreads();

  // ---- norms: one warp per token, two-pass statistics in float, stored in T
  for (int n = warp; n < N; n += NT / 32) {
    T* row = hs + n * HS;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(row[c]);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(row[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + a.eps);
    if (lane == 0) {
      rowstat[2 * n] = mean;
      rowstat[2 * n + 1] = rstd;
    }
    for (int c = lane; c < C; c += 32) row[c] = from_f<T>((to_f(row[c]) - mean) * rstd * a.gamma[c]);
    if (MODE == 1) {  // second LayerNorm (scale and bias) on the ChanLN output
      __syncwarp();
      s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(row[c]);
      const float mean2 = warp_sum(s) / C;
      v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(row[c]) - mean2;
        v += d * d;
      }
      const float rstd2 = rsqrtf(warp_sum(v) / C + a.eps);
      for (int c = lane; c < C; c += 32)
        row[c] = from_f<T>((to_f(row[c]) - mean2) * rstd2 * a.ln_scale[c] + a.ln_bias[c]);
    }
  }

  float acc_o[RPT * OJ];  // output tile, kept across heads
#pragma unroll
  for (int i = 0; i < RPT * OJ; ++i) acc_o[i] = 0.f;
  const float qscale = rsqrtf((float)dh);

  for (int hd = 0; hd < a.heads; ++hd) {
    // ---- q/k/v = hs @ Wqkv[:, head columns]
    float acc[QPT][4];
#pragma unroll
    for (int j = 0; j < QPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int NQH = (lay.NQ + 1) / 2;  // tensor-core path: n8 tiles per column half
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();
      if constexpr (MMA) {  // stage as [column][k], k contiguous
        bf16* wq = reinterpret_cast<bf16*>(smem + lay.wbuf);
        for (int e = tid; e < 8 * lay.NQ * KC; e += NT) {
          const int kk = e % KC, j = e / KC;
          const int o = (j / dh) * hid + hd * dh + (j % dh);
          wq[j * (KC + PAD) + kk] = j < q3 ? wqkv[(long long)o * C + k0 + kk] : __float2bfloat16(0.f);
        }
        __syncthreads();
        if (16 * mt < N) {
#pragma unroll
          for (int kb = 0; kb < KC; kb += 16) {
            const bf16* a_lo = hs + (16 * mt + g) * HS + k0 + kb + 2 * t4;
            const bf16* a_hi = a_lo + 8 * HS;
            const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
            for (int jj = 0; jj < QPT; ++jj) {
              const int j = half * NQH + jj;
              if (jj < NQH && j < lay.NQ) {
                const bf16* bp = wq + (8 * j + g) * (KC + PAD) + kb + 2 * t4;
                mma_bf16(acc[jj], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
              }
            }
          }
        }
      } else {  // stage as [k][column]
        float* wq = reinterpret_cast<float*>(smem + lay.wbuf);
        const int WQS = q3 + 1;
        for (int e = tid; e < KC * q3; e += NT) {
          const int j = e / KC, kk = e % KC;
          const int o = (j / dh) * hid + hd * dh + (j % dh);
          wq[kk * WQS + j] = (k0 + kk < C) ? to_f(wqkv[(long long)o * C + k0 + kk]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(KC, C - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float av[RPT], wv[QPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = ty + 16 * i;
            av[i] = r < N ? to_f(hs[r * HS + k0 + kk]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            const int col = tx + 16 * j;
            wv[j] = col < q3 ? wq[kk * WQS + col] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < QPT; ++j) acc[j][i] = fmaf(av[i], wv[j], acc[j][i]);
        }
      }
    }
    // write q (scaled), k, v: acc[j][e] is row/column (r, col) of the product
#pragma unroll
    for (int j = 0; j < QPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, col;
        if (MMA) {
          const int jt = half * NQH + j;
          r = 16 * mt + g + 8 * (e >> 1);
          col = (j < NQH && jt < lay.NQ) ? 8 * jt + 2 * t4 + (e & 1) : q3;
        } else {
          r = ty + 16 * e;
          col = tx + 16 * j;
        }
        if (r < N && col < q3) {
          const int which = col / dh, d = col % dh;
          const float v = round_to<T>(acc[j][e]);
          if (which == 0) qs[r * VS + d] = v * qscale;
          else if (which == 1) ks[r * VS + d] = v;
          else vs[r * VS + d] = v;
        }
      }
    __syncthreads();

    // ---- rotary embedding on the first `rot` dims of q and k (interleaved pairs)
    const int hrot = a.rot / 2;
    for (int e = tid; e < N * hrot; e += NT) {
      const int n = e / hrot, p = 2 * (e % hrot), pos = n % L;
      const float c0 = a.cos_t[pos * a.rot + p], s0 = a.sin_t[pos * a.rot + p];
      const float c1 = a.cos_t[pos * a.rot + p + 1], s1 = a.sin_t[pos * a.rot + p + 1];
      float* qr = qs + n * VS;
      float* kr = ks + n * VS;
      const float q0 = qr[p], q1 = qr[p + 1], k0v = kr[p], k1v = kr[p + 1];
      qr[p] = q0 * c0 - q1 * s0;
      qr[p + 1] = q1 * c1 + q0 * s1;
      kr[p] = k0v * c0 - k1v * s0;
      kr[p + 1] = k1v * c1 + k0v * s1;
    }
    __syncthreads();

    const float* bias_h = a.bias + (long long)hd * L * L;
    const float* mask_w = mask_row >= 0 ? a.masks + (long long)mask_row * L * L : nullptr;
    if constexpr (MMA) {
      // ---- tensor cores: warps 0-3 each take 16 query rows against all
      // keys; S stays in registers, is masked to the row's own sequence,
      // soft-maxed there and reused as the A operand of P V.
      bf16* qb = reinterpret_cast<bf16*>(smem + lay.qb);
      bf16* kb = reinterpret_cast<bf16*>(smem + lay.kb);
      bf16* vt = reinterpret_cast<bf16*>(smem + lay.vt);
      const int VTS = lay.Npad + PAD, NS = lay.Npad / 8;  // v^T row stride, key n8 tiles
      for (int e = tid; e < N * dh; e += NT) {
        const int n = e / dh, d = e % dh;
        qb[n * OS + d] = __float2bfloat16(qs[n * VS + d]);
        kb[n * OS + d] = __float2bfloat16(ks[n * VS + d]);
        vt[d * VTS + n] = __float2bfloat16(vs[n * VS + d]);
      }
      __syncthreads();
      if (warp < 4 && 16 * warp < N) {
        const int r0 = 16 * warp + g;  // fragment rows r0 and r0 + 8
        float sc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        for (int kk = 0; kk < lay.DK; kk += 16) {
          const bf16* a_lo = qb + r0 * OS + kk + 2 * t4;
          const bf16* a_hi = a_lo + 8 * OS;
          const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < NS) {
              const bf16* bp = kb + (8 * j + g) * OS + kk + 2 * t4;
              mma_bf16(sc[j], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
            }
        }
        float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), c = 8 * j + 2 * t4 + (e & 1);
            const int iq = r % L, kbase = r - iq;
            float v = __int_as_float(0xff800000);  // -inf: another sequence, or padding
            if (j < NS && r < N && c >= kbase && c < kbase + L) {
              v = sc[j][e] + bias_h[iq * L + c - kbase];
              if (mask_w != nullptr) v += mask_w[iq * L + c - kbase];
            }
            sc[j][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // a row lives in the 4 lanes sharing g
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          if (mx[h] == __int_as_float(0xff800000)) mx[h] = 0.f;  // padding row
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][e] = expf(sc[j][e] - mx[e >> 1]);
            sum[e >> 1] += sc[j][e];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          sum[h] = sum[h] > 0.f ? 1.f / sum[h] : 0.f;
        }
        float oc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) oc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step: S tiles 2kk, 2kk+1
          if (2 * kk >= NS) break;
          const uint32_t a0 = pack_bf16(sc[2 * kk][0] * sum[0], sc[2 * kk][1] * sum[0]);
          const uint32_t a1 = pack_bf16(sc[2 * kk][2] * sum[1], sc[2 * kk][3] * sum[1]);
          const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0] * sum[0], sc[2 * kk + 1][1] * sum[0]);
          const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2] * sum[1], sc[2 * kk + 1][3] * sum[1]);
#pragma unroll
          for (int jd = 0; jd < 4; ++jd)
            if (8 * jd < lay.DK) {
              const bf16* bp = vt + (8 * jd + g) * VTS + 16 * kk + 2 * t4;
              mma_bf16(oc[jd], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
            }
        }
        bf16* os = reinterpret_cast<bf16*>(smem + lay.os);
#pragma unroll
        for (int jd = 0; jd < 4; ++jd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1), d = 8 * jd + 2 * t4 + (e & 1);
            if (r < N && d < dh) os[r * OS + d] = __float2bfloat16(oc[jd][e]);
          }
      }
    } else {
      // ---- one warp per query row: scores over its own sequence, softmax,
      // AV. Four partial sums per dot product keep the FMA pipes busy; the
      // probabilities go through shared memory to the AV product.
      float* os = reinterpret_cast<float*>(smem + lay.os);
      for (int i = warp; i < N; i += NT / 32) {
        const int iq = i % L, kbase = i - iq;  // query position, first key row
        const float* qr = qs + i * VS;
        float s[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j < L) {
            const float* kr = ks + (kbase + j) * VS;
            float d4[4] = {0.f, 0.f, 0.f, 0.f};
            int d = 0;
            for (; d + 4 <= dh; d += 4)
#pragma unroll
              for (int q = 0; q < 4; ++q) d4[q] = fmaf(qr[d + q], kr[d + q], d4[q]);
            for (; d < dh; ++d) d4[0] = fmaf(qr[d], kr[d], d4[0]);
            float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]) + bias_h[iq * L + j];
            if (mask_w != nullptr) dot += mask_w[iq * L + j];
            s[u] = dot;
          } else {
            s[u] = __int_as_float(0xff800000);  // -inf
          }
        }
        const float m = warp_max(fmaxf(s[0], s[1]));
        const float e0 = lane < L ? expf(s[0] - m) : 0.f;
        const float e1 = lane + 32 < L ? expf(s[1] - m) : 0.f;
        const float inv = 1.f / warp_sum(e0 + e1);
        prow[lane] = round_to<T>(e0 * inv);
        prow[lane + 32] = round_to<T>(e1 * inv);
        __syncwarp();
        float o4[4] = {0.f, 0.f, 0.f, 0.f};
        if (lane < dh) {
          const float* vcol = vs + kbase * VS + lane;
          int j = 0;
          for (; j + 4 <= L; j += 4)
#pragma unroll
            for (int q = 0; q < 4; ++q) o4[q] = fmaf(prow[j + q], vcol[(j + q) * VS], o4[q]);
          for (; j < L; ++j) o4[0] = fmaf(prow[j], vcol[j * VS], o4[0]);
        }
        __syncwarp();  // prow is rewritten by the warp's next row
        if (lane < dh) os[i * dh + lane] = round_to<T>((o4[0] + o4[1]) + (o4[2] + o4[3]));
      }
    }
    __syncthreads();

    // ---- fold the head's output through Wproj[:, head slice] into the tile
    if constexpr (MMA) {  // stage as [output channel][d], d contiguous
      bf16* wp = reinterpret_cast<bf16*>(smem + lay.wbuf);
      const bf16* os = reinterpret_cast<const bf16*>(smem + lay.os);
      for (int e = tid; e < C * lay.DK; e += NT) {
        const int d = e % lay.DK, c = e / lay.DK;
        wp[c * OS + d] = d < dh ? wproj[(long long)c * hid + hd * dh + d] : __float2bfloat16(0.f);
      }
      __syncthreads();
      if (16 * mt < N) {
        for (int kb = 0; kb < lay.DK; kb += 16) {
          const bf16* a_lo = os + (16 * mt + g) * OS + kb + 2 * t4;
          const bf16* a_hi = a_lo + 8 * OS;
          const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
          for (int j = 0; j < OJ; ++j) {
            if (j < C / 16) {
              const bf16* bp = wp + (half * (C / 2) + 8 * j + g) * OS + kb + 2 * t4;
              float* c4 = acc_o + 4 * j;
              float frag[4] = {c4[0], c4[1], c4[2], c4[3]};
              mma_bf16(frag, a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
              c4[0] = frag[0], c4[1] = frag[1], c4[2] = frag[2], c4[3] = frag[3];
            }
          }
        }
      }
    } else {  // stage as [d][output channel]
      float* wp = reinterpret_cast<float*>(smem + lay.wbuf);
      const float* os = reinterpret_cast<const float*>(smem + lay.os);
      const int WPS = C + 1;
      for (int e = tid; e < dh * C; e += NT) {
        const int d = e % dh, c = e / dh;
        wp[d * WPS + c] = to_f(wproj[(long long)c * hid + hd * dh + d]);
      }
      __syncthreads();
      for (int d = 0; d < dh; ++d) {
        float ov[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + 16 * i;
          ov[i] = r < N ? os[r * dh + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < OJ; ++j) {
          const int c = tx + 16 * j;
          const float w = c < C ? wp[d * WPS + c] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc_o[i * OJ + j] = fmaf(ov[i], w, acc_o[i * OJ + j]);
        }
      }
    }
  }

  // ---- epilogue: residual(s), write once
#pragma unroll
  for (int idx = 0; idx < RPT * OJ; ++idx) {
    int r, c;
    if (MMA) {
      const int j = idx >> 2, e = idx & 3;
      r = 16 * mt + g + 8 * (e >> 1);
      c = j < C / 16 ? half * (C / 2) + 8 * j + 2 * t4 + (e & 1) : C;
    } else {
      r = ty + 16 * (idx / OJ);
      c = tx + 16 * (idx % OJ);
    }
    if (r >= N || c >= C || rowoff[r] < 0) continue;
    const float xv = to_f(x[rowoff[r] + c]);
    float res;
    if (MODE != 1) {
      res = xv + round_to<T>(acc_o[idx] + a.bproj[c]);
    } else {
      const float av = round_to<T>((xv - rowstat[2 * r]) * rowstat[2 * r + 1] * a.gamma[c]);
      res = xv + (av + round_to<T>(acc_o[idx]));
    }
    out[rowoff[r] + c] = from_f<T>(res);
  }
}

template <typename T, int MODE, int OJ>
int launch_oj(const void* x, void* out, const void* wqkv, const void* wproj, const LayerArgs& a,
              int blocks, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_layer_kernel<T, MODE, OJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  attn_layer_kernel<T, MODE, OJ><<<blocks, NT, bytes, stream>>>(
      (const T*)x, (T*)out, (const T*)wqkv, (const T*)wproj, a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch(const void* x, void* out, const void* wqkv, const void* wproj, const LayerArgs& a,
           int blocks, cudaStream_t stream) {
  constexpr bool MMA = std::is_same<T, bf16>::value;
  const int N = a.G * a.wd * a.wh * a.ww;
  if (N > 64 || a.dh > 32 || a.C > 256 || a.rot % 2 || (MMA && a.C % KC))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = Layout(N, a.C, a.dh, MMA, sizeof(T)).total;
  if (a.C <= 64) return launch_oj<T, MODE, 4>(x, out, wqkv, wproj, a, blocks, bytes, stream);
  if (a.C <= 128) return launch_oj<T, MODE, 8>(x, out, wqkv, wproj, a, blocks, bytes, stream);
  return launch_oj<T, MODE, 16>(x, out, wqkv, wproj, a, blocks, bytes, stream);
}

}  // namespace

extern "C" int stw_layer(int dtype, const void* x, void* out, const float* gamma, const void* wqkv,
                         const void* wproj, const float* bproj, const float* bias,
                         const float* masks, const int* mask_ids, const float* cos_t,
                         const float* sin_t, int B, int Tp, int Hp, int Wp, int C, int wd, int wh,
                         int ww, int heads, int dh, int rot, float eps, void* stream) {
  LayerArgs a{gamma, nullptr, nullptr, bproj, bias, masks, mask_ids, cos_t, sin_t,
              Tp, Hp, Wp, wd, wh, ww, 1, 0, C, heads, dh, rot, eps};
  const int blocks = B * (Tp / wd) * (Hp / wh) * (Wp / ww);
  if (blocks == 0) return 0;
  DISPATCH_DTYPE(dtype, return launch<T, 0>(x, out, wqkv, wproj, a, blocks, (cudaStream_t)stream));
  return 0;
}

extern "C" int stw_layer_wm(int dtype, const void* xw, void* out, const float* gamma,
                            const void* wqkv, const void* wproj, const float* bproj,
                            const float* bias, const float* masks, const float* cos_t,
                            const float* sin_t, int B, int nW, int N, int C, int heads, int dh,
                            int rot, float eps, void* stream) {
  LayerArgs a{gamma, nullptr, nullptr, bproj, bias, masks, nullptr, cos_t, sin_t,
              nW, 1, 1, N, 1, 1, 1, 0, C, heads, dh, rot, eps};
  const int blocks = B * nW;
  if (blocks == 0) return 0;
  DISPATCH_DTYPE(dtype, return launch<T, 2>(xw, out, wqkv, wproj, a, blocks, (cudaStream_t)stream));
  return 0;
}

extern "C" int temporal_layer(int dtype, const void* x, void* out, const float* gamma,
                              const float* ln_scale, const float* ln_bias, const void* wqkv,
                              const void* wproj, const float* bias, const float* cos_t,
                              const float* sin_t, int B, int T, int HW, int C, int heads, int dh,
                              int rot, float eps, void* stream) {
  LayerArgs a{gamma, ln_scale, ln_bias, nullptr, bias, nullptr, nullptr, cos_t, sin_t,
              T, HW, 1, T, 1, 1, 0, B * HW, C, heads, dh, rot, eps};
  a.G = T <= 64 ? 64 / T : 1;  // pack short sequences into one block
  const int blocks = (B * HW + a.G - 1) / a.G;
  if (blocks == 0) return 0;
  DISPATCH_DTYPE(dtype, return launch<T, 1>(x, out, wqkv, wproj, a, blocks, (cudaStream_t)stream));
  return 0;
}
