// Whole time-conditioned ResnetBlock3d of the diffusion UNet:
//
//   h   = SiLU(GN1(conv3x3(x) + b1) * (scale + 1) + shift)
//   out = SiLU(GN2(conv3x3(h) + b2)) + (x or x Wres + bres)
//
// Replaces extdm_tpu/ops/pallas_resnet.py fused_resnet_block (_kernel_impl
// -> _make_kernel), which holds a whole sample in TPU VMEM so GroupNorm's
// statistics (over all T*H*W*C/G values of a group) need no cross-program
// reduction. A Hopper SM holds 227 KB, far less than a sample, so the block
// is a short sequence of launches on the caller's stream.
//
// Bound on the H100: operations for the 3x3 convs (2*9*Cin*Cout flops per
// pixel against a few bytes), bytes for the elementwise passes.
//
// bf16 (kernel 3 on the main path, resnet_block_wgmma): the convs run on
// conv_ring.cuh's wgmma implicit GEMM, the engine of kernel 10: rows M =
// the pixels of every frame flattened, so a 128-row tile of small frames
// wastes nothing; the tap-shifted rows arrive by cp.async with per-row edge
// masks, the tap-major weights (9, Cin, Cout) by TMA, through a ring of
// stages. The launches:
//   1. conv_gn_kernel: conv1 + b1 -> y1 (float32), each tile's per-(sample,
//      group) sum and sum of squares added into a float64 (B, G, 2) buffer;
//      with a residual projection the same launch runs x Wres + bres -> r
//      (float32) on the same tile with one tap (extra blocks).
//   2. gn_coef_kernel + gn_act_kernel: a1 = bf16(SiLU(GN1(y1) (scale + 1) +
//      shift)), one bytes-bound pass, a1 written once. Applying it to the
//      conv's stages instead would have to keep their zero-filled halo zero
//      (SiLU(GN(0)) != 0).
//   3. conv_gn_kernel: conv2 + b2 -> y2 (float32), GN2 statistics likewise.
//   4. gn_coef_kernel + gn_silu_add_kernel: out = SiLU(GN2(y2)) + (x or r).
// Rounding: where JAX rounds (pallas_resnet.py _make_kernel): the conv
// outputs, the GroupNorm chain and the residual stay float32; a1 (conv2's
// input) and the output are rounded to bf16, once each. Channel counts are
// multiples of 8 (the wrapper zero-pads; statistics and the output count
// only the real channels).
//
// float32 (the tight reference checks; resnet_block): a block computes an
// 8x8 pixel tile of one frame for 64 output channels, staging a 10x10 input
// halo and the 3x3 weights for 16 input channels at a time in shared
// memory, each thread accumulating 4 pixels x 4 channels with FMAs:
//   1. conv_kernel<3, no transform>: conv1 + b1 -> y1, GN1 sums as above.
//   2. conv_kernel<3, transform>: GN1 + FiLM + SiLU applied to y1 while it
//      is staged (zero padding stays zero), conv2 + b2 -> y2, GN2 sums.
//   3. conv_kernel<1> (only with a residual projection): x Wres + bres -> r.
//   4. gn_silu_add_kernel: out = SiLU(GN2(y2)) + (x or r).
// Statistics are summed in float within a block and in float64 across
// blocks, so E[y^2] - E[y]^2 loses nothing that matters at a group size of
// ~10^6. The float32 path and kernel 7 take weights in PyTorch's Conv layout
// (Cout, Cin, kh, kw); kernel 7's bf16 convs keep the mma.sync conv_kernel_mma.
#include <type_traits>

#include "conv_ring.cuh"

namespace {

constexpr int NT = 256;
constexpr int PXT = 8;   // output tile is PXT x PXT pixels
constexpr int CO_T = 64;  // output channels per block
constexpr int CI_T = 16;  // input channels staged per step
constexpr int MAXG = 32;  // most GroupNorm groups

struct GNIn {            // GroupNorm + FiLM + SiLU applied to the conv input
  const double* stats;   // (B, G, 2) sums over the input
  const float* scale;    // (Cin)
  const float* bias;     // (Cin)
  const float* film;     // (B, 2 * Cin) or null
  int groups;
  float eps;
};

__device__ __forceinline__ void group_moments(const double* stats, int b, int g, int groups,
                                              double n, float eps, float* mean, float* rstd) {
  const double s = stats[(b * groups + g) * 2], ss = stats[(b * groups + g) * 2 + 1];
  const double m = s / n;
  const double var = fmax(ss / n - m * m, 0.0);
  *mean = (float)m;
  *rstd = rsqrtf((float)var + eps);
}

template <typename T, int K, bool XFORM, bool STATS>
__global__ void __launch_bounds__(NT) conv_kernel(const T* __restrict__ in, const T* __restrict__ w,
                                                 const float* __restrict__ bias, T* __restrict__ out,
                                                 GNIn gn, double* __restrict__ out_stats,
                                                 int out_groups, int F, int H, int W, int Cin,
                                                 int Cout) {
  constexpr int P = PXT + K - 1;  // staged halo width
  __shared__ float patch[P * P * CI_T];
  __shared__ float wbuf[K * K * CI_T * CO_T];
  __shared__ float g_mean[MAXG], g_rstd[MAXG];
  __shared__ float s_sum[MAXG], s_sq[MAXG];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tiles_w = (W + PXT - 1) / PXT;
  const int y0 = (blockIdx.x / tiles_w) * PXT, x0 = (blockIdx.x % tiles_w) * PXT;
  const int co0 = blockIdx.y * CO_T;
  const int frame = blockIdx.z, b = frame / F;
  const T* in_f = in + (long long)frame * H * W * Cin;

  if (XFORM && tid < gn.groups) {
    const double n = (double)F * H * W * (Cin / gn.groups);
    group_moments(gn.stats, b, tid, gn.groups, n, gn.eps, &g_mean[tid], &g_rstd[tid]);
  }
  if (STATS && tid < MAXG) {
    s_sum[tid] = 0.f;
    s_sq[tid] = 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CI_T) {
    __syncthreads();
    for (int e = tid; e < P * P * CI_T; e += NT) {
      const int cl = e % CI_T, pix = e / CI_T;
      const int gy = y0 + pix / P - K / 2, gx = x0 + pix % P - K / 2, ci = c0 + cl;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) {
        v = to_f(in_f[((long long)gy * W + gx) * Cin + ci]);
        if (XFORM) {
          const int g = ci / (Cin / gn.groups);
          v = (v - g_mean[g]) * g_rstd[g] * gn.scale[ci] + gn.bias[ci];
          if (gn.film != nullptr) {
            const float* f = gn.film + (long long)b * 2 * Cin;
            v = v * (f[ci] + 1.f) + f[Cin + ci];
          }
          v = round_to<T>(silu(v));
        }
      }
      patch[e] = v;
    }
    for (int e = tid; e < K * K * CI_T * CO_T; e += NT) {
      const int col = e % CO_T, rest = e / CO_T;  // rest = tap * CI_T + cl
      const int cl = rest % CI_T, tap = rest / CI_T;
      const int co = co0 + col, ci = c0 + cl;
      wbuf[e] = (co < Cout && ci < Cin) ? to_f(w[((long long)co * Cin + ci) * K * K + tap]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      for (int cl = 0; cl < CI_T; ++cl) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = ty + 16 * i, py = p / PXT, px = p % PXT;
          av[i] = patch[((py + dy) * P + px + dx) * CI_T + cl];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wbuf[(tap * CI_T + cl) * CO_T + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
  }

  const int cg = STATS ? Cout / out_groups : 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tx + 16 * j;
    if (co >= Cout) continue;
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i, gy = y0 + p / PXT, gx = x0 + p % PXT;
      if (gy >= H || gx >= W) continue;
      const float v = round_to<T>(acc[i][j] + (bias != nullptr ? bias[co] : 0.f));
      out[(((long long)frame * H + gy) * W + gx) * Cout + co] = from_f<T>(v);
      s += v;
      sq += v * v;
    }
    if (STATS) {
      atomicAdd(&s_sum[co / cg], s);
      atomicAdd(&s_sq[co / cg], sq);
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < out_groups) {
      atomicAdd(&out_stats[(b * out_groups + tid) * 2], (double)s_sum[tid]);
      atomicAdd(&out_stats[(b * out_groups + tid) * 2 + 1], (double)s_sq[tid]);
    }
  }
}

// ---- bf16 tensor-core variant
constexpr int PS = 24;  // bf16 stride of a staged pixel / weight row: 16 used, 24 spreads banks

template <int K, bool XFORM, bool STATS>
__global__ void __launch_bounds__(NT) conv_kernel_mma(const bf16* __restrict__ in,
                                                     const bf16* __restrict__ w,
                                                     const float* __restrict__ bias,
                                                     bf16* __restrict__ out, GNIn gn,
                                                     double* __restrict__ out_stats,
                                                     int out_groups, int F, int H, int W, int Cin,
                                                     int Cout) {
  constexpr int P = PXT + K - 1;
  __shared__ __align__(16) bf16 patch[P * P * PS];       // [pixel][input channel]
  __shared__ __align__(16) bf16 wbuf[K * K * CO_T * PS];  // [tap][output channel][input channel]
  __shared__ float g_mean[MAXG], g_rstd[MAXG];
  __shared__ float s_sum[MAXG], s_sq[MAXG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, ng = warp >> 2;  // 16-pixel row block, 32-channel half
  const int tiles_w = (W + PXT - 1) / PXT;
  const int y0 = (blockIdx.x / tiles_w) * PXT, x0 = (blockIdx.x % tiles_w) * PXT;
  const int co0 = blockIdx.y * CO_T;
  const int frame = blockIdx.z, b = frame / F;
  const bf16* in_f = in + (long long)frame * H * W * Cin;

  if (XFORM && tid < gn.groups) {
    const double n = (double)F * H * W * (Cin / gn.groups);
    group_moments(gn.stats, b, tid, gn.groups, n, gn.eps, &g_mean[tid], &g_rstd[tid]);
  }
  if (STATS && tid < MAXG) {
    s_sum[tid] = 0.f;
    s_sq[tid] = 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int p0 = 16 * mt + g, p1 = p0 + 8;  // this thread's fragment rows (pixels)

  for (int c0 = 0; c0 < Cin; c0 += CI_T) {
    __syncthreads();
    for (int e = tid; e < P * P * CI_T; e += NT) {
      const int cl = e % CI_T, pix = e / CI_T;
      const int gy = y0 + pix / P - K / 2, gx = x0 + pix % P - K / 2, ci = c0 + cl;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) {
        v = to_f(in_f[((long long)gy * W + gx) * Cin + ci]);
        if (XFORM) {
          const int gi = ci / (Cin / gn.groups);
          v = (v - g_mean[gi]) * g_rstd[gi] * gn.scale[ci] + gn.bias[ci];
          if (gn.film != nullptr) {
            const float* f = gn.film + (long long)b * 2 * Cin;
            v = v * (f[ci] + 1.f) + f[Cin + ci];
          }
          v = silu(v);
        }
      }
      patch[pix * PS + cl] = __float2bfloat16(v);
    }
    for (int e = tid; e < K * K * CO_T * CI_T; e += NT) {
      const int cl = e % CI_T, rest = e / CI_T;  // rest = tap * CO_T + col
      const int col = rest % CO_T, tap = rest / CO_T;
      const int co = co0 + col, ci = c0 + cl;
      wbuf[rest * PS + cl] = (co < Cout && ci < Cin) ? w[((long long)co * Cin + ci) * K * K + tap]
                                                     : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      const bf16* a_lo = patch + ((p0 / PXT + dy) * P + p0 % PXT + dx) * PS + 2 * t4;
      const bf16* a_hi = patch + ((p1 / PXT + dy) * P + p1 % PXT + dx) * PS + 2 * t4;
      const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* bp = wbuf + (tap * CO_T + 32 * ng + 8 * j + g) * PS + 2 * t4;
        mma_bf16(acc[j], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
      }
    }
  }

  const int cg = STATS ? Cout / out_groups : 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 32 * ng + 8 * j + 2 * t4 + e;
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = h ? p1 : p0, gy = y0 + p / PXT, gx = x0 + p % PXT;
        if (gy < H && gx < W && co < Cout) {
          const float v = round_to<bf16>(acc[j][2 * h + e] + (bias != nullptr ? bias[co] : 0.f));
          out[(((long long)frame * H + gy) * W + gx) * Cout + co] = __float2bfloat16(v);
          s += v;
          sq += v * v;
        }
      }
      if (STATS) {  // sum over the 8 lanes that share this channel, then one atomic
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          sq += __shfl_xor_sync(0xffffffffu, sq, o);
        }
        if (g == 0 && co < Cout) {
          atomicAdd(&s_sum[co / cg], s);
          atomicAdd(&s_sq[co / cg], sq);
        }
      }
    }
  }
  if (STATS) {
    __syncthreads();
    if (tid < out_groups) {
      atomicAdd(&out_stats[(b * out_groups + tid) * 2], (double)s_sum[tid]);
      atomicAdd(&out_stats[(b * out_groups + tid) * 2 + 1], (double)s_sq[tid]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) gn_silu_add_kernel(const T* __restrict__ y,
                                                        const double* __restrict__ stats,
                                                        const float* __restrict__ scale,
                                                        const float* __restrict__ bias,
                                                        const T* __restrict__ res, T* __restrict__ out,
                                                        long long S, int C, int groups, float eps,
                                                        long long total) {
  const double n = (double)S * (C / groups);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const int b = (int)(i / (S * C));
    float mean, rstd;
    group_moments(stats, b, c / (C / groups), groups, n, eps, &mean, &rstd);
    const float h = round_to<T>(silu((to_f(y[i]) - mean) * rstd * scale[c] + bias[c]));
    out[i] = from_f<T>(h + to_f(res[i]));
  }
}

template <typename T, int K, bool XFORM, bool STATS>
cudaError_t conv(const T* in, const T* w, const float* bias, T* out, GNIn gn, double* out_stats,
                 int groups, int B, int F, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const dim3 grid(((H + PXT - 1) / PXT) * ((W + PXT - 1) / PXT), (Cout + CO_T - 1) / CO_T, B * F);
  if constexpr (std::is_same<T, bf16>::value) {
    conv_kernel_mma<K, XFORM, STATS><<<grid, NT, 0, stream>>>(in, w, bias, out, gn, out_stats,
                                                              groups, F, H, W, Cin, Cout);
  } else {
    conv_kernel<T, K, XFORM, STATS><<<grid, NT, 0, stream>>>(in, w, bias, out, gn, out_stats,
                                                            groups, F, H, W, Cin, Cout);
  }
  return cudaGetLastError();
}

template <typename T>
int block(const T* x, const T* w1, const float* b1, const float* g1s, const float* g1b,
          const float* film, const T* w2, const float* b2, const float* g2s, const float* g2b,
          const T* wres, const float* bres, T* y1, T* y2, T* r, double* stats, T* out, int B,
          int F, int H, int W, int Cin, int Cout, int groups, float eps, cudaStream_t stream) {
  if (groups > MAXG || Cout % groups) return (int)cudaErrorInvalidValue;
  double* stats1 = stats;
  double* stats2 = stats + 2 * B * groups;
  const GNIn none{nullptr, nullptr, nullptr, nullptr, 1, eps};
  cudaError_t err;
  err = conv<T, 3, false, true>(x, w1, b1, y1, none, stats1, groups, B, F, H, W, Cin, Cout, stream);
  if (err != cudaSuccess) return (int)err;
  const GNIn gn1{stats1, g1s, g1b, film, groups, eps};
  err = conv<T, 3, true, true>(y1, w2, b2, y2, gn1, stats2, groups, B, F, H, W, Cout, Cout, stream);
  if (err != cudaSuccess) return (int)err;
  const T* res = x;
  if (wres != nullptr) {
    err = conv<T, 1, false, false>(x, wres, bres, r, none, nullptr, groups, B, F, H, W, Cin, Cout,
                                   stream);
    if (err != cudaSuccess) return (int)err;
    res = r;
  }
  const long long S = (long long)F * H * W, total = S * B * Cout;
  const long long want = (total + NT - 1) / NT;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  gn_silu_add_kernel<T><<<blocks, NT, 0, stream>>>(y2, stats2, g2s, g2b, res, out, S, Cout, groups,
                                                   eps, total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 on wgmma
constexpr int SLOTS = 8;  // samples a tile's statistics collect in shared memory

// One conv of the block on the wgmma engine. Blocks (x, y < cols): out =
// conv(in, w) + bias, float32 (P, N), and the per-(sample, group) sum and
// sum of squares of the real channels (< C, groups of C / groups) added into
// stats (B, groups, 2). Blocks y >= cols (with a residual projection):
// rout = in Wres + rbias on the same tile with one tap, no statistics.
// S: pixels a sample. Grid: (ceil(P / GM), cols (+ cols)) of tiles BN
// columns wide. RS ring stages, MINB blocks an SM (fused_resnet.resnet_plan).
template <int RS, int MINB, int BN>
__global__ void __launch_bounds__(GT, MINB)
    conv_gn_kernel(__grid_constant__ const CUtensorMap wmap,
                   __grid_constant__ const CUtensorMap rmap,
                   const bf16* __restrict__ in, const float* __restrict__ bias,
                   float* __restrict__ out, const float* __restrict__ rbias,
                   float* __restrict__ rout, double* __restrict__ stats, int P, int H, int W, int K,
                   int N, int C, int groups, int S, int cols) {
  extern __shared__ uint8_t smem[];
  __shared__ float s_stat[2 * SLOTS * MAXG];
  const Ring<RS, BN> ring(smem);
  const int p0 = blockIdx.x * GM, tid = threadIdx.x;
  if ((int)blockIdx.y >= cols) {
    conv_tile<false, 1, RS, BN>(ring, &rmap, in, rbias, rout, P, H, W, K, N, p0,
                                ((int)blockIdx.y - cols) * BN);
    return;
  }
  const int n0 = blockIdx.y * BN;
  for (int i = tid; i < 2 * SLOTS * MAXG; i += GT) s_stat[i] = 0.f;  // before the ring's barrier
  float acc[BN / 2];
  conv_product<false, 9, RS, BN>(ring, &wmap, in, acc, P, H, W, K, p0, n0);

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = p0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3);  // the warp's first row
  const int b0 = p0 / S, cg = C / groups;
  const int r_last = min(rw + 15, P - 1);
  // the warp's rows all in one sample with a shared-memory slot: shuffles
  const bool uniform = rw < P && rw / S == r_last / S && rw / S - b0 < SLOTS;
  const int slot = uniform ? rw / S - b0 : 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nb = n0 + 8 * j + 2 * t;
    const bool n_ok = nb < N;  // N a multiple of 8: a pair is in or out together
    const float bv0 = n_ok ? bias[nb] : 0.f, bv1 = n_ok ? bias[nb + 1] : 0.f;
    float v[2][2];  // [row half][column]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + g + 8 * h;
      v[h][0] = acc[4 * j + 2 * h] + bv0;
      v[h][1] = acc[4 * j + 2 * h + 1] + bv1;
      if (n_ok && r < P)
        *reinterpret_cast<float2*>(out + (long long)r * N + nb) = make_float2(v[h][0], v[h][1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nb + e;
      if (uniform) {
        float s = 0.f, sq = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rw + g + 8 * h < P) {
            s += v[h][e];
            sq += v[h][e] * v[h][e];
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over the 8 row groups g
          s += __shfl_xor_sync(0xffffffffu, s, o);
          sq += __shfl_xor_sync(0xffffffffu, sq, o);
        }
        if (g == 0 && n < C) {
          atomicAdd(&s_stat[(slot * MAXG + n / cg) * 2], s);
          atomicAdd(&s_stat[(slot * MAXG + n / cg) * 2 + 1], sq);
        }
      } else if (n < C) {  // a warp across samples (or past the slots): straight to float64
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + g + 8 * h;
          if (r < P) {
            double* st = stats + ((long long)(r / S) * groups + n / cg) * 2;
            atomicAdd(st, (double)v[h][e]);
            atomicAdd(st + 1, (double)v[h][e] * v[h][e]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < SLOTS * groups; i += GT) {
    const int sl = i / groups, gi = i % groups;
    if ((long long)(b0 + sl) * S < P && (s_stat[(sl * MAXG + gi) * 2] != 0.f ||
                                         s_stat[(sl * MAXG + gi) * 2 + 1] != 0.f)) {
      double* st = stats + ((long long)(b0 + sl) * groups + gi) * 2;
      atomicAdd(st, (double)s_stat[(sl * MAXG + gi) * 2]);
      atomicAdd(st + 1, (double)s_stat[(sl * MAXG + gi) * 2 + 1]);
    }
  }
}

// coef[b][c] = (a, d) such that GroupNorm (+ FiLM) of y is y a + d: a = rstd
// scale (k), d = (bias - mean rstd scale) (k) (+ shift), k = FiLM scale + 1;
// (0, 0) for the pad channels c >= C of a row of ld.
__global__ void __launch_bounds__(NT) gn_coef_kernel(GNIn gn, float2* __restrict__ coef, int B,
                                                    int C, int ld, long long S) {
  const double n = (double)S * (C / gn.groups);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B * ld; i += gridDim.x * blockDim.x) {
    const int b = i / ld, c = i % ld;
    float2 v = make_float2(0.f, 0.f);
    if (c < C) {
      float mean, rstd;
      group_moments(gn.stats, b, c / (C / gn.groups), gn.groups, n, gn.eps, &mean, &rstd);
      v.x = rstd * gn.scale[c];
      v.y = gn.bias[c] - mean * v.x;
      if (gn.film != nullptr) {
        const float* f = gn.film + (long long)b * 2 * C;
        const float k = f[c] + 1.f;
        v.x *= k;
        v.y = v.y * k + f[C + c];
      }
    }
    coef[i] = v;
  }
}

// a1 = bf16(SiLU(y a + d)), four channels a thread: y (B S, ld) float32,
// ld a multiple of 8; pad channels give SiLU(0) = 0.
__global__ void __launch_bounds__(NT) gn_act_kernel(const float4* __restrict__ y,
                                                   const float2* __restrict__ coef,
                                                   uint2* __restrict__ out, int ld, long long S,
                                                   long long total4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int c = (int)(e % ld), b = (int)(e / (S * ld));
    const float4 v = y[i];
    const float2* cf = coef + (long long)b * ld + c;
    const float2 c0 = cf[0], c1 = cf[1], c2 = cf[2], c3 = cf[3];
    out[i] = make_uint2(pack_bf16(silu(v.x * c0.x + c0.y), silu(v.y * c1.x + c1.y)),
                        pack_bf16(silu(v.z * c2.x + c2.y), silu(v.w * c3.x + c3.y)));
  }
}

// out (B S, C) bf16 = bf16(SiLU(y2 a + d) + res), res = x (bf16) or r
// (float32), all three of row stride ld; one rounding, as JAX's.
__global__ void __launch_bounds__(NT) gn_silu_res_kernel(const float* __restrict__ y,
                                                        const float2* __restrict__ coef,
                                                        const bf16* __restrict__ x,
                                                        const float* __restrict__ r,
                                                        bf16* __restrict__ out, int C, int ld,
                                                        long long S, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / C;
    const int c = (int)(i - p * C), b = (int)(p / S);
    const long long at = p * ld + c;
    const float2 cf = coef[(long long)b * ld + c];
    const float res = r != nullptr ? r[at] : __bfloat162float(x[at]);
    out[i] = __float2bfloat16(silu(y[at] * cf.x + cf.y) + res);
  }
}

// w (Cout, Cin, taps) in T, PyTorch's Conv layout with (kh, kw) flattened ->
// out (taps, Kin, N) bf16, zero past Cin and Cout: the tap-major weights TMA
// reads, in the one copy that converts them to bf16. A 32 x 32 tile
// transpose of the (Cout) x (Cin taps) matrix through shared memory, so that
// both the reads and the writes are coalesced. Grid: (ceil(Kin taps / 32),
// ceil(N / 32)) of 32 x 8 threads.
template <typename T>
__global__ void __launch_bounds__(NT) tap_major_kernel(const T* __restrict__ w,
                                                      bf16* __restrict__ out, int Cout, int Cin,
                                                      int taps, int Kin, int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {  // rows n of w, k = ci taps + tap along them
    const int n = n0 + i, k = k0 + tx;
    tile[i][tx] = n < Cout && k < Cin * taps ? to_f(w[(long long)n * Cin * taps + k]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {  // rows (tap, ci) of out, n along them
    const int k = k0 + i, n = n0 + tx, ci = k / taps, tap = k % taps;
    if (ci < Kin && n < N)
      out[((long long)tap * Kin + ci) * N + n] = __float2bfloat16(tile[tx][i]);
  }
}

// Kernel 3's per-channel vectors and FiLM as float32: rows of `ld` (row i
// of v, zero past C or for a null row) and, after them, the B x 2 C FiLM
// values; each source in its dtype (0 float32, 1 bf16).
struct Vecs {
  const void* v[7];  // b1, b2, g1s, g1b, g2s, g2b, bres
};

__device__ __forceinline__ float load_as_float(const void* p, long long i, int dtype) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__global__ void __launch_bounds__(NT) vec_kernel(Vecs src, int vdtype, const void* film,
                                                int fdtype, float* __restrict__ out, int C, int ld,
                                                int filmn) {
  const int rows = 7 * ld;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < rows + filmn;
       e += gridDim.x * blockDim.x) {
    if (e < rows) {
      const int i = e / ld, c = e % ld;
      out[e] = c < C && src.v[i] != nullptr ? load_as_float(src.v[i], c, vdtype) : 0.f;
    } else {
      out[e] = load_as_float(film, e - rows, fdtype);
    }
  }
}

// w (Cout, Cin, taps) float32 (dtype 0) or bf16 (1) -> out (taps, Kin, N)
// bf16, zero past Cin and Cout.
cudaError_t tap_major(int dtype, const void* w, bf16* out, int Cout, int Cin, int taps, int Kin,
                      int N, cudaStream_t stream) {
  const dim3 grid((Kin * taps + 31) / 32, (N + 31) / 32), block(32, 8);
  if (dtype == 0)
    tap_major_kernel<float><<<grid, block, 0, stream>>>((const float*)w, out, Cout, Cin, taps,
                                                         Kin, N);
  else
    tap_major_kernel<bf16><<<grid, block, 0, stream>>>((const bf16*)w, out, Cout, Cin, taps,
                                                        Kin, N);
  return cudaGetLastError();
}

int grid_of(long long total) {
  const long long want = (total + NT - 1) / NT;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

// One instantiation of conv_gn_kernel on the stream.
template <int RS, int MINB, int BN, class... Args>
cudaError_t conv_gn_launch(dim3 grid, cudaStream_t stream, Args... args) {
  constexpr int bytes = ring_smem<RS, BN>();
  cudaError_t err = cudaFuncSetAttribute(conv_gn_kernel<RS, MINB, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  conv_gn_kernel<RS, MINB, BN><<<grid, GT, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// conv_gn_kernel with a ring of `stages` and tiles `bn` wide: 3 stages let
// two 128-wide blocks or three 64-wide ones share an SM, 5 one. Grid: (rows,
// ncols tiles of bn columns, doubled with the residual projection's tiles).
template <class... Args>
cudaError_t conv_gn(int stages, int bn, int rows, int ncols, cudaStream_t stream, Args... args) {
  const dim3 grid(rows, ncols);
  if (stages == 3 && bn == 64) return conv_gn_launch<3, 3, 64>(grid, stream, args...);
  if (stages == 3 && bn == GN) return conv_gn_launch<3, 2, GN>(grid, stream, args...);
  if (stages == STAGES && bn == 64) return conv_gn_launch<STAGES, 1, 64>(grid, stream, args...);
  if (stages == STAGES && bn == GN) return conv_gn_launch<STAGES, 1, GN>(grid, stream, args...);
  return cudaErrorInvalidValue;
}

// Kernel 3's scratch, carved from one buffer in this order, each region
// 256-byte aligned (its size: the resnet_scratch_bytes query below): the
// tap-major bf16 weights w1 (9, Kin, N), w2 (9, N, N), wres (1, Kin, N);
// the float32 vectors (7, N) followed by FiLM (B, 2 Cout); y1, a1 (bf16),
// y2, r (P, N); the float64 statistics (2, B, G, 2); the float2
// coefficients (B, N).
struct Scratch {
  size_t w1, w2, wr, vec, y1, a1, y2, r, stats, coef, total;
  Scratch(int B, long long P, int Kin, int N, int C, int groups, bool res, bool has_film) {
    size_t at = 0;
    auto take = [&at](size_t bytes) {
      const size_t off = at;
      at += (bytes + 255) / 256 * 256;
      return off;
    };
    w1 = take(9ull * Kin * N * 2);
    w2 = take(9ull * N * N * 2);
    wr = take(res ? 1ull * Kin * N * 2 : 0);
    vec = take((7ull * N + (has_film ? 2ull * B * C : 0)) * 4);
    y1 = take((size_t)P * N * 4);
    a1 = take((size_t)P * N * 2);
    y2 = take((size_t)P * N * 4);
    r = take(res ? (size_t)P * N * 4 : 0);
    stats = take(4ull * B * groups * 8);
    coef = take(2ull * B * N * 4);
    total = at;
  }
};

int block_wgmma(const bf16* x, const void* w1raw, const void* w2raw, const void* wresraw,
                int wdtype, const Vecs& vecs, int vdtype, const void* filmraw, int fdtype,
                uint8_t* scratch, long long scratch_bytes, bf16* out, int B, int F, int H, int W,
                int Cin, int Cout, int Kin, int N, int groups, float eps, int stages1, int stages2,
                int bn, cudaStream_t stream) {
  const long long S = (long long)F * H * W, Pl = S * B;
  const bool res = wresraw != nullptr;
  if (groups > MAXG || Cout % groups || Kin % 8 || N % 8 || Cout > N || Cin > Kin ||
      Pl >= (1LL << 31) - GM || !aligned16(x) || (!res && Kin != N) ||
      (wdtype != 0 && wdtype != 1) || (vdtype != 0 && vdtype != 1) ||
      (filmraw != nullptr && fdtype != 0 && fdtype != 1))
    return (int)cudaErrorInvalidValue;
  const Scratch sc(B, Pl, Kin, N, Cout, groups, res, filmraw != nullptr);
  if ((long long)sc.total != scratch_bytes) return (int)cudaErrorInvalidValue;
  const int P = (int)Pl;
  bf16* w1 = reinterpret_cast<bf16*>(scratch + sc.w1);
  bf16* w2 = reinterpret_cast<bf16*>(scratch + sc.w2);
  bf16* wres = res ? reinterpret_cast<bf16*>(scratch + sc.wr) : nullptr;
  float* vec = reinterpret_cast<float*>(scratch + sc.vec);
  const float* film = filmraw != nullptr ? vec + 7 * N : nullptr;
  float* y1 = reinterpret_cast<float*>(scratch + sc.y1);
  bf16* a1 = reinterpret_cast<bf16*>(scratch + sc.a1);
  float* y2 = reinterpret_cast<float*>(scratch + sc.y2);
  float* r = res ? reinterpret_cast<float*>(scratch + sc.r) : nullptr;
  double* stats = reinterpret_cast<double*>(scratch + sc.stats);
  float2* coef = reinterpret_cast<float2*>(scratch + sc.coef);
  const float *b1 = vec, *b2 = vec + N, *g1s = vec + 2 * N, *g1b = vec + 3 * N,
              *g2s = vec + 4 * N, *g2b = vec + 5 * N, *bres = res ? vec + 6 * N : nullptr;
  // 0. the operands as the convs read them: tap-major bf16 weights, float32
  // vectors and FiLM (in-place casts of the caller's parameters), zero sums
  cudaError_t err = tap_major(wdtype, w1raw, w1, Cout, Cin, 9, Kin, N, stream);
  if (err == cudaSuccess) err = tap_major(wdtype, w2raw, w2, Cout, Cout, 9, N, N, stream);
  if (err == cudaSuccess && res)
    err = tap_major(wdtype, wresraw, wres, Cout, Cin, 1, Kin, N, stream);
  if (err != cudaSuccess) return (int)err;
  const int filmn = filmraw != nullptr ? 2 * B * Cout : 0;
  vec_kernel<<<grid_of(7LL * N + filmn), NT, 0, stream>>>(vecs, vdtype, filmraw, fdtype, vec, Cout,
                                                         N, filmn);
  if ((err = cudaMemsetAsync(stats, 0, 4ull * B * groups * 8, stream)) != cudaSuccess)
    return (int)err;
  CUtensorMap m1, m2, mr;
  int code = weight_map(&m1, w1, Kin, N);
  if (code == 0) code = weight_map(&m2, w2, N, N);
  if (code == 0) code = weight_map(&mr, res ? wres : w1, Kin, N, 1);
  if (code != 0) return code;
  double* stats1 = stats;
  double* stats2 = stats + 2 * B * groups;
  const int rows = (P + GM - 1) / GM, cols = (N + bn - 1) / bn;
  // 1. conv1 (+ the residual projection's tiles)
  err = conv_gn(stages1, bn, rows, cols * (res ? 2 : 1), stream, m1, mr, x, b1, y1, bres, r,
                stats1, P, H, W, Kin, N, Cout, groups, (int)S, cols);
  if (err != cudaSuccess) return (int)err;
  // 2. a1 = SiLU(FiLM(GN1(y1)))
  const GNIn gn1{stats1, g1s, g1b, film, groups, eps}, gn2{stats2, g2s, g2b, nullptr, groups, eps};
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn1, coef, B, Cout, N, S);
  const long long total4 = Pl * N / 4;
  gn_act_kernel<<<grid_of(total4), NT, 0, stream>>>(reinterpret_cast<const float4*>(y1), coef,
                                                    reinterpret_cast<uint2*>(a1), N, S, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. conv2
  err = conv_gn(stages2, bn, rows, cols, stream, m2, m2, a1, b2, y2, nullptr, nullptr, stats2, P,
                H, W, N, N, Cout, groups, (int)S, cols);
  if (err != cudaSuccess) return (int)err;
  // 4. out = SiLU(GN2(y2)) + residual
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn2, coef, B, Cout, N, S);
  gn_silu_res_kernel<<<grid_of(Pl * Cout), NT, 0, stream>>>(y2, coef, x, r, out, Cout, N, S,
                                                           Pl * Cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// The block's backward given x and the output's cotangent g (kernel 7,
// replacing pallas_resnet.py _bwd_kernel_impl / _make_bwd_kernel): the
// forward's convs run again (y1, y2 and their GroupNorm sums), then
//   GN2 stage:  per-(b, c) sums of du and du * yhat (du = g SiLU'(u), u the
//               SiLU's input), from which dscale2, dbias2 and the per-group
//               means of the GN backward follow; dy2 elementwise;
//   conv2:      dW2 / db2 = sums over pixels of a1 (x) dy2 per tap
//               (conv_wgrad_kernel, split over pixel tiles, summed in order),
//               da1 = conv(dy2) with flipped, transposed weights (the
//               forward's conv kernel, no bias);
//   GN1 stage:  as GN2 with FiLM: dscale1, dbias1 and dfilm (B, 2 Cout);
//   conv1:      dW1 / db1 and dx1 likewise;
//   residual:   dWres / dbres and dres = g Wres (1x1), or g itself; dx = dx1 + dres.
// Per-(b, c) sums are float within a block and float64 atomics across
// blocks (the order of those adds varies between runs, below float32
// resolution); the weight-gradient sums are deterministic.
__device__ __forceinline__ float silu_grad(float u) {
  const float sg = 1.f / (1.f + expf(-u));
  return sg * (1.f + u * (1.f - sg));
}

// SiLU(FiLM(GN(y))) rounded to T: the conv2 input the forward forms on load.
template <typename T>
__global__ void __launch_bounds__(NT) gn_act_kernel(const T* __restrict__ y, GNIn gn,
                                                   T* __restrict__ out, long long S, int C,
                                                   long long total) {
  const double n = (double)S * (C / gn.groups);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C), b = (int)(i / (S * C));
    float mean, rstd;
    group_moments(gn.stats, b, c / (C / gn.groups), gn.groups, n, gn.eps, &mean, &rstd);
    float v = (to_f(y[i]) - mean) * rstd * gn.scale[c] + gn.bias[c];
    if (gn.film != nullptr) {
      const float* f = gn.film + (long long)b * 2 * C;
      v = v * (f[c] + 1.f) + f[C + c];
    }
    out[i] = from_f<T>(silu(v));
  }
}

// sums[b][c] += (sum of du, sum of du * yhat) over the pixels of this block's
// chunk of sample b (grid: chunks x B), du = gup * SiLU'(u).
template <typename T>
__global__ void __launch_bounds__(NT) gn_bwd_sums_kernel(const T* __restrict__ y,
                                                        const T* __restrict__ gup, GNIn gn,
                                                        double* __restrict__ sums, long long S,
                                                        int C) {
  __shared__ float s_du[256], s_duy[256];
  __shared__ float g_mean[MAXG], g_rstd[MAXG];
  const int tid = threadIdx.x, b = blockIdx.y, cg = C / gn.groups;
  for (int c = tid; c < C; c += NT) s_du[c] = s_duy[c] = 0.f;
  if (tid < gn.groups)
    group_moments(gn.stats, b, tid, gn.groups, (double)S * cg, gn.eps, &g_mean[tid], &g_rstd[tid]);
  __syncthreads();
  const float* f = gn.film != nullptr ? gn.film + (long long)b * 2 * C : nullptr;
  const long long chunk = (S + gridDim.x - 1) / gridDim.x;
  const long long p0 = blockIdx.x * chunk, p1 = min(S, p0 + chunk);
  const long long base = (long long)b * S * C;
  const bool fixed = NT % C == 0;  // each thread then sees one channel only
  float du_acc = 0.f, duy_acc = 0.f;
  for (long long e = p0 * C + tid; e < p1 * C; e += NT) {
    const int c = (int)(e % C), gi = c / cg;
    const float yh = (to_f(y[base + e]) - g_mean[gi]) * g_rstd[gi];
    float u = yh * gn.scale[c] + gn.bias[c];
    if (f != nullptr) u = u * (f[c] + 1.f) + f[C + c];
    const float du = to_f(gup[base + e]) * silu_grad(u);
    if (fixed) {
      du_acc += du;
      duy_acc += du * yh;
    } else {
      atomicAdd(&s_du[c], du);
      atomicAdd(&s_duy[c], du * yh);
    }
  }
  if (fixed && tid < C * (NT / C)) {
    atomicAdd(&s_du[tid % C], du_acc);
    atomicAdd(&s_duy[tid % C], duy_acc);
  }
  __syncthreads();
  for (int c = tid; c < C; c += NT) {
    atomicAdd(&sums[((long long)b * C + c) * 2], (double)s_du[c]);
    atomicAdd(&sums[((long long)b * C + c) * 2 + 1], (double)s_duy[c]);
  }
}

// One block: from the per-(b, c) sums A = sum du, Q = sum du yhat, with
// k = FiLM scale + 1 (1 without FiLM):
//   dscale[c] = sum_b k Q, dbias[c] = sum_b k A,
//   dfilm[b] = (scale Q + bias A | A),
//   coef[b][g] = means over the group of dyhat and dyhat yhat, dyhat = du k scale.
__global__ void __launch_bounds__(NT) gn_bwd_finalize_kernel(const double* __restrict__ sums, GNIn gn,
                                                            float* __restrict__ dscale,
                                                            float* __restrict__ dbias,
                                                            float* __restrict__ dfilm,
                                                            float* __restrict__ coef, int B,
                                                            long long S, int C) {
  const int tid = threadIdx.x, cg = C / gn.groups;
  for (int c = tid; c < C; c += NT) {
    double ds = 0.0, db = 0.0;
    for (int b = 0; b < B; ++b) {
      const double A = sums[((long long)b * C + c) * 2], Q = sums[((long long)b * C + c) * 2 + 1];
      const double k = gn.film != nullptr ? (double)gn.film[(long long)b * 2 * C + c] + 1.0 : 1.0;
      ds += k * Q;
      db += k * A;
      if (dfilm != nullptr) {
        dfilm[(long long)b * 2 * C + c] = (float)(gn.scale[c] * Q + gn.bias[c] * A);
        dfilm[(long long)b * 2 * C + C + c] = (float)A;
      }
    }
    dscale[c] = (float)ds;
    dbias[c] = (float)db;
  }
  const double n = (double)S * cg;
  for (int e = tid; e < B * gn.groups; e += NT) {
    const int b = e / gn.groups, gi = e % gn.groups;
    double s1 = 0.0, s2 = 0.0;
    for (int c = gi * cg; c < (gi + 1) * cg; ++c) {
      const double k = gn.film != nullptr ? (double)gn.film[(long long)b * 2 * C + c] + 1.0 : 1.0;
      s1 += gn.scale[c] * k * sums[((long long)b * C + c) * 2];
      s2 += gn.scale[c] * k * sums[((long long)b * C + c) * 2 + 1];
    }
    coef[e * 2] = (float)(s1 / n);
    coef[e * 2 + 1] = (float)(s2 / n);
  }
}

// dy = rstd (dyhat - mean dyhat - yhat mean(dyhat yhat)), dyhat = du k scale.
template <typename T>
__global__ void __launch_bounds__(NT) gn_bwd_dy_kernel(const T* __restrict__ y,
                                                      const T* __restrict__ gup, GNIn gn,
                                                      const float* __restrict__ coef,
                                                      T* __restrict__ dy, long long S, int C,
                                                      long long total) {
  const double n = (double)S * (C / gn.groups);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C), b = (int)(i / (S * C)), gi = c / (C / gn.groups);
    float mean, rstd;
    group_moments(gn.stats, b, gi, gn.groups, n, gn.eps, &mean, &rstd);
    const float yh = (to_f(y[i]) - mean) * rstd;
    float u = yh * gn.scale[c] + gn.bias[c], k = 1.f;
    if (gn.film != nullptr) {
      const float* f = gn.film + (long long)b * 2 * C;
      k = f[c] + 1.f;
      u = u * k + f[C + c];
    }
    const float dyh = to_f(gup[i]) * silu_grad(u) * k * gn.scale[c];
    const float* cf = coef + ((long long)b * gn.groups + gi) * 2;
    dy[i] = from_f<T>(rstd * (dyh - cf[0] - yh * cf[1]));
  }
}

// part_w[z][co][ci][tap] = sum over the pixel tiles of split z of
// dy[p][co] in[p + tap][ci]; part_b[z][co] = sum of dy[p][co] (written by the
// blocks of the first input-channel tile). Grid: (Cin / 16, Cout / 64, splits);
// a thread owns one input channel and 4 output channels, all K*K taps.
template <typename T, int K>
__global__ void __launch_bounds__(NT) conv_wgrad_kernel(const T* __restrict__ in,
                                                       const T* __restrict__ dy,
                                                       float* __restrict__ part_w,
                                                       float* __restrict__ part_b, int frames,
                                                       int H, int W, int Cin, int Cout,
                                                       int tiles_per_split) {
  constexpr int P = PXT + K - 1, DS = CO_T + 1;
  __shared__ float patch[P * P * CI_T];    // [pixel][input channel]
  __shared__ float dys[PXT * PXT * DS];  // [pixel][output channel]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ci0 = blockIdx.x * CI_T, co0 = blockIdx.y * CO_T, z = blockIdx.z;
  const int tiles_w = (W + PXT - 1) / PXT, tiles_h = (H + PXT - 1) / PXT;
  const int ntiles = frames * tiles_h * tiles_w;
  const int t_begin = z * tiles_per_split, t_end = min(ntiles, t_begin + tiles_per_split);
  float acc[4][K * K], bacc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int t = 0; t < K * K; ++t) acc[j][t] = 0.f;
  }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int frame = tile / (tiles_h * tiles_w), rem = tile % (tiles_h * tiles_w);
    const int y0 = (rem / tiles_w) * PXT, x0 = (rem % tiles_w) * PXT;
    const T* in_f = in + (long long)frame * H * W * Cin;
    const T* dy_f = dy + (long long)frame * H * W * Cout;
    __syncthreads();
    for (int e = tid; e < P * P * CI_T; e += NT) {
      const int cl = e % CI_T, pix = e / CI_T;
      const int gy = y0 + pix / P - K / 2, gx = x0 + pix % P - K / 2, ci = ci0 + cl;
      patch[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin)
                     ? to_f(in_f[((long long)gy * W + gx) * Cin + ci]) : 0.f;
    }
    for (int e = tid; e < PXT * PXT * CO_T; e += NT) {
      const int col = e % CO_T, pix = e / CO_T;
      const int gy = y0 + pix / PXT, gx = x0 + pix % PXT, co = co0 + col;
      dys[pix * DS + col] = (gy < H && gx < W && co < Cout)
                                ? to_f(dy_f[((long long)gy * W + gx) * Cout + co]) : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < PXT * PXT; ++p) {
      const int py = p / PXT, px = p % PXT;
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dv[j] = dys[p * DS + tx + 16 * j];
        bacc[j] += dv[j];
      }
#pragma unroll
      for (int t = 0; t < K * K; ++t) {
        const float av = patch[((py + t / K) * P + px + t % K) * CI_T + ty];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][t] = fmaf(av, dv[j], acc[j][t]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tx + 16 * j, ci = ci0 + ty;
    if (co >= Cout) continue;
    if (ci < Cin) {
#pragma unroll
      for (int t = 0; t < K * K; ++t)
        part_w[(((long long)z * Cout + co) * Cin + ci) * K * K + t] = acc[j][t];
    }
    if (part_b != nullptr && blockIdx.x == 0 && ty == 0) part_b[(long long)z * Cout + co] = bacc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) add_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                T* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = from_f<T>(to_f(a[i]) + to_f(b[i]));
}

int grid_for(long long total) {
  const long long want = (total + NT - 1) / NT;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

template <typename T, int K>
cudaError_t wgrad(const T* in, const T* dy, float* part_w, float* part_b, float* dw, float* db,
                  int frames, int H, int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  const int ntiles = frames * ((H + PXT - 1) / PXT) * ((W + PXT - 1) / PXT);
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((Cin + CI_T - 1) / CI_T, (Cout + CO_T - 1) / CO_T, splits);
  conv_wgrad_kernel<T, K><<<grid, NT, 0, stream>>>(in, dy, part_w, db != nullptr ? part_b : nullptr,
                                                   frames, H, W, Cin, Cout, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = sum_parts(part_w, splits, (long long)Cout * Cin * K * K, dw, stream)) != cudaSuccess)
    return err;
  return db != nullptr ? sum_parts(part_b, splits, Cout, db, stream) : cudaSuccess;
}

// GN + SiLU backward of one stage: sums, finalize, dy.
template <typename T>
cudaError_t gn_bwd(const T* y, const T* gup, const GNIn& gn, double* sums, float* dscale,
                   float* dbias, float* dfilm, float* coef, T* dy, int B, long long S, int C,
                   cudaStream_t stream) {
  const long long chunks = (S * C + NT * 64 - 1) / (NT * 64);
  const dim3 grid((unsigned)(chunks < 128 ? chunks : 128), B);
  gn_bwd_sums_kernel<T><<<grid, NT, 0, stream>>>(y, gup, gn, sums, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_finalize_kernel<<<1, NT, 0, stream>>>(sums, gn, dscale, dbias, dfilm, coef, B, S, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)B * S * C;
  gn_bwd_dy_kernel<T><<<grid_for(total), NT, 0, stream>>>(y, gup, gn, coef, dy, S, C, total);
  return cudaGetLastError();
}

template <typename T>
int block_bwd(const T* x, const T* gout, const T* w1, const T* w1f, const float* b1,
              const float* g1s, const float* g1b, const float* film, const T* w2, const T* w2f,
              const float* b2, const float* g2s, const float* g2b, const T* wresf, T* y1, T* y2,
              T* a1, T* dy2, T* da1, T* dy1, T* dx1, T* dres, double* stats, double* sums,
              float* coef, float* part_w, float* part_b, T* dx, float* dw1, float* db1,
              float* dg1s, float* dg1b, float* dfilm, float* dw2, float* db2, float* dg2s,
              float* dg2b, float* dwres, float* dbres, int B, int F, int H, int W, int Cin,
              int Cout, int groups, float eps, int splits1, int splits2, int splits_res,
              cudaStream_t stream) {
  if (groups > MAXG || Cout % groups || Cout > 256) return (int)cudaErrorInvalidValue;
  double* stats1 = stats;
  double* stats2 = stats + 2 * B * groups;
  double* sums1 = sums;
  double* sums2 = sums + 2 * (long long)B * Cout;
  const GNIn none{nullptr, nullptr, nullptr, nullptr, 1, eps};
  const GNIn gn1{stats1, g1s, g1b, film, groups, eps};
  const GNIn gn2{stats2, g2s, g2b, nullptr, groups, eps};
  const long long S = (long long)F * H * W, total = S * B * Cout;
  cudaError_t err;
#define CHECK(call)                               \
  if ((err = (call)) != cudaSuccess) return (int)err;
  // the forward's convs again, with their GroupNorm sums
  CHECK((conv<T, 3, false, true>(x, w1, b1, y1, none, stats1, groups, B, F, H, W, Cin, Cout, stream)));
  CHECK((conv<T, 3, true, true>(y1, w2, b2, y2, gn1, stats2, groups, B, F, H, W, Cout, Cout, stream)));
  gn_act_kernel<T><<<grid_for(total), NT, 0, stream>>>(y1, gn1, a1, S, Cout, total);
  CHECK(cudaGetLastError());
  // GN2 + SiLU, conv2
  CHECK(gn_bwd<T>(y2, gout, gn2, sums2, dg2s, dg2b, nullptr, coef + 2 * B * groups, dy2, B, S, Cout,
                  stream));
  CHECK((wgrad<T, 3>(a1, dy2, part_w, part_b, dw2, db2, B * F, H, W, Cout, Cout, splits2, stream)));
  CHECK((conv<T, 3, false, false>(dy2, w2f, nullptr, da1, none, nullptr, groups, B, F, H, W, Cout,
                                  Cout, stream)));
  // GN1 + FiLM + SiLU, conv1
  CHECK(gn_bwd<T>(y1, da1, gn1, sums1, dg1s, dg1b, dfilm, coef, dy1, B, S, Cout, stream));
  CHECK((wgrad<T, 3>(x, dy1, part_w, part_b, dw1, db1, B * F, H, W, Cin, Cout, splits1, stream)));
  CHECK((conv<T, 3, false, false>(dy1, w1f, nullptr, dx1, none, nullptr, groups, B, F, H, W, Cout,
                                  Cin, stream)));
  // residual
  const T* res = gout;
  if (wresf != nullptr) {
    CHECK((wgrad<T, 1>(x, gout, part_w, part_b, dwres, dbres, B * F, H, W, Cin, Cout, splits_res,
                       stream)));
    CHECK((conv<T, 1, false, false>(gout, wresf, nullptr, dres, none, nullptr, groups, B, F, H, W,
                                    Cout, Cin, stream)));
    res = dres;
  }
  const long long n_in = S * B * Cin;
  add_kernel<T><<<grid_for(n_in), NT, 0, stream>>>(dx1, res, dx, n_in);
#undef CHECK
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 3 in float32 (the check path; dtype 0, bf16 takes
// resnet_block_wgmma). stats: (2, B, groups, 2) float64, zeroed by the caller.
// y1, y2, r: scratch of the output's shape (r only with a residual
// projection).
extern "C" int resnet_block(int dtype, const void* x, const void* w1, const float* b1,
                            const float* g1s, const float* g1b, const float* film, const void* w2,
                            const float* b2, const float* g2s, const float* g2b, const void* wres,
                            const float* bres, void* y1, void* y2, void* r, double* stats,
                            void* out, int B, int F, int H, int W, int Cin, int Cout, int groups,
                            float eps, void* stream) {
  if ((long long)B * F * H * W == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: resnet_block_wgmma
  return block<float>((const float*)x, (const float*)w1, b1, g1s, g1b, film, (const float*)w2, b2,
                      g2s, g2b, (const float*)wres, bres, (float*)y1, (float*)y2, (float*)r, stats,
                      (float*)out, B, F, H, W, Cin, Cout, groups, eps, (cudaStream_t)stream);
}

// Kernel 3 in bf16 on the wgmma engine. x (B, F, H, W, Kin) bf16, the
// channels past Cin zero (Kin = Cin rounded up to a multiple of 8, N the
// same of Cout); the block's parameters as the caller holds them: w1 (Cout,
// Cin, 3, 3), w2 (Cout, Cout, 3, 3), wres (Cout, Cin) or null in wdtype (0
// float32, 1 bf16); b1, g1s, g1b, b2, g2s, g2b, bres (Cout; bres null
// without wres) in vdtype; film (B, 2 Cout) in fdtype, or null. scratch:
// scratch_bytes of device memory (resnet_scratch_bytes: the converted
// operands, y1, a1, y2, r, the statistics and coefficients; it passes 2 GiB
// at KTH's 64-channel level when an evaluation's trajectories ride the
// batch). out
// (B, F, H, W, Cout) bf16. Without wres, Kin == N. stages1, stages2: the
// ring depth of conv1 and conv2 (3 or 5), bn the tiles' width (64 or
// 128): fused_resnet.resnet_plan.
extern "C" int resnet_block_wgmma(const void* x, const void* w1, const void* w2, const void* wres,
                                  int wdtype, const void* b1, const void* g1s, const void* g1b,
                                  const void* b2, const void* g2s, const void* g2b,
                                  const void* bres, int vdtype, const void* film, int fdtype,
                                  void* scratch, long long scratch_bytes, void* out, int B, int F,
                                  int H, int W, int Cin, int Cout, int Kin, int N, int groups,
                                  float eps, int stages1, int stages2, int bn, void* stream) {
  if ((long long)B * F * H * W == 0) return 0;
  const Vecs vecs{{b1, b2, g1s, g1b, g2s, g2b, bres}};
  return block_wgmma((const bf16*)x, w1, w2, wres, wdtype, vecs, vdtype, film, fdtype,
                     (uint8_t*)scratch, scratch_bytes, (bf16*)out, B, F, H, W, Cin, Cout, Kin, N,
                     groups, eps, stages1, stages2, bn, (cudaStream_t)stream);
}

// Bytes of the scratch resnet_block_wgmma takes for B samples of P pixels
// (B F H W), Kin -> N padded channels (C real output channels), with the
// residual projection (res) and FiLM (film) or without; -1 for no block.
extern "C" long long resnet_scratch_bytes(int B, long long P, int Kin, int N, int C, int groups,
                                          int res, int film) {
  if (B < 1 || P < 0 || Kin < 1 || N < 1 || C < 1 || C > N || groups < 1) return -1;
  return (long long)Scratch(B, P, Kin, N, C, groups, res != 0, film != 0).total;
}

// Gradients of resnet_block given x and the output's cotangent gout. w1f,
// w2f: the conv weights flipped in (kh, kw) and transposed to (Cin', Cout'),
// the layout of the dgrad convs; wresf (Cin, Cout) or null. Scratch: y1, y2,
// a1, dy2, da1, dy1 of the output's shape, dx1 and dres (with wresf) of x's,
// stats (2, B, groups, 2) and sums (2, B, Cout, 2) float64 zeroed by the
// caller, coef (2, B, groups, 2), part_w and part_b large enough for the
// largest of the three weight-gradient splits. Gradients of the float
// operands are float32; dfilm (B, 2 Cout) or null.
extern "C" int resnet_block_bwd(int dtype, const void* x, const void* gout, const void* w1,
                                const void* w1f, const float* b1, const float* g1s,
                                const float* g1b, const float* film, const void* w2,
                                const void* w2f, const float* b2, const float* g2s,
                                const float* g2b, const void* wresf, void* y1, void* y2, void* a1,
                                void* dy2, void* da1, void* dy1, void* dx1, void* dres,
                                double* stats, double* sums, float* coef, float* part_w,
                                float* part_b, void* dx, float* dw1, float* db1, float* dg1s,
                                float* dg1b, float* dfilm, float* dw2, float* db2, float* dg2s,
                                float* dg2b, float* dwres, float* dbres, int B, int F, int H,
                                int W, int Cin, int Cout, int groups, float eps, int splits1,
                                int splits2, int splits_res, void* stream) {
  if ((long long)B * F * H * W == 0) return 0;
  DISPATCH_DTYPE(dtype, return block_bwd<T>(
      (const T*)x, (const T*)gout, (const T*)w1, (const T*)w1f, b1, g1s, g1b, film, (const T*)w2,
      (const T*)w2f, b2, g2s, g2b, (const T*)wresf, (T*)y1, (T*)y2, (T*)a1, (T*)dy2, (T*)da1,
      (T*)dy1, (T*)dx1, (T*)dres, stats, sums, coef, part_w, part_b, (T*)dx, dw1, db1, dg1s, dg1b,
      dfilm, dw2, db2, dg2s, dg2b, dwres, dbres, B, F, H, W, Cin, Cout, groups, eps, splits1,
      splits2, splits_res, (cudaStream_t)stream));
  return 0;
}
