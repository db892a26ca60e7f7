// Whole time-conditioned ResnetBlock3d of the diffusion UNet:
//
//   h   = SiLU(GN1(conv3x3(x) + b1) * (scale + 1) + shift)
//   out = SiLU(GN2(conv3x3(h) + b2)) + (x or x Wres + bres)
//
// Replaces extdm_tpu/ops/pallas_resnet.py fused_resnet_block (_kernel_impl
// -> _make_kernel), which holds a whole sample in TPU VMEM so GroupNorm's
// statistics (over all T*H*W*C/G values of a group) need no cross-program
// reduction. A Hopper SM holds 227 KB, far less than a sample, so the block
// is a short sequence of this file's kernels on the caller's stream:
//
//   1. conv_kernel<3, no transform>: conv1 + b1 -> y1 (T), and each block's
//      per-group sum / sum of squares added into a float64 (B, G, 2) buffer.
//   2. conv_kernel<3, transform>: GN1 + FiLM + SiLU are applied to y1 while
//      it is staged into shared memory (zero padding stays zero), conv2 + b2
//      -> y2 (T), GN2 statistics likewise.
//   3. conv_kernel<1> (only with a residual projection): x Wres + bres -> r.
//   4. gn_silu_add_kernel: out = SiLU(GN2(y2)) + (x or r).
//
// Bound on the H100: operations for the 3x3 convs (2*9*Cin*Cout flops per
// pixel against a few bytes), bytes for step 4. The convs are implicit
// GEMMs: a block computes an 8x8 pixel tile of one frame for 64 output
// channels, staging a 10x10 input halo and the 3x3 weights for 16 input
// channels at a time in shared memory. In bf16 the products run on the
// tensor cores (mma.sync m16n8k16, float accumulators): each of the 8 warps
// owns 16 pixels x 32 channels and takes one k=16 step per tap. In float32
// (the tight reference checks) each thread accumulates 4 pixels x 4
// channels with FMAs. The (1,3,3) kernel never mixes frames, so frames are
// independent grid rows. Statistics are summed in float within a block and
// in float64 across blocks, so E[y^2] - E[y]^2 loses nothing that matters
// at a group size of ~10^6.
// Weights stay in PyTorch's Conv layout (Cout, Cin, kh, kw).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int TILE = 8;   // output tile is TILE x TILE pixels
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
  constexpr int P = TILE + K - 1;  // staged halo width
  __shared__ float patch[P * P * CI_T];
  __shared__ float wbuf[K * K * CI_T * CO_T];
  __shared__ float g_mean[MAXG], g_rstd[MAXG];
  __shared__ float s_sum[MAXG], s_sq[MAXG];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int tiles_w = (W + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_w) * TILE, x0 = (blockIdx.x % tiles_w) * TILE;
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
          const int p = ty + 16 * i, py = p / TILE, px = p % TILE;
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
      const int p = ty + 16 * i, gy = y0 + p / TILE, gx = x0 + p % TILE;
      if (gy >= H || gx >= W) continue;
      const float v = round_to<T>(acc[i][j] + bias[co]);
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
  constexpr int P = TILE + K - 1;
  __shared__ __align__(16) bf16 patch[P * P * PS];       // [pixel][input channel]
  __shared__ __align__(16) bf16 wbuf[K * K * CO_T * PS];  // [tap][output channel][input channel]
  __shared__ float g_mean[MAXG], g_rstd[MAXG];
  __shared__ float s_sum[MAXG], s_sq[MAXG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, ng = warp >> 2;  // 16-pixel row block, 32-channel half
  const int tiles_w = (W + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_w) * TILE, x0 = (blockIdx.x % tiles_w) * TILE;
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
      const bf16* a_lo = patch + ((p0 / TILE + dy) * P + p0 % TILE + dx) * PS + 2 * t4;
      const bf16* a_hi = patch + ((p1 / TILE + dy) * P + p1 % TILE + dx) * PS + 2 * t4;
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
        const int p = h ? p1 : p0, gy = y0 + p / TILE, gx = x0 + p % TILE;
        if (gy < H && gx < W && co < Cout) {
          const float v = round_to<bf16>(acc[j][2 * h + e] + bias[co]);
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
  const dim3 grid(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), (Cout + CO_T - 1) / CO_T, B * F);
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

}  // namespace

// stats: (2, B, groups, 2) float64, zeroed by the caller. y1, y2, r: scratch
// of the output's shape (r only with a residual projection).
extern "C" int resnet_block(int dtype, const void* x, const void* w1, const float* b1,
                            const float* g1s, const float* g1b, const float* film, const void* w2,
                            const float* b2, const float* g2s, const float* g2b, const void* wres,
                            const float* bres, void* y1, void* y2, void* r, double* stats,
                            void* out, int B, int F, int H, int W, int Cin, int Cout, int groups,
                            float eps, void* stream) {
  if ((long long)B * F * H * W == 0) return 0;
  DISPATCH_DTYPE(dtype, return block<T>((const T*)x, (const T*)w1, b1, g1s, g1b, film,
                                        (const T*)w2, b2, g2s, g2b, (const T*)wres, bres, (T*)y1,
                                        (T*)y2, (T*)r, stats, (T*)out, B, F, H, W, Cin, Cout,
                                        groups, eps, (cudaStream_t)stream));
  return 0;
}
