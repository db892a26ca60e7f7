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
// ~10^6. The float32 path takes weights in PyTorch's Conv layout (Cout, Cin,
// kh, kw).
//
// The backward (kernel 7, replacing pallas_resnet.py _bwd_kernel_impl /
// _make_bwd_kernel), given x and the output's cotangent g.
// bf16 (resnet_block_bwd_wgmma): a short sequence of launches on the same
// engine, behind one call, on operands the entry writes into one scratch
// buffer (tap-major bf16 weights, float32 vectors and FiLM):
//   1. the forward again: conv1 and conv2 on conv_gn_kernel (y1, y2 float32),
//      a1 = bf16(SiLU(GN1(y1) (scale + 1) + shift)) by gn_coef_kernel +
//      gn_act_kernel, both GroupNorms' statistics summed in a fixed order
//      (gn_part_kernel<MOMENTS>, gn_moments_kernel);
//   2. GN2 + SiLU backward: per-(b, c) sums of du = g SiLU'(u) and du yhat
//      over pixel chunks, added in order (gn_part_kernel, gn_group_kernel,
//      gn_channel_kernel: dscale2, dbias2, db2 and the residual's dbres);
//      dy2 in bf16 (gn_dy_kernel);
//   3. conv2's gradients on kernel 11's launch (conv_ring.cuh
//      bwd_wgmma_kernel<9>: din and dW tiles together): dh1 (float32) and
//      dW2, whose pixel splits conv_layout_kernel adds in order while it
//      writes PyTorch's layout; din reads w2[8 - tap] K-major, no flipped copy;
//   4. GN1 + FiLM + SiLU backward as 2, with dFiLM (B, 2 Cout): dy1 in bf16;
//   5. conv1's gradients likewise: dx1 (float32) and dW1;
//   6. the residual projection's 1 x 1 products on bwd_wgmma_kernel<1>: dres =
//      g Wres^T (float32), dWres = x^T g;
//   7. dx = bf16(dx1 + (dres or g)), rounded once (dx_kernel).
// Rounding: where JAX's kernel rounds: the recomputed conv outputs y1, y2
// (JAX's a1, a2), dh1 and the sum dx stay float32; only the conv inputs a1
// (JAX's h1c) and dy1, dy2 (JAX's md_c) are bf16, and dx once at the end.
// Every sum is added in a fixed order (no float atomics): the gradients are
// the same bit for bit on every run. Any Cout (at most 32 groups dividing
// it); channel counts padded to multiples of 8 as for kernel 3.
// float32 (resnet_block_bwd, the check path): the FMA convs above recompute
// the forward; the GroupNorm backward's per-channel sums sit in 256-entry
// shared arrays (Cout <= 256); dgrad convs with flipped, transposed
// weights; conv_wgrad_kernel for the weight gradients.
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
  conv_kernel<T, K, XFORM, STATS><<<grid, NT, 0, stream>>>(in, w, bias, out, gn, out_stats, groups,
                                                          F, H, W, Cin, Cout);
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
// stats (B, groups, 2), unless stats is null (kernel 7 sums them in order). Blocks y >= cols (with a residual projection):
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
    for (int e = 0; e < 2 && stats != nullptr; ++e) {
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
  if (stats == nullptr) return;
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
// (0, 0) for the pad channels c >= C of a row of ld. Kernel 7 also takes cf
// (or null): cf[b][c] = (mean, rstd of c's group, sk = scale k, bk = bias k
// + shift), so that yhat = (y - mean) rstd and the SiLU's input u = yhat sk +
// bk; zero for the pad channels.
__global__ void __launch_bounds__(NT) gn_coef_kernel(GNIn gn, float2* __restrict__ coef,
                                                    float4* __restrict__ cf, int B, int C, int ld,
                                                    long long S) {
  const double n = (double)S * (C / gn.groups);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B * ld; i += gridDim.x * blockDim.x) {
    const int b = i / ld, c = i % ld;
    float2 v = make_float2(0.f, 0.f);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C) {
      float mean, rstd, k = 1.f, shift = 0.f;
      group_moments(gn.stats, b, c / (C / gn.groups), gn.groups, n, gn.eps, &mean, &rstd);
      v.x = rstd * gn.scale[c];
      v.y = gn.bias[c] - mean * v.x;
      if (gn.film != nullptr) {
        const float* f = gn.film + (long long)b * 2 * C;
        k = f[c] + 1.f;
        shift = f[C + c];
        v.x *= k;
        v.y = v.y * k + shift;
      }
      w = make_float4(mean, rstd, gn.scale[c] * k, gn.bias[c] * k + shift);
    }
    coef[i] = v;
    if (cf != nullptr) cf[i] = w;
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
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn1, coef, nullptr, B, Cout, N,
                                                              S);
  const long long total4 = Pl * N / 4;
  gn_act_kernel<<<grid_of(total4), NT, 0, stream>>>(reinterpret_cast<const float4*>(y1), coef,
                                                    reinterpret_cast<uint2*>(a1), N, S, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. conv2
  err = conv_gn(stages2, bn, rows, cols, stream, m2, m2, a1, b2, y2, nullptr, nullptr, stats2, P,
                H, W, N, N, Cout, groups, (int)S, cols);
  if (err != cudaSuccess) return (int)err;
  // 4. out = SiLU(GN2(y2)) + residual
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn2, coef, nullptr, B, Cout, N,
                                                              S);
  gn_silu_res_kernel<<<grid_of(Pl * Cout), NT, 0, stream>>>(y2, coef, x, r, out, Cout, N, S,
                                                           Pl * Cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward, float32
// Kernel 7's check path: the forward's convs run again (y1, y2 and their
// GroupNorm sums), then
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


// ---------------------------------------------------------------- kernel 7, bf16
// The backward on the conv engine (resnet_block_bwd_wgmma; see the header).
// A GroupNorm stage's backward reads y (float32), the upstream gradient gup
// (g in bf16 for GN2, dh1 in float32 for GN1) and cf (gn_coef_kernel):
//   yhat = (y - mean) rstd, u = yhat sk + bk, du = gup SiLU'(u).
// gn_part_kernel: per-(b, c) sums A, Q, Y, G of du, du yhat, yhat and gup
//   over a chunk of sample b's pixels, a partial per (chunk, channel);
// gn_group_kernel: per sample, the partials added in chunk order (float64);
//   per group the means m1, m2 of dyhat and dyhat yhat (dyhat = du sk); per
//   channel the coefficients bc = (rstd sk, -rstd m1, -rstd m2) of
//   dy = bc.x du + bc.y + bc.z yhat, dFiLM (scale Q + bias A | A) and the
//   per-sample terms of the channel sums;
// gn_channel_kernel: dscale = sum_b k Q, dbias = sum_b k A, the conv bias's
//   gradient sum_b (bc.x A + S bc.y + bc.z Y) and the residual bias's sum_b
//   G, added over the samples in order;
// gn_dy_kernel: dy in bf16 (JAX's md_c), the gradient products' input.
// No float atomics: every sum is added in a fixed order.
struct Sum4 {
  double a, q, y, g;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// du and yhat of one element.
__device__ __forceinline__ void gn_terms(float y, float gup, const float4& cf, float* du,
                                         float* yh) {
  *yh = (y - cf.x) * cf.y;
  *du = gup * silu_grad(*yh * cf.z + cf.w);
}

constexpr int PART_COLS = 64;  // channels of a gn_part_kernel block: a warp's 32 pairs

// part[b chunks + ch][c] = (A, Q, Y, G) over rows [ch per, (ch + 1) per) of
// sample b, per = ceil(S / chunks); MOMENTS: (sum of y, of y^2, 0, 0), the
// recompute's GroupNorm statistics (gup, cf unread). Grid: (B chunks,
// ceil(ld / 64)); warp w takes rows w, w + 8, ...; the warps' sums are added
// in order.
template <typename G, bool MOMENTS = false>
__global__ void __launch_bounds__(NT) gn_part_kernel(const float* __restrict__ y,
                                                    const G* __restrict__ gup,
                                                    const float4* __restrict__ cf,
                                                    float4* __restrict__ part, int ld, long long S,
                                                    int chunks) {
  __shared__ float4 red[NT / 32][PART_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / chunks, ch = blockIdx.x % chunks;
  const int c = blockIdx.y * PART_COLS + 2 * lane;
  const long long per = (S + chunks - 1) / chunks, r0 = ch * per, r1 = min(S, r0 + per);
  float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
  if (MOMENTS && c < ld) {
    for (long long r = r0 + warp; r < r1; r += NT / 32) {
      const float2 yv = load2(y + ((long long)b * S + r) * ld + c);
      s0.x += yv.x, s0.y += yv.x * yv.x;
      s1.x += yv.y, s1.y += yv.y * yv.y;
    }
  } else if (c < ld) {  // ld is a multiple of 8: c + 1 < ld too
    const float4 f0 = cf[(long long)b * ld + c], f1 = cf[(long long)b * ld + c + 1];
    for (long long r = r0 + warp; r < r1; r += NT / 32) {
      const long long at = ((long long)b * S + r) * ld + c;
      const float2 yv = load2(y + at), gv = load2(gup + at);
      float du0, yh0, du1, yh1;
      gn_terms(yv.x, gv.x, f0, &du0, &yh0);
      gn_terms(yv.y, gv.y, f1, &du1, &yh1);
      s0.x += du0, s0.y += du0 * yh0, s0.z += yh0, s0.w += gv.x;
      s1.x += du1, s1.y += du1 * yh1, s1.z += yh1, s1.w += gv.y;
    }
  }
  red[warp][2 * lane] = s0;
  red[warp][2 * lane + 1] = s1;
  __syncthreads();
  if (warp == 0 && c < ld) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float4 t = red[0][2 * lane + e];
      for (int w = 1; w < NT / 32; ++w) {
        const float4 v = red[w][2 * lane + e];
        t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
      }
      part[(long long)blockIdx.x * ld + c + e] = t;
    }
  }
}

// stats[b][g] = (sum of y, of y^2) over sample b's pixels and group g's
// channels (< C), from gn_part_kernel<MOMENTS>'s partials in float64: a
// warp a group, lane l adding the (chunk, channel) pairs l, l + 32, ... and
// the lanes' sums added by a fixed shuffle tree. Grid: B blocks.
__global__ void __launch_bounds__(NT) gn_moments_kernel(const float4* __restrict__ part,
                                                       int chunks, double* __restrict__ stats,
                                                       int groups, int C, int ld) {
  const int b = blockIdx.x, cg = C / groups, lane = threadIdx.x & 31;
  for (int gi = threadIdx.x >> 5; gi < groups; gi += NT / 32) {
    double s = 0.0, ss = 0.0;
    for (int i = lane; i < chunks * cg; i += 32) {
      const float4 v = part[((long long)b * chunks + i / cg) * ld + gi * cg + i % cg];
      s += v.x;
      ss += v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      stats[((long long)b * groups + gi) * 2] = s;
      stats[((long long)b * groups + gi) * 2 + 1] = ss;
    }
  }
}

// One block a sample b (see above). sums (B, ld): first the chunks' sums,
// then the terms gn_channel_kernel adds: (k Q, k A, sum of dy, G).
__global__ void __launch_bounds__(NT) gn_group_kernel(const float4* __restrict__ part, int chunks,
                                                     const float4* __restrict__ cf, GNIn gn,
                                                     float4* __restrict__ bc,
                                                     Sum4* __restrict__ sums,
                                                     float* __restrict__ dfilm, int C, int ld,
                                                     long long S) {
  __shared__ float2 gm[MAXG];
  const int b = blockIdx.x, cg = C / gn.groups;
  Sum4* sb = sums + (long long)b * ld;
  for (int c = threadIdx.x; c < ld; c += NT) {
    Sum4 t{0.0, 0.0, 0.0, 0.0};
    for (int ch = 0; ch < chunks; ++ch) {
      const float4 v = part[((long long)b * chunks + ch) * ld + c];
      t.a += v.x, t.q += v.y, t.y += v.z, t.g += v.w;
    }
    sb[c] = t;
  }
  __syncthreads();
  const double n = (double)S * cg;
  for (int gi = threadIdx.x; gi < gn.groups; gi += NT) {
    double m1 = 0.0, m2 = 0.0;
    for (int c = gi * cg; c < (gi + 1) * cg; ++c) {
      const double sk = cf[(long long)b * ld + c].z;
      m1 += sk * sb[c].a;
      m2 += sk * sb[c].q;
    }
    gm[gi] = make_float2((float)(m1 / n), (float)(m2 / n));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ld; c += NT) {
    if (c >= C) {
      bc[(long long)b * ld + c] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4 f = cf[(long long)b * ld + c];
    const float2 m = gm[c / cg];
    const float4 k4 = make_float4(f.y * f.z, -f.y * m.x, -f.y * m.y, 0.f);
    bc[(long long)b * ld + c] = k4;
    const Sum4 t = sb[c];
    const double k = gn.film != nullptr ? (double)gn.film[(long long)b * 2 * C + c] + 1.0 : 1.0;
    if (dfilm != nullptr) {
      dfilm[(long long)b * 2 * C + c] = (float)(gn.scale[c] * t.q + gn.bias[c] * t.a);
      dfilm[(long long)b * 2 * C + C + c] = (float)t.a;
    }
    sb[c] = Sum4{k * t.q, k * t.a, k4.x * t.a + (double)S * k4.y + k4.z * t.y, t.g};
  }
}

// Per channel c < C, the samples' terms added in order: dscale, dbias, the
// conv bias's gradient db and (dbres not null) the residual bias's.
__global__ void __launch_bounds__(NT) gn_channel_kernel(const Sum4* __restrict__ sums,
                                                       float* __restrict__ dscale,
                                                       float* __restrict__ dbias,
                                                       float* __restrict__ db,
                                                       float* __restrict__ dbres, int B, int C,
                                                       int ld) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C; c += gridDim.x * blockDim.x) {
    Sum4 t{0.0, 0.0, 0.0, 0.0};
    for (int b = 0; b < B; ++b) {
      const Sum4 v = sums[(long long)b * ld + c];
      t.a += v.a, t.q += v.q, t.y += v.y, t.g += v.g;
    }
    dscale[c] = (float)t.a;
    dbias[c] = (float)t.q;
    db[c] = (float)t.y;
    if (dbres != nullptr) dbres[c] = (float)t.g;
  }
}

// dy (B S, ld) bf16 = bc.x du + bc.y + bc.z yhat, two channels a thread; the
// pad channels' coefficients are zero, so are they.
template <typename G>
__global__ void __launch_bounds__(NT) gn_dy_kernel(const float* __restrict__ y,
                                                  const G* __restrict__ gup,
                                                  const float4* __restrict__ cf,
                                                  const float4* __restrict__ bc,
                                                  uint32_t* __restrict__ dy, int ld, long long S,
                                                  long long pairs) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;
    const int c = (int)(e % ld), b = (int)(e / (S * ld));
    const long long at = (long long)b * ld + c;
    const float2 yv = load2(y + e), gv = load2(gup + e);
    float du0, yh0, du1, yh1;
    gn_terms(yv.x, gv.x, cf[at], &du0, &yh0);
    gn_terms(yv.y, gv.y, cf[at + 1], &du1, &yh1);
    const float4 k0 = bc[at], k1 = bc[at + 1];
    dy[i] = pack_bf16(k0.x * du0 + k0.y + k0.z * yh0, k1.x * du1 + k1.y + k1.z * yh1);
  }
}

// One GroupNorm stage's backward: the four launches above.
template <typename G>
cudaError_t gn_stage_bwd(const float* y, const G* gup, const float4* cf, const GNIn& gn,
                         float4* part, Sum4* sums, float4* bc, float* dscale, float* dbias,
                         float* db, float* dbres, float* dfilm, bf16* dy, int B, int C, int ld,
                         long long S, int chunks, cudaStream_t stream) {
  gn_part_kernel<G><<<dim3(B * chunks, (ld + PART_COLS - 1) / PART_COLS), NT, 0, stream>>>(
      y, gup, cf, part, ld, S, chunks);
  gn_group_kernel<<<B, NT, 0, stream>>>(part, chunks, cf, gn, bc, sums, dfilm, C, ld, S);
  gn_channel_kernel<<<grid_of(C), NT, 0, stream>>>(sums, dscale, dbias, db, dbres, B, C, ld);
  const long long pairs = S * B * ld / 2;
  gn_dy_kernel<G><<<grid_of(pairs), NT, 0, stream>>>(y, gup, cf, bc,
                                                     reinterpret_cast<uint32_t*>(dy), ld, S,
                                                     pairs);
  return cudaGetLastError();
}

// The recompute's GroupNorm statistics stats (B, groups, 2) of y (B S, ld),
// summed in a fixed order.
cudaError_t moments(const float* y, float4* part, double* stats, int B, int groups, int C, int ld,
                    long long S, int chunks, cudaStream_t stream) {
  gn_part_kernel<float, true><<<dim3(B * chunks, (ld + PART_COLS - 1) / PART_COLS), NT, 0,
                                 stream>>>(y, y, nullptr, part, ld, S, chunks);
  gn_moments_kernel<<<B, NT, 0, stream>>>(part, chunks, stats, groups, C, ld);
  return cudaGetLastError();
}

// dx (B S, Cin) bf16 = dx1 + (dres or g), rounded once: dx1 and dres of row
// stride Kin (float32), g of N (bf16).
__global__ void __launch_bounds__(NT) dx_kernel(const float* __restrict__ dx1,
                                               const float* __restrict__ dres,
                                               const bf16* __restrict__ g, bf16* __restrict__ dx,
                                               int Cin, int Kin, int N, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / Cin;
    const int c = (int)(i - p * Cin);
    const float r = dres != nullptr ? dres[p * Kin + c] : __bfloat162float(g[p * N + c]);
    dx[i] = __float2bfloat16(dx1[p * Kin + c] + r);
  }
}

// part (splits, taps, Kin, N) float32, the gradient products' partials ->
// out (Cout, Cin, taps), PyTorch's Conv layout with (kh, kw) flattened: the
// splits added in order, then tap_major_kernel's transpose undone through a
// 32 x 32 tile. Grid: (ceil(Cin taps / 32), ceil(Cout / 32)) of 32 x 8.
__global__ void __launch_bounds__(NT) conv_layout_kernel(const float* __restrict__ part,
                                                        int splits, float* __restrict__ out,
                                                        int Cout, int Cin, int taps, int Kin,
                                                        int N) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x;
  const long long stride = (long long)taps * Kin * N;
  for (int i = threadIdx.y; i < 32; i += 8) {  // rows (tap, ci) of part, n along them
    const int k = k0 + i, n = n0 + tx, ci = k / taps, tap = k % taps;
    float s = 0.f;
    if (ci < Cin && n < Cout) {
      const float* p = part + ((long long)tap * Kin + ci) * N + n;
      for (int z = 0; z < splits; ++z) s += p[z * stride];
    }
    tile[i][tx] = s;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {  // rows n of out, k = ci taps + tap along them
    const int n = n0 + i, k = k0 + tx;
    if (n < Cout && k < Cin * taps) out[(long long)n * Cin * taps + k] = tile[tx][i];
  }
}

cudaError_t conv_layout(const float* part, int splits, float* out, int Cout, int Cin, int taps,
                        int Kin, int N, cudaStream_t stream) {
  const dim3 grid((Cin * taps + 31) / 32, (Cout + 31) / 32), block(32, 8);
  conv_layout_kernel<<<grid, block, 0, stream>>>(part, splits, out, Cout, Cin, taps, Kin, N);
  return cudaGetLastError();
}

// Kernel 7's scratch, carved from one buffer in this order, each region
// 256-byte aligned (its size: the resnet_bwd_scratch_bytes query below): the
// tap-major bf16 weights w1 (9, Kin, N), w2 (9, N, N), wres (1, Kin, N); the
// float32 vectors (7, N) followed by FiLM (B, 2 C); y1 (P, N) float32, a1
// (P, N) bf16, y2 (P, N) float32 (then dh1), dy (P, N) bf16 (dy2, then dy1),
// dx1 and dres (P, Kin) float32; the float64 statistics (2, B, G, 2); the
// float2 coefficients (B, N); cf (2, B, N) and bc (B, N) float4; the sums
// (B, N) Sum4; the GroupNorm partials (B chunks, N) float4; the gradient
// products' partials, the largest of the three: splits1 (9, Kin, N),
// splits2 (9, N, N), splits_r (1, Kin, N) float32.
struct BwdScratch {
  size_t w1, w2, wr, vec, y1, a1, y2, dy, dx1, dres, stats, coef, cf, bc, sums, part, wpart, total;
  BwdScratch(int B, long long P, int Kin, int N, int C, int groups, bool res, bool has_film,
             int splits1, int splits2, int splits_r, int chunks) {
    size_t at = 0;
    auto take = [&at](size_t bytes) {
      const size_t off = at;
      at += (bytes + 255) / 256 * 256;
      return off;
    };
    const size_t kn = (size_t)Kin * N, nn = (size_t)N * N;
    w1 = take(9 * kn * 2);
    w2 = take(9 * nn * 2);
    wr = take(res ? kn * 2 : 0);
    vec = take((7ull * N + (has_film ? 2ull * B * C : 0)) * 4);
    y1 = take((size_t)P * N * 4);
    a1 = take((size_t)P * N * 2);
    y2 = take((size_t)P * N * 4);
    dy = take((size_t)P * N * 2);
    dx1 = take((size_t)P * Kin * 4);
    dres = take(res ? (size_t)P * Kin * 4 : 0);
    stats = take(4ull * B * groups * 8);
    coef = take((size_t)B * N * 8);
    cf = take(2ull * B * N * 16);
    bc = take((size_t)B * N * 16);
    sums = take((size_t)B * N * sizeof(Sum4));
    part = take((size_t)B * chunks * N * 16);
    size_t wmost = splits1 * 9 * kn;
    if (splits2 * 9 * nn > wmost) wmost = splits2 * 9 * nn;
    if (res && splits_r * kn > wmost) wmost = splits_r * kn;
    wpart = take(wmost * 4);
    total = at;
  }
};

int block_bwd_wgmma(const bf16* x, const bf16* g, const void* w1raw, const void* w2raw,
                    const void* wresraw, int wdtype, const Vecs& vecs, int vdtype,
                    const void* filmraw, int fdtype, uint8_t* scratch, long long scratch_bytes,
                    bf16* dx, float* grads, int B, int F, int H, int W, int Cin, int Cout,
                    int Kin, int N, int groups, float eps, int stages1, int stages2, int bn,
                    int splits1, int splits2, int splits_r, int chunks, cudaStream_t stream) {
  const long long S = (long long)F * H * W, Pl = S * B;
  const bool res = wresraw != nullptr, has_film = filmraw != nullptr;
  if (groups > MAXG || Cout % groups || Kin % 8 || N % 8 || Cout > N || Cin > Kin ||
      Pl >= (1LL << 31) - GM || !aligned16(x) || !aligned16(g) || (!res && Kin != N) ||
      (wdtype != 0 && wdtype != 1) || (vdtype != 0 && vdtype != 1) ||
      (has_film && fdtype != 0 && fdtype != 1) || splits1 < 1 || splits2 < 1 || splits_r < 1 ||
      chunks < 1)
    return (int)cudaErrorInvalidValue;
  const BwdScratch sc(B, Pl, Kin, N, Cout, groups, res, has_film, splits1, splits2, splits_r,
                      chunks);
  if ((long long)sc.total != scratch_bytes) return (int)cudaErrorInvalidValue;
  const int P = (int)Pl;
  auto at = [scratch](size_t off) { return scratch + off; };
  bf16* w1 = reinterpret_cast<bf16*>(at(sc.w1));
  bf16* w2 = reinterpret_cast<bf16*>(at(sc.w2));
  bf16* wres = reinterpret_cast<bf16*>(at(sc.wr));
  float* vec = reinterpret_cast<float*>(at(sc.vec));
  const float* film = has_film ? vec + 7 * N : nullptr;
  float* y1 = reinterpret_cast<float*>(at(sc.y1));
  bf16* a1 = reinterpret_cast<bf16*>(at(sc.a1));
  float* y2 = reinterpret_cast<float*>(at(sc.y2));
  float* dh1 = y2;  // y2 is read for the last time by GN2's dy pass
  bf16* dy = reinterpret_cast<bf16*>(at(sc.dy));
  float* dx1 = reinterpret_cast<float*>(at(sc.dx1));
  float* dres = res ? reinterpret_cast<float*>(at(sc.dres)) : nullptr;
  double* stats = reinterpret_cast<double*>(at(sc.stats));
  float2* coef = reinterpret_cast<float2*>(at(sc.coef));
  float4* cf1 = reinterpret_cast<float4*>(at(sc.cf));
  float4* cf2 = cf1 + (long long)B * N;
  float4* bc = reinterpret_cast<float4*>(at(sc.bc));
  Sum4* sums = reinterpret_cast<Sum4*>(at(sc.sums));
  float4* part = reinterpret_cast<float4*>(at(sc.part));
  float* wpart = reinterpret_cast<float*>(at(sc.wpart));
  const float *b1 = vec, *b2 = vec + N, *g1s = vec + 2 * N, *g1b = vec + 3 * N,
              *g2s = vec + 4 * N, *g2b = vec + 5 * N;
  // the gradients, in the caller's one float32 buffer (resnet_block_bwd_wgmma)
  float* dw1 = grads;
  float* dw2 = dw1 + 9LL * Cout * Cin;
  float* dwres = dw2 + 9LL * Cout * Cout;
  float* dvec = dwres + (res ? (long long)Cout * Cin : 0);
  float *db1 = dvec, *dg1s = dvec + Cout, *dg1b = dvec + 2 * Cout, *db2 = dvec + 3 * Cout,
        *dg2s = dvec + 4 * Cout, *dg2b = dvec + 5 * Cout;
  float* dbres = res ? dvec + 6 * Cout : nullptr;
  float* dfilm = has_film ? dvec + (res ? 7 : 6) * Cout : nullptr;

  // 0. the operands: tap-major bf16 weights, float32 vectors and FiLM, zero sums
  cudaError_t err = tap_major(wdtype, w1raw, w1, Cout, Cin, 9, Kin, N, stream);
  if (err == cudaSuccess) err = tap_major(wdtype, w2raw, w2, Cout, Cout, 9, N, N, stream);
  if (err == cudaSuccess && res)
    err = tap_major(wdtype, wresraw, wres, Cout, Cin, 1, Kin, N, stream);
  if (err != cudaSuccess) return (int)err;
  const int filmn = has_film ? 2 * B * Cout : 0;
  vec_kernel<<<grid_of(7LL * N + filmn), NT, 0, stream>>>(vecs, vdtype, filmraw, fdtype, vec, Cout,
                                                         N, filmn);
  CUtensorMap m1, m2;
  int code = weight_map(&m1, w1, Kin, N);
  if (code == 0) code = weight_map(&m2, w2, N, N);
  if (code != 0) return code;
  double* stats1 = stats;
  double* stats2 = stats + 2 * B * groups;
  const GNIn gn1{stats1, g1s, g1b, film, groups, eps}, gn2{stats2, g2s, g2b, nullptr, groups, eps};
  const int rows = (P + GM - 1) / GM, cols = (N + bn - 1) / bn;
  // 1. the forward again on kernel 3's convs: y1, a1, y2 and both stages'
  // coefficients; the GroupNorm statistics summed in order (kernel 3 adds
  // them by atomics), so that every gradient repeats bit for bit
  err = conv_gn(stages1, bn, rows, cols, stream, m1, m1, x, b1, y1, nullptr, nullptr, nullptr, P,
                H, W, Kin, N, Cout, groups, (int)S, cols);
  if (err == cudaSuccess) err = moments(y1, part, stats1, B, groups, Cout, N, S, chunks, stream);
  if (err != cudaSuccess) return (int)err;
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn1, coef, cf1, B, Cout, N, S);
  const long long total4 = Pl * N / 4;
  gn_act_kernel<<<grid_of(total4), NT, 0, stream>>>(reinterpret_cast<const float4*>(y1), coef,
                                                    reinterpret_cast<uint2*>(a1), N, S, total4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = conv_gn(stages2, bn, rows, cols, stream, m2, m2, a1, b2, y2, nullptr, nullptr, nullptr, P,
                H, W, N, N, Cout, groups, (int)S, cols);
  if (err == cudaSuccess) err = moments(y2, part, stats2, B, groups, Cout, N, S, chunks, stream);
  if (err != cudaSuccess) return (int)err;
  gn_coef_kernel<<<grid_of((long long)B * N), NT, 0, stream>>>(gn2, coef, cf2, B, Cout, N, S);
  // 2. GN2 + SiLU backward: dscale2, dbias2, db2 (and dbres), dy2
  err = gn_stage_bwd<bf16>(y2, g, cf2, gn2, part, sums, bc, dg2s, dg2b, db2, dbres, nullptr, dy, B,
                           Cout, N, S, chunks, stream);
  if (err != cudaSuccess) return (int)err;
  // 3. conv2's gradients: dh1 (float32) and dW2
  if ((code = bwd_products<9>(dy, a1, w2, dh1, wpart, P, H, W, N, N, splits2, stream)) != 0)
    return code;
  if ((err = conv_layout(wpart, splits2, dw2, Cout, Cout, 9, N, N, stream)) != cudaSuccess)
    return (int)err;
  // 4. GN1 + FiLM + SiLU backward: dscale1, dbias1, db1, dFiLM, dy1
  err = gn_stage_bwd<float>(y1, dh1, cf1, gn1, part, sums, bc, dg1s, dg1b, db1, nullptr, dfilm, dy,
                            B, Cout, N, S, chunks, stream);
  if (err != cudaSuccess) return (int)err;
  // 5. conv1's gradients: dx1 (float32) and dW1
  if ((code = bwd_products<9>(dy, x, w1, dx1, wpart, P, H, W, Kin, N, splits1, stream)) != 0)
    return code;
  if ((err = conv_layout(wpart, splits1, dw1, Cout, Cin, 9, Kin, N, stream)) != cudaSuccess)
    return (int)err;
  // 6. the residual projection's 1 x 1 products: dres = g Wres^T, dWres = x^T g
  if (res) {
    if ((code = bwd_products<1>(g, x, wres, dres, wpart, P, H, W, Kin, N, splits_r, stream)) != 0)
      return code;
    if ((err = conv_layout(wpart, splits_r, dwres, Cout, Cin, 1, Kin, N, stream)) != cudaSuccess)
      return (int)err;
  }
  // 7. dx = bf16(dx1 + (dres or g)), one rounding
  dx_kernel<<<grid_of(Pl * Cin), NT, 0, stream>>>(dx1, dres, g, dx, Cin, Kin, N, Pl * Cin);
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

// Kernel 7 in float32 (the check path; bf16 takes resnet_block_bwd_wgmma):
// the gradients of resnet_block given x and the output's cotangent gout.
// w1f, w2f: the conv weights flipped in (kh, kw) and transposed to (Cin',
// Cout'), the layout of the dgrad convs; wresf (Cin, Cout) or null. Scratch:
// y1, y2, a1, dy2, da1, dy1 of the output's shape, dx1 and dres (with wresf)
// of x's, stats (2, B, groups, 2) and sums (2, B, Cout, 2) float64 zeroed by
// the caller, coef (2, B, groups, 2), part_w and part_b large enough for the
// largest of the three weight-gradient splits. Cout <= 256. Gradients of the
// float operands are float32; dfilm (B, 2 Cout) or null.
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: resnet_block_bwd_wgmma
  return block_bwd<float>(
      (const float*)x, (const float*)gout, (const float*)w1, (const float*)w1f, b1, g1s, g1b, film,
      (const float*)w2, (const float*)w2f, b2, g2s, g2b, (const float*)wresf, (float*)y1,
      (float*)y2, (float*)a1, (float*)dy2, (float*)da1, (float*)dy1, (float*)dx1, (float*)dres,
      stats, sums, coef, part_w, part_b, (float*)dx, dw1, db1, dg1s, dg1b, dfilm, dw2, db2, dg2s,
      dg2b, dwres, dbres, B, F, H, W, Cin, Cout, groups, eps, splits1, splits2, splits_res,
      (cudaStream_t)stream);
}

// Kernel 7 in bf16 on the conv engine. x (B, F, H, W, Kin) and g (B, F, H,
// W, N) bf16, the channels past Cin and Cout zero (Kin, N: Cin and Cout
// rounded up to multiples of 8); the block's parameters as the caller holds
// them, as for resnet_block_wgmma (bres is not needed). scratch:
// scratch_bytes of device memory (resnet_bwd_scratch_bytes). dx (B, F, H, W,
// Cin) bf16; grads: one float32 buffer of dw1 (Cout, Cin, 3, 3), dw2 (Cout,
// Cout, 3, 3), dwres (Cout, Cin) with wres, then db1, dg1s, dg1b, db2, dg2s,
// dg2b and, with wres, dbres (Cout each), then dfilm (B, 2 Cout) with film.
// stages1, stages2, bn: the recompute's rings and tile width (as kernel 3's);
// splits1, splits2, splits_r: the pixel splits of dW1, dW2 and dWres;
// chunks: the pixel chunks of a sample in the GroupNorm sums
// (fused_resnet.resnet_bwd_plan).
extern "C" int resnet_block_bwd_wgmma(const void* x, const void* g, const void* w1, const void* w2,
                                      const void* wres, int wdtype, const void* b1,
                                      const void* g1s, const void* g1b, const void* b2,
                                      const void* g2s, const void* g2b, int vdtype,
                                      const void* film, int fdtype, void* scratch,
                                      long long scratch_bytes, void* dx, float* grads, int B,
                                      int F, int H, int W, int Cin, int Cout, int Kin, int N,
                                      int groups, float eps, int stages1, int stages2, int bn,
                                      int splits1, int splits2, int splits_r, int chunks,
                                      void* stream) {
  if ((long long)B * F * H * W == 0) return 0;
  const Vecs vecs{{b1, b2, g1s, g1b, g2s, g2b, nullptr}};
  return block_bwd_wgmma((const bf16*)x, (const bf16*)g, w1, w2, wres, wdtype, vecs, vdtype, film,
                         fdtype, (uint8_t*)scratch, scratch_bytes, (bf16*)dx, grads, B, F, H, W,
                         Cin, Cout, Kin, N, groups, eps, stages1, stages2, bn, splits1, splits2,
                         splits_r, chunks, (cudaStream_t)stream);
}

// Bytes of the scratch resnet_block_bwd_wgmma takes for B samples of P
// pixels, Kin -> N padded channels (C real output channels), with the
// residual projection (res) and FiLM (film) or without, and the plan's
// splits and chunks; -1 for no block.
extern "C" long long resnet_bwd_scratch_bytes(int B, long long P, int Kin, int N, int C,
                                              int groups, int res, int film, int splits1,
                                              int splits2, int splits_r, int chunks) {
  if (B < 1 || P < 0 || Kin < 1 || N < 1 || C < 1 || C > N || groups < 1 || splits1 < 1 ||
      splits2 < 1 || splits_r < 1 || chunks < 1)
    return -1;
  return (long long)BwdScratch(B, P, Kin, N, C, groups, res != 0, film != 0, splits1, splits2,
                               splits_r, chunks)
      .total;
}
