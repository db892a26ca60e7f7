// Bilinear NHWC grid sample, align_corners=True, zeros/border/reflection
// padding (kernel 4), and its backward (kernel 8).
//
// Replaces extdm_tpu/ops/pallas_warp.py grid_sample (_grid_sample_impl ->
// _make_kernel) and _grid_sample_bwd_impl (_make_bwd_kernel), which build a
// one-hot (pixels x H*W) weight matrix and contract it on the TPU's matrix
// unit because the TPU has no fast gather or scatter. Hopper gathers and
// scatters directly, so no such matrix exists here.
//
// Bound on the H100: bytes (image, grid and output once; a few flops per
// element). What held the first design back was instructions: one thread
// per output element recomputed the pixel's coordinates, fold and corner
// offsets for every channel, with 64-bit divisions, and read each corner as
// one 2- or 4-byte load. Here a block takes a tile of output pixels
// (tile_h x tile_w, a power-of-two width, ragged at the image's edge):
//   1. one thread per pixel computes its coordinates, padding fold, four
//      clamped corners, four weights and validity once, into shared memory;
//   2. the block then streams the tile's channels in vectors of V elements
//      (16 bytes where C x element size and the operands' alignment allow,
//      narrower otherwise: the launch plan, ops/fused_warp.py
//      grid_sample_plan, picks V).
// Indices within a sample are 32-bit; each sample's base is 64-bit (an
// evaluation batch of 100 trajectories passes 2^31 bytes).
//
// NaN coordinates: a NaN grid point reads pixel 0 (fmaxf drops the NaN in
// the clamp of each corner index) and gives a NaN output and NaN
// contributions through its weights, as ops/warp.py does. So weights are
// never masked by multiplying them away: an invalid corner's weight is
// w * 0, which stays NaN, and the border clamp keeps a NaN coordinate.
#include "common.cuh"

constexpr int GS_THREADS = 256;

// ------------------------------------------------------------- coordinates
// Reflect a pixel coordinate into [0, size - 1] with period 2 (size - 1), as
// min(mod(x, span), span - mod(x, span)); *dc is its derivative as the TPU
// kernel takes it (pallas_warp.py _make_bwd_kernel): +1 where the first is
// smaller, else -1 (the fold itself included), 0 for size 1.
__device__ __forceinline__ float reflect_coord(float x, int size, float* dc) {
  if (size == 1) {
    *dc = 0.f;
    return 0.f;
  }
  const float span = 2.f * (float)(size - 1);
  float r = fmodf(x, span);
  if (r < 0.f) r += span;  // floored modulo, as jnp.mod and torch.remainder
  const float o = span - r;
  *dc = r < o ? 1.f : -1.f;
  return r < o ? r : o;  // NaN stays NaN
}

// The padding mode's fold of an unnormalised coordinate and its derivative
// (mode 0 zeros, 1 border, 2 reflection). The border clamp keeps NaN, as
// torch.clamp and jnp.clip do, and passes the gradient strictly inside
// (0, size - 1), as the TPU kernel does: 0 at the bounds. The plain
// version's autograd differs on these lines (ops/warp.py
// grid_sample_dgrid_plain states the TPU kernel's rules in plain torch).
__device__ __forceinline__ float fold_coord(float x, int size, int mode, float* dc) {
  if (mode == 2) return reflect_coord(x, size, dc);
  if (mode == 1) {
    const float hi = (float)(size - 1);
    *dc = (x > 0.f && x < hi) ? 1.f : 0.f;
    return x < 0.f ? 0.f : (x > hi ? hi : x);
  }
  *dc = 1.f;
  return x;
}

// One output pixel's bilinear footprint. Corners in the order (x0, y0),
// (x0+1, y0), (x0, y0+1), (x0+1, y0+1).
struct Footprint {
  int xc[4], yc[4];  // clamped corner indices (a NaN coordinate gives 0)
  float w[4];        // weights; an invalid corner's is w * 0 (NaN stays NaN)
  bool valid[4];     // the corner lies in the image
  float wx, wy;      // the lerp fractions
  float dcx, dcy;    // the fold's derivatives
};

__device__ __forceinline__ Footprint footprint(float gx, float gy, int H, int W, int mode) {
  Footprint f;
  float x = (gx + 1.f) * 0.5f * (float)(W - 1);
  float y = (gy + 1.f) * 0.5f * (float)(H - 1);
  x = fold_coord(x, W, mode, &f.dcx);
  y = fold_coord(y, H, mode, &f.dcy);
  const float x0 = floorf(x), y0 = floorf(y);
  f.wx = x - x0;
  f.wy = y - y0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cx = x0 + (float)(k & 1), cy = y0 + (float)(k >> 1);
    // out of range, a corner reads and scatters nothing in every mode, as
    // the TPU kernel's one-hot corners match no pixel: after a border or
    // reflection fold only x0 + 1 = W (or y0 + 1 = H) at x = W - 1 is, whose
    // weight is 0, so only d_grid sees it
    f.valid[k] = cx >= 0.f && cx <= (float)(W - 1) && cy >= 0.f && cy <= (float)(H - 1);
    f.xc[k] = (int)fminf(fmaxf(cx, 0.f), (float)(W - 1));
    f.yc[k] = (int)fminf(fmaxf(cy, 0.f), (float)(H - 1));
    const float w = ((k & 1) ? f.wx : 1.f - f.wx) * ((k >> 1) ? f.wy : 1.f - f.wy);
    f.w[k] = f.valid[k] ? w : w * 0.f;
  }
  return f;
}

// --------------------------------------------------------------- vectors
// V consecutive elements of T as one load or store of V * sizeof(T) bytes,
// converted to and from float.
template <typename T, int V> struct Vec;

template <int V> struct Vec<float, V> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[V]) {
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x, f[1] = v.y;
    } else {
      f[0] = *p;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[V]) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  }
};

template <int V> struct Vec<bf16, V> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[V]) {
    if constexpr (V == 1) {
      f[0] = __bfloat162float(*p);
    } else {
      uint32_t u[V / 2];
      if constexpr (V == 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
      } else if constexpr (V == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        u[0] = v.x, u[1] = v.y;
      } else {
        u[0] = *reinterpret_cast<const uint32_t*>(p);
      }
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[V]) {
    if constexpr (V == 1) {
      *p = __float2bfloat16(f[0]);
    } else {
      uint32_t u[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i) u[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
      if constexpr (V == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = u[0];
      }
    }
  }
};

// V floats added to global memory by vector reductions (red.global.add.v4.f32
// and .v2 on sm_90): p is aligned to min(V, 4) floats.
template <int V> __device__ __forceinline__ void red_add(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(p) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// ------------------------------------------------------------- tile geometry
struct Geometry {
  int H, W, C, Ho, Wo, mode;
  int tile_h, tw_shift;  // tile rows; log2 of its (power-of-two) width
  int tiles_x, tiles_per_sample;
};

// The block's sample and the output row and column of its tile's corner.
__device__ __forceinline__ void tile_origin(const Geometry& g, int* b, int* oy, int* ox) {
  const int t = (int)(blockIdx.x % (unsigned)g.tiles_per_sample);
  *b = (int)(blockIdx.x / (unsigned)g.tiles_per_sample);
  const int ty = t / g.tiles_x;
  *oy = ty * g.tile_h;
  *ox = (t - ty * g.tiles_x) << g.tw_shift;
}

// j / n for 0 <= j < 2^24 (the plan keeps a tile's vectors below that),
// from a float estimate corrected by one step either way.
__device__ __forceinline__ int div_small(int j, int n, float inv) {
  int q = (int)((float)j * inv);
  if (q * n > j) --q;
  else if ((q + 1) * n <= j) ++q;
  return q;
}

// ------------------------------------------------------------------ forward
// A pixel's four corner offsets within its sample (pixel * C) and weights.
struct __align__(16) FwdPixel {
  int4 off;
  float4 w;
};
constexpr int FWD_PIXEL_BYTES = 32;
static_assert(sizeof(FwdPixel) == FWD_PIXEL_BYTES, "FwdPixel layout");

template <typename T, int V>
__global__ void __launch_bounds__(GS_THREADS) grid_sample_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, T* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdPixel* px = reinterpret_cast<FwdPixel*>(smem);
  const int tw = 1 << g.tw_shift, tp = g.tile_h * tw;
  int b, oy, ox;
  tile_origin(g, &b, &oy, &ox);
  const T* src = img + (long long)b * g.H * g.W * g.C;
  const long long first = (long long)b * g.Ho * g.Wo;  // the sample's first output pixel
  for (int p = threadIdx.x; p < tp; p += GS_THREADS) {
    const int yo = oy + (p >> g.tw_shift), xo = ox + (p & (tw - 1));
    FwdPixel r = {make_int4(0, 0, 0, 0), make_float4(0.f, 0.f, 0.f, 0.f)};
    if (yo < g.Ho && xo < g.Wo) {
      const float* gp = grid + 2 * (first + yo * g.Wo + xo);
      const Footprint f = footprint(gp[0], gp[1], g.H, g.W, g.mode);
      r.off = make_int4((f.yc[0] * g.W + f.xc[0]) * g.C, (f.yc[1] * g.W + f.xc[1]) * g.C,
                        (f.yc[2] * g.W + f.xc[2]) * g.C, (f.yc[3] * g.W + f.xc[3]) * g.C);
      r.w = make_float4(f.w[0], f.w[1], f.w[2], f.w[3]);
    }
    px[p] = r;
  }
  __syncthreads();
  // (pixel, vector) pairs, channel fastest: neighbouring threads read
  // neighbouring vectors of one corner row and write neighbouring outputs.
  T* dst = out + first * g.C;
  const int nv = g.C / V, total = tp * nv;
  const float inv = 1.f / (float)nv;
  for (int j = threadIdx.x; j < total; j += GS_THREADS) {
    const int p = nv == 1 ? j : div_small(j, nv, inv);
    const int yo = oy + (p >> g.tw_shift), xo = ox + (p & (tw - 1));
    if (yo >= g.Ho || xo >= g.Wo) continue;
    const int c = (j - p * nv) * V;
    const FwdPixel r = px[p];
    float a[V], acc[V];
    Vec<T, V>::load(src + r.off.x + c, a);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = r.w.x * a[i];
    Vec<T, V>::load(src + r.off.y + c, a);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(r.w.y, a[i], acc[i]);
    Vec<T, V>::load(src + r.off.z + c, a);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(r.w.z, a[i], acc[i]);
    Vec<T, V>::load(src + r.off.w + c, a);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(r.w.w, a[i], acc[i]);
    Vec<T, V>::store(dst + (yo * g.Wo + xo) * g.C + c, acc);
  }
}

// ----------------------------------------------------------------- backward
// Gradients of the sample above for the cotangent dout (B, Ho, Wo, C):
//   d_image (B, H, W, C) float32: each output adds w_corner * dout into the
//     corners it read (the entry zero-fills d_image first);
//   d_grid (B, Ho, Wo, 2) float32: per output pixel, the sum over channels of
//     dout * d(bilinear)/d(x, y), times the fold's derivative and
//     0.5 * (size - 1).
// Either pointer may be null, and then that output is not computed.
//
// One block a tile of output pixels, as the forward. Phase 1 writes each
// pixel's footprint to shared memory once. Phase 2: a group of `lanes`
// threads (a power of two up to 32) takes a pixel, its lanes stride over
// the channels in vectors of V and read dout once a vector; for d_grid they
// read the four corner rows with vector loads and sum in order, and the
// group adds its lanes with xor shuffles in a fixed order, which depends
// only on the plan, so d_grid repeats bit for bit; for d_image each lane
// adds w * dout for each corner it scatters into (a valid corner, or one
// whose weight is NaN) with vector global reductions (red.global.add.v4.f32
// and .v2). The order of those reductions varies from run to run, and with
// it d_image below float32 resolution. With one lane a pixel and no d_image
// (the LFAE's K+1 sparse warp, C = 3), each thread instead runs its pixel
// from the grid to d_grid, with no shared memory or barrier.
struct __align__(16) BwdPixel {
  int4 xy;        // each corner's (yc << 16) | xc, clamped
  float4 w;       // the corners' weights (an invalid corner's: w * 0)
  float wx, wy;   // the lerp fractions
  float sx, sy;   // the fold's derivative times 0.5 (size - 1)
  int flags;      // bit k: corner k valid (read); bit 4 + k: corner k scattered
  int opix;       // the output pixel within its sample, -1 past the edge
  int pad[2];
};
constexpr int BWD_PIXEL_BYTES = 64;
static_assert(sizeof(BwdPixel) == BWD_PIXEL_BYTES, "BwdPixel layout");

// d_grid's terms of V channels at c: dout * d(bilinear)/dx and /dy, summed
// into gx and gy in channel order; corners not valid read as 0.
template <typename T, int V>
__device__ __forceinline__ void dgrid_terms(const T* src, const int (&gpix)[4], int flags,
                                            float wx, float wy, const float (&go)[V], int c,
                                            float& gx, float& gy) {
  float v[4][V];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((flags >> k) & 1) {
      Vec<T, V>::load(src + gpix[k] + c, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    gx += go[i] * ((1.f - wy) * (v[1][i] - v[0][i]) + wy * (v[3][i] - v[2][i]));
    gy += go[i] * ((1.f - wx) * (v[2][i] - v[0][i]) + wx * (v[3][i] - v[1][i]));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(GS_THREADS) grid_sample_bwd_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, const T* __restrict__ dout,
    float* __restrict__ dimg, float* __restrict__ dgrid, Geometry g, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdPixel* px = reinterpret_cast<BwdPixel*>(smem);
  const int tw = 1 << g.tw_shift, tp = g.tile_h * tw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int b, oy, ox;
  tile_origin(g, &b, &oy, &ox);
  const long long first = (long long)b * g.Ho * g.Wo;
  const long long ibase = (long long)b * g.H * g.W * g.C;
  const T* src = img + ibase;
  if (lanes == 1 && dimg == nullptr) {
    // d_grid alone with a pixel a thread (a few channels): each thread runs
    // its pixel from the grid to d_grid, without shared memory or barriers
    for (int p = tid; p < tp; p += GS_THREADS) {
      const int yo = oy + (p >> g.tw_shift), xo = ox + (p & (tw - 1));
      if (yo >= g.Ho || xo >= g.Wo) continue;
      const long long q = first + yo * g.Wo + xo;
      const Footprint f = footprint(grid[2 * q], grid[2 * q + 1], g.H, g.W, g.mode);
      int gpix[4], flags = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gpix[k] = (f.yc[k] * g.W + f.xc[k]) * g.C;
        flags |= (f.valid[k] ? 1 : 0) << k;
      }
      float gx = 0.f, gy = 0.f;
      for (int c = 0; c < g.C; c += V) {
        float go[V];
        Vec<T, V>::load(dout + q * g.C + c, go);
        dgrid_terms<T, V>(src, gpix, flags, f.wx, f.wy, go, c, gx, gy);
      }
      dgrid[2 * q] = gx * (f.dcx * 0.5f * (float)(g.W - 1));
      dgrid[2 * q + 1] = gy * (f.dcy * 0.5f * (float)(g.H - 1));
    }
    return;
  }
  // ---- 1. footprints
  for (int p = tid; p < tp; p += GS_THREADS) {
    const int yo = oy + (p >> g.tw_shift), xo = ox + (p & (tw - 1));
    BwdPixel r = {};
    r.opix = -1;
    if (yo < g.Ho && xo < g.Wo) {
      const long long q = first + yo * g.Wo + xo;
      const Footprint f = footprint(grid[2 * q], grid[2 * q + 1], g.H, g.W, g.mode);
      r.opix = yo * g.Wo + xo;
      r.xy = make_int4((f.yc[0] << 16) | f.xc[0], (f.yc[1] << 16) | f.xc[1],
                       (f.yc[2] << 16) | f.xc[2], (f.yc[3] << 16) | f.xc[3]);
      r.w = make_float4(f.w[0], f.w[1], f.w[2], f.w[3]);
      r.wx = f.wx;
      r.wy = f.wy;
      r.sx = f.dcx * 0.5f * (float)(g.W - 1);
      r.sy = f.dcy * 0.5f * (float)(g.H - 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // scattered: a valid corner, or an invalid one whose weight is NaN
        const bool scat = f.valid[k] || f.w[k] != f.w[k];
        r.flags |= (f.valid[k] ? 1 : 0) << k | (scat ? 1 : 0) << (4 + k);
      }
    }
    px[p] = r;
  }
  __syncthreads();

  // ---- 2. d_grid and d_image
  const int sub = lane & (lanes - 1), per_warp = 32 / lanes;
  float* dst = dimg != nullptr ? dimg + ibase : nullptr;
  // every lane of a warp runs the same pixels' loop, so the shuffles see the
  // whole warp; pixels past the edge add zeros
  for (int base = warp * per_warp; base < tp; base += (GS_THREADS / 32) * per_warp) {
    const int p = base + lane / lanes;
    const BwdPixel& r = px[p];
    float gx = 0.f, gy = 0.f;
    if (r.opix >= 0) {
      const int flags = r.flags;
      const int xy[4] = {r.xy.x, r.xy.y, r.xy.z, r.xy.w};
      const float w[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
      const float wx = r.wx, wy = r.wy;
      int gpix[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) gpix[k] = ((xy[k] >> 16) * g.W + (xy[k] & 0xffff)) * g.C;
      const T* go_row = dout + (first + r.opix) * g.C;
      for (int c = sub * V; c < g.C; c += lanes * V) {
        float go[V];
        Vec<T, V>::load(go_row + c, go);
        if (dgrid != nullptr) dgrid_terms<T, V>(src, gpix, flags, wx, wy, go, c, gx, gy);
        if (dst != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((flags >> (4 + k)) & 1) {
              float s[V];
#pragma unroll
              for (int i = 0; i < V; ++i) s[i] = w[k] * go[i];
              red_add<V>(dst + gpix[k] + c, s);
            }
          }
        }
      }
    }
    if (dgrid != nullptr) {
      for (int o = lanes >> 1; o > 0; o >>= 1) {
        gx += __shfl_xor_sync(0xffffffffu, gx, o);
        gy += __shfl_xor_sync(0xffffffffu, gy, o);
      }
      if (sub == 0 && r.opix >= 0) {
        float* d = dgrid + 2 * (first + r.opix);
        d[0] = gx * r.sx;
        d[1] = gy * r.sy;
      }
    }
  }
}

// d_image rounded once from its float32 sums into the image's dtype.
template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

// ------------------------------------------------------------------ entries
// Bytes of dynamic shared memory a block of the forward (backward = 0) or
// the backward (1) takes for a tile of `tile_pixels` pixels; -1 for a tile
// the kernels refuse.
extern "C" long long grid_sample_smem(int backward, int tile_pixels) {
  if (tile_pixels <= 0 || tile_pixels > 1024) return -1;
  return (long long)tile_pixels * (backward ? BWD_PIXEL_BYTES : FWD_PIXEL_BYTES);
}

namespace {

bool geometry(Geometry* g, int H, int W, int C, int Ho, int Wo, int mode, int tile_h,
              int tile_w) {
  if (tile_h <= 0 || tile_w <= 0 || (tile_w & (tile_w - 1)) || mode < 0 || mode > 2) return false;
  int shift = 0;
  while ((1 << shift) < tile_w) ++shift;
  g->H = H, g->W = W, g->C = C, g->Ho = Ho, g->Wo = Wo, g->mode = mode;
  g->tile_h = tile_h;
  g->tw_shift = shift;
  g->tiles_x = (Wo + tile_w - 1) / tile_w;
  g->tiles_per_sample = g->tiles_x * ((Ho + tile_h - 1) / tile_h);
  return true;
}

template <typename K> cudaError_t allow_smem(K kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int V>
int launch_fwd(const void* img, const void* grid, void* out, int B, const Geometry& g,
               long long smem, cudaStream_t stream) {
  auto kernel = grid_sample_kernel<T, V>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * g.tiles_per_sample, GS_THREADS, smem, stream>>>(
      (const T*)img, (const float*)grid, (T*)out, g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* img, const void* grid, const void* dout, float* dimg, float* dgrid,
               int B, const Geometry& g, int lanes, long long smem, cudaStream_t stream) {
  auto kernel = grid_sample_bwd_kernel<T, V>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * g.tiles_per_sample, GS_THREADS, smem, stream>>>(
      (const T*)img, (const float*)grid, (const T*)dout, dimg, dgrid, g, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward of a launch plan (ops/fused_warp.py grid_sample_plan): tiles
// of tile_h x tile_w pixels, vectors of `vec` elements, `smem` bytes (the
// grid_sample_smem query's).
extern "C" int grid_sample(int dtype, const void* img, const void* grid, void* out, int B, int H,
                           int W, int C, int Ho, int Wo, int mode, int tile_h, int tile_w,
                           int vec, long long smem, void* stream) {
  if ((long long)B * Ho * Wo == 0 || C == 0) return 0;
  Geometry g;
  if (!geometry(&g, H, W, C, Ho, Wo, mode, tile_h, tile_w) || C % vec) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (vec) {
      case 1: return launch_fwd<float, 1>(img, grid, out, B, g, smem, s);
      case 2: return launch_fwd<float, 2>(img, grid, out, B, g, smem, s);
      case 4: return launch_fwd<float, 4>(img, grid, out, B, g, smem, s);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return launch_fwd<bf16, 1>(img, grid, out, B, g, smem, s);
      case 2: return launch_fwd<bf16, 2>(img, grid, out, B, g, smem, s);
      case 4: return launch_fwd<bf16, 4>(img, grid, out, B, g, smem, s);
      case 8: return launch_fwd<bf16, 8>(img, grid, out, B, g, smem, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of a launch plan. dimg (float32, zero-filled here) and dgrid
// may each be null; dimg_out, where not null, receives d_image rounded into
// the image's dtype.
extern "C" int grid_sample_bwd(int dtype, const void* img, const void* grid, const void* dout,
                               void* dimg, void* dimg_out, void* dgrid, int B, int H, int W,
                               int C, int Ho, int Wo, int mode, int tile_h, int tile_w, int vec,
                               int lanes, long long smem, void* stream) {
  if ((long long)B * Ho * Wo == 0 || C == 0 || (dimg == nullptr && dgrid == nullptr)) return 0;
  Geometry g;
  if (!geometry(&g, H, W, C, Ho, Wo, mode, tile_h, tile_w) || C % vec || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W * C;
  if (dimg != nullptr) {
    const cudaError_t err = cudaMemsetAsync(dimg, 0, n * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  float *di = (float*)dimg, *dg = (float*)dgrid;
  int code = (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 1: code = launch_bwd<float, 1>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
      case 2: code = launch_bwd<float, 2>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
      case 4: code = launch_bwd<float, 4>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: code = launch_bwd<bf16, 1>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
      case 2: code = launch_bwd<bf16, 2>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
      case 4: code = launch_bwd<bf16, 4>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
      case 8: code = launch_bwd<bf16, 8>(img, grid, dout, di, dg, B, g, lanes, smem, s); break;
    }
  }
  if (code != 0 || dimg == nullptr || dimg_out == nullptr) return code;
  const long long want = (n + 255) / 256;
  DISPATCH_DTYPE(dtype, cast_kernel<T><<<(int)(want < 132 * 64 ? want : 132 * 64), 256, 0, s>>>(
                            di, (T*)dimg_out, n));
  return (int)cudaGetLastError();
}
