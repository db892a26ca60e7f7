// Bilinear NHWC grid sample, align_corners=True, zeros/border/reflection
// padding.
//
// Replaces extdm_tpu/ops/pallas_warp.py grid_sample (_grid_sample_impl ->
// _make_kernel), which builds a one-hot (pixels x H*W) weight matrix and
// contracts it on the TPU's matrix unit because the TPU has no fast gather.
// Hopper gathers directly, so this kernel reads the four corners.
//
// Bound on the H100: bytes. Each output element costs 4 gathered reads and
// one write, a handful of flops. One thread per (output pixel, channel),
// channel fastest: neighbouring threads read neighbouring channels of the
// same corner pixel and write neighbouring outputs, so every access is
// coalesced for any channel count (the decode's merged C=67 warp included).
// The corner coordinates are recomputed per channel; they are a few flops
// against memory latency. The gather is in the image's dtype, the lerp in
// float, as extdm_tpu/ops/warp.py does.
#include "common.cuh"

// Reflect a pixel coordinate into [0, size - 1] with period 2 (size - 1);
// *dc is its derivative: +1 or -1 by the side of the fold (0 for size 1).
__device__ __forceinline__ float reflect_coord(float x, int size, float* dc) {
  if (size == 1) {
    *dc = 0.f;
    return 0.f;
  }
  const float span = 2.f * (float)(size - 1);
  float r = fmodf(x, span);
  if (r != 0.f && r < 0.f) r += span;  // floored modulo, as jnp.mod
  if (r < span - r) {
    *dc = 1.f;
    return r;
  }
  *dc = -1.f;
  return span - r;
}

template <typename T>
__global__ void __launch_bounds__(256) grid_sample_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, T* __restrict__ out,
    int B, int H, int W, int C, int Ho, int Wo, int mode) {
  const long long total = (long long)B * Ho * Wo * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long p = i / C;  // (b * Ho + yo) * Wo + xo
    const int b = (int)(p / ((long long)Ho * Wo));
    float x = (grid[2 * p] + 1.f) * 0.5f * (float)(W - 1);
    float y = (grid[2 * p + 1] + 1.f) * 0.5f * (float)(H - 1);
    if (mode == 2) {
      float dc;
      x = reflect_coord(x, W, &dc);
      y = reflect_coord(y, H, &dc);
    } else if (mode == 1) {
      x = fminf(fmaxf(x, 0.f), (float)(W - 1));
      y = fminf(fmaxf(y, 0.f), (float)(H - 1));
    }
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx = x - x0, wy = y - y0;
    const T* base = img + (long long)b * H * W * C + c;
    auto corner = [&](float xi, float yi) -> float {
      const bool valid = xi >= 0.f && xi <= (float)(W - 1) && yi >= 0.f && yi <= (float)(H - 1);
      if (mode == 0 && !valid) return 0.f;
      const int xc = (int)fminf(fmaxf(xi, 0.f), (float)(W - 1));
      const int yc = (int)fminf(fmaxf(yi, 0.f), (float)(H - 1));
      return to_f(base[((long long)yc * W + xc) * C]);
    };
    const float v00 = corner(x0, y0), v01 = corner(x0 + 1.f, y0);
    const float v10 = corner(x0, y0 + 1.f), v11 = corner(x0 + 1.f, y0 + 1.f);
    const float top = v00 * (1.f - wx) + v01 * wx;
    const float bot = v10 * (1.f - wx) + v11 * wx;
    out[i] = from_f<T>(top * (1.f - wy) + bot * wy);
  }
}

extern "C" int grid_sample(int dtype, const void* img, const void* grid, void* out,
                           int B, int H, int W, int C, int Ho, int Wo, int mode,
                           void* stream) {
  const long long total = (long long)B * Ho * Wo * C;
  if (total == 0) return 0;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  DISPATCH_DTYPE(dtype, grid_sample_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
                            (const T*)img, (const float*)grid, (T*)out, B, H, W, C, Ho, Wo, mode));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// Gradients of the sample above for the cotangent dout (B, Ho, Wo, C):
//   d_image (B, H, W, C) float32: each output scatters w_corner * dout into
//     its in-range corners (atomicAdd; the buffer is zeroed by the caller);
//   d_grid (B, Ho, Wo, 2) float32: per output pixel, the sum over channels of
//     dout * d(bilinear)/d(x, y), times the padding mode's coordinate
//     derivative and 0.5 * (size - 1).
// Either pointer may be null, and then that output is not computed.
//
// Replaces extdm_tpu/ops/pallas_warp.py _grid_sample_bwd_impl (its
// _make_bwd_kernel), which rebuilds the one-hot (pixels x H*W) weight matrix
// and contracts it twice on the TPU's matrix unit (M^T dout, and dout img^T
// for the indicator sums). Hopper scatters and gathers directly, so neither
// matrix exists here.
//
// Bound on the H100: bytes (image, grid and dout read, d_image and d_grid
// written, a few flops per element). d_grid is a reduction over channels per
// output pixel: a group of `lanes` threads (min(C, 32) rounded up to a power
// of two) takes one pixel, its lanes stride over the channels (coalesced
// reads, and C = 3 idles one lane of four rather than 29 of 32), and the
// group sums with xor shuffles in a fixed order, so d_grid is deterministic.
// The order of the d_image atomics varies from run to run, below float32
// resolution.
template <typename T>
__global__ void __launch_bounds__(256) grid_sample_bwd_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, const T* __restrict__ dout,
    float* __restrict__ dimg, float* __restrict__ dgrid, int B, int H, int W, int C, int Ho,
    int Wo, int mode, int lanes) {
  const long long P = (long long)B * Ho * Wo;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float sx = 0.5f * (float)(W - 1), sy = 0.5f * (float)(H - 1);
  // Every lane of a warp runs the same number of iterations, so the shuffles
  // below always see the whole warp; lanes past the last pixel add zeros.
  for (long long first = warp * per_warp; first < P; first += nwarps * per_warp) {
    const long long p = first + lane / lanes;
    float gx = 0.f, gy = 0.f, dcx = 1.f, dcy = 1.f;
    if (p < P) {
      const int b = (int)(p / ((long long)Ho * Wo));
      float x = (grid[2 * p] + 1.f) * sx;
      float y = (grid[2 * p + 1] + 1.f) * sy;
      if (mode == 2) {
        x = reflect_coord(x, W, &dcx);
        y = reflect_coord(y, H, &dcy);
      } else if (mode == 1) {
        dcx = (x > 0.f && x < (float)(W - 1)) ? 1.f : 0.f;
        dcy = (y > 0.f && y < (float)(H - 1)) ? 1.f : 0.f;
        x = fminf(fmaxf(x, 0.f), (float)(W - 1));
        y = fminf(fmaxf(y, 0.f), (float)(H - 1));
      }
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx = x - x0, wy = y - y0;
      // corners in the order (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
      const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
      const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
      const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
      long long off[4];
      bool valid[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        valid[k] = mode != 0 || (cx[k] >= 0.f && cx[k] <= (float)(W - 1) && cy[k] >= 0.f &&
                                 cy[k] <= (float)(H - 1));
        const int xc = (int)fminf(fmaxf(cx[k], 0.f), (float)(W - 1));
        const int yc = (int)fminf(fmaxf(cy[k], 0.f), (float)(H - 1));
        off[k] = (((long long)b * H + yc) * W + xc) * C;
      }
      const T* g = dout + p * C;
      for (int c = sub; c < C; c += lanes) {
        const float go = to_f(g[c]);
        if (dimg) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (valid[k]) atomicAdd(dimg + off[k] + c, w[k] * go);
        }
        if (dgrid) {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = valid[k] ? to_f(img[off[k] + c]) : 0.f;
          gx += go * ((1.f - wy) * (v[1] - v[0]) + wy * (v[3] - v[2]));
          gy += go * ((1.f - wx) * (v[2] - v[0]) + wx * (v[3] - v[1]));
        }
      }
    }
    if (dgrid) {
      for (int o = lanes >> 1; o > 0; o >>= 1) {
        gx += __shfl_xor_sync(0xffffffffu, gx, o);
        gy += __shfl_xor_sync(0xffffffffu, gy, o);
      }
      if (sub == 0 && p < P) {
        dgrid[2 * p] = gx * dcx * sx;
        dgrid[2 * p + 1] = gy * dcy * sy;
      }
    }
  }
}

extern "C" int grid_sample_bwd(int dtype, const void* img, const void* grid, const void* dout,
                               void* dimg, void* dgrid, int B, int H, int W, int C, int Ho,
                               int Wo, int mode, void* stream) {
  const long long pixels = (long long)B * Ho * Wo;
  if (pixels == 0 || C == 0 || (dimg == nullptr && dgrid == nullptr)) return 0;
  int lanes = 1;
  while (lanes < C && lanes < 32) lanes <<= 1;
  const long long want = (pixels * lanes + 255) / 256;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  DISPATCH_DTYPE(dtype, grid_sample_bwd_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
                            (const T*)img, (const float*)grid, (const T*)dout, (float*)dimg,
                            (float*)dgrid, B, H, W, C, Ho, Wo, mode, lanes));
  return (int)cudaGetLastError();
}
