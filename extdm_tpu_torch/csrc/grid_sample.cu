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

__device__ __forceinline__ float reflect_coord(float x, int size) {
  if (size == 1) return 0.f;
  const float span = 2.f * (float)(size - 1);
  float r = fmodf(x, span);
  if (r != 0.f && r < 0.f) r += span;  // floored modulo, as jnp.mod
  return fminf(r, span - r);
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
      x = reflect_coord(x, W);
      y = reflect_coord(y, H);
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
