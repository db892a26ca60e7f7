// The (1,3,3) convolution of the diffusion UNet's resnet blocks and its
// gradients, standalone (kernels 10 and 11):
//
//   conv33_fwd  replaces extdm_tpu/ops/pallas_resnet.py _conv33_fwd
//               (_conv33_fwd_kernel): out = conv(x) + b, float32, zero edges,
//               x (F, H, W, Cin) in the compute type, w (9, Cin, Cout) taps
//               in (ky, kx) order.
//   conv33_bwd  replaces pallas_resnet.py _conv33_bwd (_conv33_bwd_kernel):
//               din = the input gradient (float32) and dW (9, Cin, Cout)
//               (float32) from the output gradient da (compute type) and the
//               conv input a_in.
//
// They are the convs of the decomposed resnet backward
// (ops/fused_resnet.py resnet_block_bwd_decomposed, the counterpart of
// pallas_resnet._chunked_bwd): the route for blocks the whole-block backward
// kernel does not take (Cout > 256), and an A/B option for every block.
//
// Bound on the H100: operations (2 * 9 * Cin * Cout flops per pixel against
// 2 * (Cin + 2 Cout) bytes). Each is an implicit GEMM over the 9 taps, with
// no frame staging: the TPU kernel's whole-frame chunks with roll and edge
// masks are a VMEM workaround. A block owns 64 pixels (rows of the GEMM,
// consecutive in (frame, y, x) order, so frames of any size fill it) by 64
// output channels; per tap and 32-channel slice of the reduction it stages
// the tap's shifted input rows (zero where the tap falls off the frame) and
// the tap's weights in shared memory. In bf16 the products run on the tensor
// cores (mma.sync m16n8k16, float accumulators): 8 warps, each 16 rows x 32
// columns. In float32 (JAX runs float32 convs at HIGHEST precision) each
// thread accumulates 4 x 4 outputs with FMAs.
//
// din is the same product with the taps mirrored and the weights transposed
// (K = Cout, N = Cin). dW is a product over pixels: a block owns one tap and
// a 64 x 64 (Cin, Cout) tile over one split of the pixels, writes its
// partial, and sum_parts adds the splits in order: no float atomics, the
// result does not depend on the order in which blocks ran.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BM = 64;      // GEMM rows per block
constexpr int BN = 64;      // GEMM columns per block
constexpr int BK = 32;      // reduction slice staged per step
constexpr int KS = BK + 8;  // bf16 row stride of a staged [row][k] tile: spreads banks
constexpr int FS = BN + 1;  // float row stride of a staged FMA tile

// Pixel p = (frame, y, x) shifted by tap (dy, dx) = (tap / 3 - 1, tap % 3 - 1):
// its index, or -1 off the frame (or past the last pixel).
__device__ __forceinline__ long long tap_pixel(long long p, int tap, long long P, int H, int W) {
  if (p >= P) return -1;
  const int x = (int)(p % W), y = (int)((p / W) % H);
  const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return -1;
  return p + (long long)(yy - y) * W + (xx - x);
}

// The weight of tap `tap` at reduction index k and output column n. Forward:
// w[tap][k][n] with (K, N) = (Cin, Cout). Mirrored (din): w[8 - tap][n][k],
// with (K, N) = (Cout, Cin).
template <bool MIRROR, typename T>
__device__ __forceinline__ T weight(const T* w, int tap, int k, int n, int K, int N) {
  return MIRROR ? w[((long long)(8 - tap) * N + n) * K + k] : w[((long long)tap * K + k) * N + n];
}

// out[p][n] = sum over taps and k of in[tap_pixel(p)][k] W(tap, k, n) (+ bias[n]).
// Grid: (ceil(P / BM), ceil(N / BN)).
template <bool MIRROR>
__global__ void __launch_bounds__(NT) conv_mma_kernel(const bf16* __restrict__ in,
                                                     const bf16* __restrict__ w,
                                                     const float* __restrict__ bias,
                                                     float* __restrict__ out, long long P, int H,
                                                     int W, int K, int N) {
  __shared__ __align__(16) bf16 as[BM * KS];  // [pixel][k]
  __shared__ __align__(16) bf16 bs[BN * KS];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, ng = warp >> 2;  // 16-row tile, 32-column half
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    long long src[BM * BK / NT];  // this thread's staged rows: pixel warp + 8 i, k = lane
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) src[i] = tap_pixel(p0 + warp + 8 * i, tap, P, H, W);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();
      const int k = k0 + lane;
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i)
        as[(warp + 8 * i) * KS + lane] =
            (src[i] >= 0 && k < K) ? in[src[i] * K + k] : __float2bfloat16(0.f);
      for (int e = tid; e < BN * BK; e += NT) {
        // lanes along the weights' contiguous axis: n forward, k mirrored
        const int n = MIRROR ? e / BK : e % BN, kk = MIRROR ? e % BK : e / BN;
        bs[n * KS + kk] = (k0 + kk < K && n0 + n < N)
                              ? weight<MIRROR>(w, tap, k0 + kk, n0 + n, K, N)
                              : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const bf16* a_lo = as + (16 * mt + g) * KS + kk + 2 * t4;
        const bf16* a_hi = a_lo + 8 * KS;
        const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* bp = bs + (32 * ng + 8 * j + g) * KS + kk + 2 * t4;
          mma_bf16(acc[j], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long p = p0 + 16 * mt + g + 8 * (e >> 1);
      const int n = n0 + 32 * ng + 8 * j + 2 * t4 + (e & 1);
      if (p < P && n < N) out[p * N + n] = acc[j][e] + (bias != nullptr ? bias[n] : 0.f);
    }
}

// The float32 product: each thread 4 pixels (ty + 16 i) x 4 columns (tx + 16 j).
template <bool MIRROR>
__global__ void __launch_bounds__(NT) conv_fma_kernel(const float* __restrict__ in,
                                                     const float* __restrict__ w,
                                                     const float* __restrict__ bias,
                                                     float* __restrict__ out, long long P, int H,
                                                     int W, int K, int N) {
  __shared__ float as[BK * (BM + 1)];  // [k][pixel]
  __shared__ float bs[BK * FS];        // [k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    long long src[BM * BK / NT];
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) src[i] = tap_pixel(p0 + warp + 8 * i, tap, P, H, W);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();
      const int k = k0 + lane;
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i)
        as[lane * (BM + 1) + warp + 8 * i] = (src[i] >= 0 && k < K) ? in[src[i] * K + k] : 0.f;
      for (int e = tid; e < BN * BK; e += NT) {
        const int n = MIRROR ? e / BK : e % BN, kk = MIRROR ? e % BK : e / BN;
        bs[kk * FS + n] = (k0 + kk < K && n0 + n < N)
                              ? weight<MIRROR>(w, tap, k0 + kk, n0 + n, K, N) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk * FS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long p = p0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (p < P && n < N) out[p * N + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
}

// part[z][tap][ci][co] = sum over the pixels p of split z of
// a_in[tap_pixel(p)][ci] da[p][co]. Grid: (ceil(Cin / 64), ceil(Cout / 64),
// 9 * splits), z = blockIdx.z / 9, tap = blockIdx.z % 9; a split is `per`
// consecutive slices of BK pixels.
__global__ void __launch_bounds__(NT) wgrad_mma_kernel(const bf16* __restrict__ a_in,
                                                      const bf16* __restrict__ da,
                                                      float* __restrict__ part, long long P,
                                                      int H, int W, int Cin, int Cout, int per) {
  __shared__ __align__(16) bf16 as[BM * KS];  // [ci][pixel]
  __shared__ __align__(16) bf16 bs[BN * KS];  // [co][pixel]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, ng = warp >> 2;
  const int ci0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int z = blockIdx.z / 9, tap = blockIdx.z % 9;
  const long long begin = (long long)z * per * BK;
  const long long end = min(P, begin + (long long)per * BK);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (long long q0 = begin; q0 < end; q0 += BK) {
    __syncthreads();
    for (int e = tid; e < BM * BK; e += NT) {  // lanes along channels: coalesced reads
      const int c = e % BM, px = e / BM;
      const long long p = q0 + px;
      const long long s = p < end ? tap_pixel(p, tap, P, H, W) : -1;
      const bf16 zero = __float2bfloat16(0.f);
      as[c * KS + px] = (s >= 0 && ci0 + c < Cin) ? a_in[s * Cin + ci0 + c] : zero;
      bs[c * KS + px] = (p < end && co0 + c < Cout) ? da[p * Cout + co0 + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const bf16* a_lo = as + (16 * mt + g) * KS + kk + 2 * t4;
      const bf16* a_hi = a_lo + 8 * KS;
      const uint32_t a0 = ld2(a_lo), a1 = ld2(a_hi), a2 = ld2(a_lo + 8), a3 = ld2(a_hi + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* bp = bs + (32 * ng + 8 * j + g) * KS + kk + 2 * t4;
        mma_bf16(acc[j], a0, a1, a2, a3, ld2(bp), ld2(bp + 8));
      }
    }
  }
  float* out = part + ((long long)z * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = ci0 + 16 * mt + g + 8 * (e >> 1);
      const int co = co0 + 32 * ng + 8 * j + 2 * t4 + (e & 1);
      if (ci < Cin && co < Cout) out[(long long)ci * Cout + co] = acc[j][e];
    }
}

__global__ void __launch_bounds__(NT) wgrad_fma_kernel(const float* __restrict__ a_in,
                                                      const float* __restrict__ da,
                                                      float* __restrict__ part, long long P,
                                                      int H, int W, int Cin, int Cout, int per) {
  __shared__ float as[BK * FS];  // [pixel][ci]
  __shared__ float bs[BK * FS];  // [pixel][co]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ci0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  const int z = blockIdx.z / 9, tap = blockIdx.z % 9;
  const long long begin = (long long)z * per * BK;
  const long long end = min(P, begin + (long long)per * BK);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long q0 = begin; q0 < end; q0 += BK) {
    __syncthreads();
    for (int e = tid; e < BM * BK; e += NT) {
      const int c = e % BM, px = e / BM;
      const long long p = q0 + px;
      const long long s = p < end ? tap_pixel(p, tap, P, H, W) : -1;
      as[px * FS + c] = (s >= 0 && ci0 + c < Cin) ? a_in[s * Cin + ci0 + c] : 0.f;
      bs[px * FS + c] = (p < end && co0 + c < Cout) ? da[p * Cout + co0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int px = 0; px < BK; ++px) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[px * FS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[px * FS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = part + ((long long)z * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + ty + 16 * i, co = co0 + tx + 16 * j;
      if (ci < Cin && co < Cout) out[(long long)ci * Cout + co] = acc[i][j];
    }
}

template <typename T, bool MIRROR>
cudaError_t conv(const T* in, const T* w, const float* bias, float* out, long long P, int H, int W,
                 int K, int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((P + BM - 1) / BM), (N + BN - 1) / BN);
  if constexpr (std::is_same<T, bf16>::value)
    conv_mma_kernel<MIRROR><<<grid, NT, 0, stream>>>(in, w, bias, out, P, H, W, K, N);
  else
    conv_fma_kernel<MIRROR><<<grid, NT, 0, stream>>>(in, w, bias, out, P, H, W, K, N);
  return cudaGetLastError();
}

template <typename T>
int bwd(const T* da, const T* a_in, const T* w, float* din, float* part, float* dw, long long P,
        int H, int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  cudaError_t err = conv<T, true>(da, w, nullptr, din, P, H, W, Cout, Cin, stream);
  if (err != cudaSuccess) return (int)err;
  const long long slices = (P + BK - 1) / BK;
  const int per = (int)((slices + splits - 1) / splits);
  const dim3 grid((Cin + BM - 1) / BM, (Cout + BN - 1) / BN, 9 * splits);
  if constexpr (std::is_same<T, bf16>::value)
    wgrad_mma_kernel<<<grid, NT, 0, stream>>>(a_in, da, part, P, H, W, Cin, Cout, per);
  else
    wgrad_fma_kernel<<<grid, NT, 0, stream>>>(a_in, da, part, P, H, W, Cin, Cout, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_parts(part, splits, 9LL * Cin * Cout, dw, stream);
}

}  // namespace

// x (F, H, W, Cin) and w (9, Cin, Cout) in the dtype; bias (Cout) float32 or
// null; out (F, H, W, Cout) float32.
extern "C" int conv33_fwd(int dtype, const void* x, const void* w, const float* bias, float* out,
                          int F, int H, int W, int Cin, int Cout, void* stream) {
  const long long P = (long long)F * H * W;
  if (P == 0) return 0;
  DISPATCH_DTYPE(dtype, return (int)conv<T, false>((const T*)x, (const T*)w, bias, out, P, H, W,
                                                   Cin, Cout, (cudaStream_t)stream));
  return 0;
}

// da (F, H, W, Cout), a_in (F, H, W, Cin) and w (9, Cin, Cout) in the dtype;
// din (F, H, W, Cin) and dw (9, Cin, Cout) float32; part: splits * 9 * Cin *
// Cout floats of scratch, one partial dW per split.
extern "C" int conv33_bwd(int dtype, const void* da, const void* a_in, const void* w, float* din,
                          float* part, float* dw, int F, int H, int W, int Cin, int Cout,
                          int splits, void* stream) {
  const long long P = (long long)F * H * W;
  if (P == 0 || splits < 1) return P == 0 ? 0 : (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, return bwd<T>((const T*)da, (const T*)a_in, (const T*)w, din, part, dw, P,
                                      H, W, Cin, Cout, splits, (cudaStream_t)stream));
  return 0;
}
