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
// kernel does not take (float32 over 256 channels), and an A/B option for
// every block.
//
// Bound on the H100: operations. A forward at 512 -> 512 channels over
// P = 3,840 pixels is 2 * 9 * Cin * Cout * P = 18.1 GFLOP (18 us at 989
// TFLOP/s) against 16.5 MB (4.9 us at 3.35 TB/s); the backward is two such
// products. Each product is an implicit GEMM with no frame staging: the TPU
// kernel's whole-frame chunks with roll and edge masks are a VMEM
// workaround.
//
// bf16 (the main path; the engine is conv_ring.cuh, shared with kernel 3
// and kernel 5's products): wgmma fed by a ring of STAGES shared-memory stages,
// 256 threads = two warpgroups, a 128 x 128 float32 tile in registers
// (64 rows per warpgroup, m64n128k16), a reduction step of 64 bf16 (one
// 128-byte swizzle row).
//   Forward and din (conv_tile<MIRROR>): rows M = pixels in (frame, y, x)
//     order, so frames of any size fill a tile; N = output channels; K = 9
//     taps x input channels. A tap's shifted pixel rows arrive by 16-byte
//     cp.async with zero-fill (source size 0) where the tap leaves the row's
//     own frame: the test is per row, on the (y, x) each thread computes
//     once per block in 32-bit integers, so a 128-row tile of eight 4 x 4
//     frames masks each frame's edges. cp.async rather than TMA's im2col
//     mode: the rows are 128 contiguous bytes each, a per-row mask costs one
//     predicate, and the same copy serves dW's pixel-major tiles. The
//     weights are plain boxes and arrive by TMA (a 3-D map of w, (Cout, Cin,
//     9) innermost first, 64 x 64 boxes, 128-byte swizzle) completing on the
//     stage's mbarrier: the forward reads w[tap] as (K = Cin) x (N = Cout),
//     N-contiguous (MN-major, transpose bit set); din reads w[8 - tap] as
//     (N = Cin) rows of (K = Cout) (K-major). No copy of the weights is made.
//   dW (wgrad_tile): one GEMM per tap, M = Cin, N = Cout, K = pixels. Both
//     operands are channel-contiguous: the tap-shifted a_in rows (cp.async,
//     zero-filled as above) and the da rows (TMA, 2-D map) land as MN-major
//     tiles, which wgmma reads through its transpose bits. The pixel range
//     may be split (plan: fused_resnet.conv33_plan) so that few tiles still
//     fill the SMs; each split writes its partial and sum_parts adds them in
//     a fixed order: no float atomics, dW is the same bit for bit from run
//     to run.
//   Kernel 10 is conv_wgmma_kernel; kernel 11 is bwd_wgmma_kernel, din's
//   and dW's tiles in one launch: at multi1248's 512 channels dW alone has
//   144 blocks of 60 steps (two waves on 132 SMs, the second nearly
//   empty) and din 120 of 72; together they pack into the SMs.
//   Pipeline, per reduction step i: wait for this thread's copies of stage
//   i (cp.async.wait_group) and the stage's TMA bytes (mbarrier), fence the
//   generic proxy's writes to the async proxy that wgmma reads through,
//   __syncthreads, issue the copies of step i + STAGES - 2 into the stage
//   that step i - 2's products have left (every warpgroup waited for it),
//   then issue step i's four wgmmas and wait until only they are in flight:
//   copies run under the products and the products under the next step's
//   barrier.
//   The bf16 kernels take channel counts that are multiples of 8 (16-byte
//   rows); the wrapper pads others with zeros (conv33_plan).
//
// float32 (the check path; JAX runs float32 convs at HIGHEST precision): a
// block owns 64 pixels by 64 output channels, stages each tap's shifted rows
// and weights in shared memory, each thread accumulates 4 x 4 outputs with
// FMAs; dW by the same per-split partials.
#include "conv_ring.cuh"

namespace {

// ---------------------------------------------------------------- float32
constexpr int NT = 256;
constexpr int BM = 64;      // GEMM rows per block
constexpr int BN = 64;      // GEMM columns per block
constexpr int BK = 32;      // reduction slice staged per step
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

// ---------------------------------------------------------------- bf16
// Kernel 10. Grid: (ceil(P / GM), ceil(N / GN)).
__global__ void __launch_bounds__(GT, 1)
    conv_wgmma_kernel(__grid_constant__ const CUtensorMap wmap, const bf16* __restrict__ in,
                      const float* __restrict__ bias, float* __restrict__ out, int P, int H,
                      int W, int K, int N) {
  extern __shared__ uint8_t smem[];
  const Ring<> ring(smem);
  conv_tile<false>(ring, &wmap, in, bias, out, P, H, W, K, N, blockIdx.x * GM, blockIdx.y * GN);
}

// Kernel 11 is conv_ring.cuh's bwd_wgmma_kernel<9> (bwd_products), which
// kernel 7 shares.

// ---------------------------------------------------------------- launches
template <bool MIRROR>
cudaError_t conv_f32(const float* in, const float* w, const float* bias, float* out, long long P,
                     int H, int W, int K, int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((P + BM - 1) / BM), (N + BN - 1) / BN);
  conv_fma_kernel<MIRROR><<<grid, NT, 0, stream>>>(in, w, bias, out, P, H, W, K, N);
  return cudaGetLastError();
}

int bwd_f32(const float* da, const float* a_in, const float* w, float* din, float* part,
            float* dw, long long P, int H, int W, int Cin, int Cout, int splits,
            cudaStream_t stream) {
  cudaError_t err = conv_f32<true>(da, w, nullptr, din, P, H, W, Cout, Cin, stream);
  if (err != cudaSuccess) return (int)err;
  const long long slices = (P + BK - 1) / BK;
  const int per = (int)((slices + splits - 1) / splits);
  const dim3 grid((Cin + BM - 1) / BM, (Cout + BN - 1) / BN, 9 * splits);
  wgrad_fma_kernel<<<grid, NT, 0, stream>>>(a_in, da, part, P, H, W, Cin, Cout, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_parts(part, splits, 9LL * Cin * Cout, dw, stream);
}

// What the bf16 kernels take: 16-byte rows (channel counts multiples of 8),
// 16-byte-aligned operands, pixel indices in 32 bits.
bool bf16_shapes_ok(long long P, int Cin, int Cout, const void* act, const void* w) {
  return Cin % 8 == 0 && Cout % 8 == 0 && Cin > 0 && Cout > 0 && P < (1LL << 31) - GM &&
         aligned16(act) && aligned16(w);
}

cudaError_t fwd_bf16(const CUtensorMap& wmap, const bf16* x, const float* bias, float* out, int P,
                     int H, int W, int Cin, int Cout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + GM - 1) / GM, (Cout + GN - 1) / GN);
  conv_wgmma_kernel<<<grid, GT, SMEM, stream>>>(wmap, x, bias, out, P, H, W, Cin, Cout);
  return cudaGetLastError();
}

int bwd_bf16(const bf16* da, const bf16* a_in, const bf16* w, float* din, float* part, float* dw,
             int P, int H, int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  const int code = bwd_products<9>(da, a_in, w, din, splits == 1 ? dw : part, P, H, W, Cin, Cout,
                                   splits, stream);
  if (code != 0 || splits == 1) return code;
  return (int)sum_parts(part, splits, 9LL * Cin * Cout, dw, stream);
}

}  // namespace

// x (F, H, W, Cin) and w (9, Cin, Cout) in the dtype; bias (Cout) float32 or
// null; out (F, H, W, Cout) float32. bf16: Cin and Cout multiples of 8, x and
// w 16-byte aligned.
extern "C" int conv33_fwd(int dtype, const void* x, const void* w, const float* bias, float* out,
                          int F, int H, int W, int Cin, int Cout, void* stream) {
  const long long P = (long long)F * H * W;
  if (P == 0) return 0;
  if (dtype == 0)
    return (int)conv_f32<false>((const float*)x, (const float*)w, bias, out, P, H, W, Cin, Cout,
                                (cudaStream_t)stream);
  if (dtype != 1 || !bf16_shapes_ok(P, Cin, Cout, x, w)) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  const int code = weight_map(&wmap, w, Cin, Cout);
  if (code != 0) return code;
  return (int)fwd_bf16(wmap, (const bf16*)x, bias, out, (int)P, H, W, Cin, Cout,
                       (cudaStream_t)stream);
}

// da (F, H, W, Cout), a_in (F, H, W, Cin) and w (9, Cin, Cout) in the dtype;
// din (F, H, W, Cin) and dw (9, Cin, Cout) float32; part: splits * 9 * Cin *
// Cout floats of scratch, one partial dW per split (bf16 with one split:
// unused, may be null). bf16: Cin and Cout multiples of 8, da, a_in and w
// 16-byte aligned.
extern "C" int conv33_bwd(int dtype, const void* da, const void* a_in, const void* w, float* din,
                          float* part, float* dw, int F, int H, int W, int Cin, int Cout,
                          int splits, void* stream) {
  const long long P = (long long)F * H * W;
  if (P == 0 || splits < 1) return P == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_f32((const float*)da, (const float*)a_in, (const float*)w, din, part, dw, P, H, W,
                   Cin, Cout, splits, (cudaStream_t)stream);
  if (dtype != 1 || !bf16_shapes_ok(P, Cin, Cout, da, w) || !aligned16(a_in) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  return bwd_bf16((const bf16*)da, (const bf16*)a_in, (const bf16*)w, din, part, dw, (int)P, H, W,
                  Cin, Cout, splits, (cudaStream_t)stream);
}
