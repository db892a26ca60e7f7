// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on the activation type T (float or bf16) and
// computes in float. Each C entry point takes a dtype code (0 = float32,
// 1 = bfloat16), raw device pointers and the caller's stream, launches, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Round a float through T: the JAX reference casts these intermediates to
// the compute dtype, so the kernel does too.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// D += A B on the tensor cores, one m16n8k16 tile, bf16 operands, float
// accumulators. Fragments (g = lane / 4, t = lane % 4; each register holds
// two bf16 neighbours along k): a0 = A[g][2t..], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// c0, c1 = D[g][2t, 2t+1], c2, c3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two neighbouring bf16 values as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 in one fragment register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

namespace {

// out[i] = sum over p of part[p * n + i], in order of p: the second pass of a
// reduction whose first pass wrote one partial buffer per block or split, so
// that the result does not depend on the order in which blocks ran.
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, long long n,
                                 float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part[p * n + i];
    out[i] = s;
  }
}

inline cudaError_t sum_parts(const float* part, int nparts, long long n, float* out,
                             cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  sum_parts_kernel<<<(int)(want < 1024 ? want : 1024), 256, 0, stream>>>(part, nparts, n, out);
  return cudaGetLastError();
}

}  // namespace

#define DISPATCH_DTYPE(code, ...)         \
  do {                                    \
    if ((code) == 0) {                    \
      typedef float T;                    \
      __VA_ARGS__;                        \
    } else if ((code) == 1) {             \
      typedef bf16 T;                     \
      __VA_ARGS__;                        \
    } else {                              \
      return (int)cudaErrorInvalidValue;  \
    }                                     \
  } while (0)
