// The wgmma implicit-GEMM engine of the (1,3,3) convolutions: a ring of
// shared-memory stages fed by cp.async (the tap-shifted pixel rows, masked
// per row) and TMA (the weight boxes), the tiles built on it, and kernel
// 11's launch of din and dW tiles (bwd_wgmma_kernel). Shared by kernels 10
// and 11 (conv33.cu), kernels 3 and 7 (resnet.cu; kernel 7's conv
// gradients run kernel 11's launch) and kernel 5's input-gradient and
// weight-gradient products (stw_layer_bwd.cu).
//
// 256 threads = two warpgroups, a 128 x 128 float32 tile in registers (64
// rows per warpgroup, m64n128k16), a reduction step of 64 bf16 (one
// 128-byte swizzle row).
//   conv_tile<MIRROR, TAPS>: rows M = pixels in (frame, y, x) order, so
//     frames of any size fill a tile; N = output channels; K = taps x input
//     channels. A tap's shifted pixel rows arrive by 16-byte cp.async with
//     zero-fill (source size 0) where the tap leaves the row's own frame: the
//     test is per row, on the (y, x) each thread computes once per block in
//     32-bit integers, so a 128-row tile of eight 4 x 4 frames masks each
//     frame's edges. The weights arrive by TMA (a 3-D map of w, (N or K, K
//     or N, taps) innermost first, 64 x 64 boxes, 128-byte swizzle)
//     completing on the stage's mbarrier: the forward reads w[tap] as (K =
//     Cin) x (N = Cout), N-contiguous (MN-major, transpose bit set); din
//     (MIRROR) reads w[8 - tap] as (N = Cin) rows of (K = Cout) (K-major).
//     TAPS = 1 is a 1 x 1 product (the centre tap only; w has one tap): a
//     plain row-major GEMM when H = W = 1.
//   wgrad_tile: one GEMM per tap, M = Cin, N = Cout, K = pixels. Both
//     operands are channel-contiguous: the tap-shifted a_in rows (cp.async,
//     zero-filled as above) and the da rows (TMA, 2-D map) land as MN-major
//     tiles, which wgmma reads through its transpose bits.
//   Pipeline, per reduction step i: wait for this thread's copies of stage
//   i (cp.async.wait_group) and the stage's TMA bytes (mbarrier), fence the
//   generic proxy's writes to the async proxy that wgmma reads through,
//   __syncthreads, issue the copies of step i + STAGES - 2 into the stage
//   that step i - 2's products have left (every warpgroup waited for it),
//   then issue step i's four wgmmas and wait until only they are in flight:
//   copies run under the products and the products under the next step's
//   barrier.
// Template parameters: S, the ring's stages (STAGES; 3 lets two blocks
// share an SM, three with BN = 64), and BN, a tile's columns (GN; 64 for the
// forward products of narrow outputs or few row tiles, kernel 3 and kernel
// 5's dh).
// Channel counts are multiples of 8 (16-byte rows); wrappers pad others.
#pragma once

#include "common.cuh"

namespace {

constexpr int GT = 256;                 // threads: two warpgroups
constexpr int GM = 128;                 // GEMM rows per block (64 per warpgroup)
constexpr int GN = 128;                 // GEMM columns per block
constexpr int GK = 64;                  // reduction step: 64 bf16 = one 128-byte row
constexpr int STAGES = 5;               // ring depth (the default; S below)
constexpr int TILE = GM * GK * 2;       // bytes of one operand's tile in a stage (GN == GM)
constexpr int ATOM = 64 * 128;          // bytes of 64 rows of 128 bytes
// Dynamic shared memory of a block with a ring of S stages of an A tile and
// a B tile BN columns wide: A, B, barriers, alignment. Three stages (99,352
// bytes at BN = 128, 74,776 at 64) let two (three) blocks share an SM, for
// the convs whose few reduction steps leave one block's pipeline mostly
// filling and draining; BN = 64 halves the products of a 64-channel conv.
template <int S = STAGES, int BN = GN>
constexpr int ring_smem() { return S * TILE + S * BN * GK * 2 + 8 * S + 1024; }
constexpr int SMEM = ring_smem();
static_assert(GN == GM && GM == 2 * 64 && GK == 64, "tiles as the copies and wgmmas assume");
static_assert(SMEM <= 232448, "the ring must fit a block's shared memory");
static_assert(2 * (ring_smem<3>() + 2048) <= 232448, "two 3-stage blocks share an SM");
static_assert(3 * (ring_smem<3, 64>() + 2048) <= 232448, "three narrow 3-stage blocks share one");

// The ring in dynamic shared memory, 1024-byte aligned for the swizzle
// atoms: A tiles of every stage, then B tiles, then one mbarrier a stage.
template <int S = STAGES, int BN = GN>
struct Ring {
  static constexpr int BTILE = BN * GK * 2;  // bytes of a stage's B tile
  uint32_t a, b, bar;
  __device__ __forceinline__ explicit Ring(const void* raw) {
    a = (smem_addr(raw) + 1023u) & ~1023u;
    b = a + S * TILE;
    bar = b + S * BTILE;
  }
};

// Runs `steps` reduction steps through the ring into acc (zeros when there
// are none). ld.issue(j) starts the copies of step j into stage j % STAGES
// (A by cp.async, B by TMA on the stage's mbarrier, TILE bytes) and commits
// a cp.async group, an empty one past the last step; mma(s, acc, first)
// issues stage s's four k16 products, the first of step 0 overwriting acc
// (no instruction but a wgmma defines the accumulators in the loop). Per
// step i: wait for this thread's copies and the stage's TMA bytes, fence,
// barrier, refill the stage step i - 2 has left, multiply, and wait until
// only this step's products are in flight.
template <int S, int BN, class Loader, class Mma>
__device__ __forceinline__ void run_ring(const Ring<S, BN>& ring, int steps,
                                         float (&acc)[BN / 2], Loader& ld, const Mma& mma) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(ring.bar + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < S - 2; ++j) ld.issue(j);
  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<S - 3>();
    mbar_wait(ring.bar + 8 * s, phase);
    fence_proxy_async();
    __syncthreads();
    ld.issue(i + S - 2);
    fence_regs(acc);
    wgmma_fence();
    mma(s, acc, i == 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (steps == 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  }
}

// Stage s's mbarrier: armed by thread 0 for the B tile's TMA bytes.
template <int S, int BN>
__device__ __forceinline__ uint32_t stage_bar(const Ring<S, BN>& ring, int s) {
  return ring.bar + 8 * s;
}

// The forward / din loader: A = the tap-shifted pixel rows of `in`
// (K-major, GM rows of 64 channels), B = the tap's weights by TMA.
template <bool MIRROR, int TAPS = 9, int S = STAGES, int BN = GN>
struct ConvLoader {
  const Ring<S, BN>& ring;
  const CUtensorMap* wmap;
  const bf16* in;
  int H, W, K, p0, n0, steps, nk;
  int c, r0;           // this thread's 16-byte chunk and first row
  uint32_t a_off;      // its swizzled offset in the A tile
  int ry[4], rx[4];    // (y, x) of rows r0 + 32 i; y = -2 (off every tap) past the last pixel
  int tap = 0, kc = 0; // the next step to issue

  __device__ __forceinline__ ConvLoader(const Ring<S, BN>& ring_, const CUtensorMap* wmap_,
                                        const bf16* in_, int P, int H_, int W_, int K_, int p0_,
                                        int n0_)
      : ring(ring_), wmap(wmap_), in(in_), H(H_), W(W_), K(K_), p0(p0_), n0(n0_) {
    nk = (K + GK - 1) / GK;
    steps = TAPS * nk;
    c = threadIdx.x & 7;
    r0 = threadIdx.x >> 3;
    a_off = sw128(r0, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // once per block, 32-bit
      const int p = p0 + r0 + 32 * i;
      rx[i] = p < P ? p % W : 0;
      ry[i] = p < P ? (p / W) % H : -2;
    }
  }

  __device__ __forceinline__ void issue(int j) {
    if (j < steps) {
      const int s = j % S, t = TAPS == 1 ? 4 : tap, k0 = kc * GK;
      const int dy = t / 3 - 1, dx = t % 3 - 1;
      const bool k_ok = k0 + 8 * c < K;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = ry[i] + dy, x = rx[i] + dx;
        const bool ok = k_ok && y >= 0 && y < H && x >= 0 && x < W;
        const bf16* src =
            ok ? in + (long long)(p0 + r0 + 32 * i + dy * W + dx) * K + k0 + 8 * c : in;
        cp_async16(ring.a + s * TILE + a_off + i * 32 * 128, src, ok);
      }
      if (threadIdx.x == 0) {
        const uint32_t bar = stage_bar(ring, s), dst = ring.b + s * ring.BTILE;
        mbar_expect_tx(bar, ring.BTILE);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h) {
          if (MIRROR)  // w[8 - tap] rows n (Cin) of 64 k (Cout)
            tma_load_3d(dst + h * ATOM, wmap, bar, k0, n0 + 64 * h, TAPS == 1 ? 0 : 8 - tap);
          else  // w[tap] rows k (Cin) of 64 n (Cout)
            tma_load_3d(dst + h * ATOM, wmap, bar, n0 + 64 * h, k0, TAPS == 1 ? 0 : tap);
        }
      }
      if (++kc == nk) {
        kc = 0;
        ++tap;
      }
    }
    cp_async_commit();
  }
};

template <bool MIRROR, int S = STAGES, int BN = GN>
struct ConvMma {
  static_assert(BN == GN || !MIRROR, "64-column tiles: the forward products only");
  const Ring<S, BN>& ring;
  int wg;
  __device__ __forceinline__ void operator()(int s, float (&acc)[BN / 2], bool first) const {
    const uint32_t a = ring.a + s * TILE + wg * ATOM, b = ring.b + s * ring.BTILE;
#pragma unroll
    for (int k = 0; k < GK / 16; ++k) {
      const uint64_t da = wgmma_desc(a + 32 * k, 16, 1024);  // pixel rows: K-major
      if constexpr (BN == 64)  // Cin rows of 64 Cout values: MN-major, one atom
        wgmma_m64n64k16<0, 1>(acc, da, wgmma_desc(b + 2048 * k, ATOM, 1024), k > 0 || !first);
      else if constexpr (MIRROR)  // Cin rows of 64 Cout values: K-major
        wgmma_m64n128k16<0, 0>(acc, da, wgmma_desc(b + 32 * k, 16, 1024), k > 0 || !first);
      else  // Cin rows of 64 Cout values: N-contiguous, MN-major, two atoms
        wgmma_m64n128k16<0, 1>(acc, da, wgmma_desc(b + 2048 * k, ATOM, 1024), k > 0 || !first);
    }
  }
};

// Stores a warpgroup's 64 x BN float32 tile: rows row0 + (16 w + g + 8 h)
// (below `rows`) and columns col0 + 8 j + 2 t (+1) (below `cols`, a multiple
// of 8, so a pair is in or out together), + bias[col] when given.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], float* __restrict__ out,
                                           const float* __restrict__ bias, int row0, int rows,
                                           int col0, int cols) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = col0 + 8 * j + 2 * t;
    if (n < cols) {
      const float b0 = bias != nullptr ? bias[n] : 0.f, b1 = bias != nullptr ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * warp + g + 8 * h;
        if (r < rows)
          *reinterpret_cast<float2*>(out + (long long)r * cols + n) =
              make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
      }
    }
  }
}

// The block's product acc = sum over taps t and k of in[p shifted by t][k]
// B_t[k][n] for the warpgroup's 64 rows p0 + 64 wg.. and columns n0..n0+127:
// B_t = w[t] (forward: K = Cin, N = Cout) or w[8 - t] transposed (MIRROR,
// din: K = Cout, N = Cin); `wmap` is the 3-D map of w (Cout, Cin, TAPS).
// K and N are multiples of 8.
template <bool MIRROR, int TAPS = 9, int S = STAGES, int BN = GN>
__device__ __forceinline__ void conv_product(const Ring<S, BN>& ring, const CUtensorMap* wmap,
                                             const bf16* __restrict__ in, float (&acc)[BN / 2],
                                             int P, int H, int W, int K, int p0, int n0) {
  ConvLoader<MIRROR, TAPS, S, BN> ld(ring, wmap, in, P, H, W, K, p0, n0);
  const ConvMma<MIRROR, S, BN> mma{ring, (int)(threadIdx.x >> 7)};
  run_ring(ring, ld.steps, acc, ld, mma);
}

// The block's tile of out at rows p0.., columns n0..: out[p][n] (+ bias[n])
// = conv_product.
template <bool MIRROR, int TAPS = 9, int S = STAGES, int BN = GN>
__device__ __forceinline__ void conv_tile(const Ring<S, BN>& ring, const CUtensorMap* wmap,
                                          const bf16* __restrict__ in,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int P, int H, int W, int K,
                                          int N, int p0, int n0) {
  float acc[BN / 2];
  conv_product<MIRROR, TAPS, S, BN>(ring, wmap, in, acc, P, H, W, K, p0, n0);
  store_tile<BN>(acc, out, bias, p0 + 64 * (int)(threadIdx.x >> 7), P, n0, N);
}

// The dW loader of one tap and one split of the pixels: A = the
// tap-shifted a_in rows of 64 pixels, two 64-channel atoms (MN-major, Cin
// contiguous), B = the da rows by TMA (MN-major, Cout contiguous).
template <int S = STAGES>
struct WgradLoader {
  const Ring<S>& ring;
  const CUtensorMap* damap;
  const bf16* a_in;
  int H, W, Cin, ci0, co0, dy, dx, begin, end, steps;
  int c, r0;          // this thread's 16-byte chunk of its atom, first row
  uint32_t a_off;     // its swizzled offset in the A tile
  bool c_ok;          // its channels are below Cin
  int ry[4], rx[4];   // (y, x) of pixels q + r0 + 16 i of the next step q
  int sx, sy;         // GK pixels as a step in (y, x)
  int q;              // first pixel of the next step

  __device__ __forceinline__ WgradLoader(const Ring<S>& ring_, const CUtensorMap* damap_,
                                         const bf16* a_in_, int P, int H_, int W_, int Cin_,
                                         int per, int ci0_, int co0_, int z, int tap)
      : ring(ring_), damap(damap_), a_in(a_in_), H(H_), W(W_), Cin(Cin_), ci0(ci0_),
        co0(co0_) {
    dy = tap / 3 - 1;
    dx = tap % 3 - 1;
    begin = z * per * GK;
    end = min(P, begin + per * GK);
    steps = end > begin ? (end - begin + GK - 1) / GK : 0;
    const int cc = threadIdx.x & 15;  // atom cc / 8, chunk cc % 8
    c = cc & 7;
    r0 = threadIdx.x >> 4;
    a_off = (cc >> 3) * ATOM + sw128(r0, c);
    c_ok = ci0 + 8 * cc < Cin;
    q = begin;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // once per block, 32-bit
      const int p = begin + r0 + 16 * i;
      rx[i] = p % W;
      ry[i] = (p / W) % H;
    }
    sx = GK % W;
    sy = (GK / W) % H;
  }

  __device__ __forceinline__ void issue(int j) {
    if (j < steps) {
      const int s = j % S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = q + r0 + 16 * i, y = ry[i] + dy, x = rx[i] + dx;
        const bool ok = c_ok && p < end && y >= 0 && y < H && x >= 0 && x < W;
        const bf16* src =
            ok ? a_in + (long long)(p + dy * W + dx) * Cin + ci0 + 8 * (threadIdx.x & 15)
               : a_in;
        cp_async16(ring.a + s * TILE + a_off + i * 16 * 128, src, ok);
        rx[i] += sx;  // the same row of the next step: GK pixels on, no division
        ry[i] += sy;
        if (rx[i] >= W) {
          rx[i] -= W;
          ++ry[i];
        }
        if (ry[i] >= H) ry[i] -= H;
      }
      if (threadIdx.x == 0) {
        const uint32_t bar = stage_bar(ring, s), dst = ring.b + s * TILE;
        mbar_expect_tx(bar, TILE);
#pragma unroll
        for (int h = 0; h < 2; ++h) tma_load_2d(dst + h * ATOM, damap, bar, co0 + 64 * h, q);
      }
      q += GK;
    }
    cp_async_commit();
  }
};

template <int S = STAGES>
struct WgradMma {
  const Ring<S>& ring;
  int wg;
  __device__ __forceinline__ void operator()(int s, float (&acc)[64], bool first) const {
    const uint32_t a = ring.a + s * TILE + wg * ATOM, b = ring.b + s * TILE;
#pragma unroll
    for (int k = 0; k < GK / 16; ++k)  // both pixel rows of channels: MN-major
      wgmma_m64n128k16<1, 1>(acc, wgmma_desc(a + 2048 * k, ATOM, 1024),
                             wgmma_desc(b + 2048 * k, ATOM, 1024), k > 0 || !first);
  }
};

// The block's tile of out (Cin, Cout) at rows ci0.., columns co0..:
// out[ci][co] = sum over the pixels p of split z (`per` steps of GK pixels)
// of a_in[p shifted by tap][ci] da[p][co]; `damap` is the 2-D map of da
// (Cout, P). H = W = 1 with tap 4 is a plain token reduction.
template <int S = STAGES>
__device__ __forceinline__ void wgrad_tile(const Ring<S>& ring, const CUtensorMap* damap,
                                           const bf16* __restrict__ a_in,
                                           float* __restrict__ out, int P, int H, int W,
                                           int Cin, int Cout, int per, int ci0, int co0, int z,
                                           int tap) {
  WgradLoader<S> ld(ring, damap, a_in, P, H, W, Cin, per, ci0, co0, z, tap);
  const WgradMma<S> mma{ring, (int)(threadIdx.x >> 7)};
  float acc[64];
  run_ring(ring, ld.steps, acc, ld, mma);
  store_tile<GN>(acc, out, nullptr, ci0 + 64 * mma.wg, Cin, co0, Cout);
}

// Kernel 11's launch, shared with kernel 7's gradient products: din and dW
// in one launch, so that the two products' blocks share the SMs (one launch
// each leaves most SMs idle in dW's last wave). Blocks [0, din_blocks): din
// = the mirrored conv of da, tile (b / din_cols, b % din_cols), first since
// they are the longer (TAPS x Cout / GK steps); then dW's tiles, Cin tiles
// fastest, then Cout tiles, then the TAPS x splits (split, tap) pairs, each
// writing part[split][tap] (TAPS, Cin, Cout). TAPS = 1: the 1 x 1 products
// of a residual projection (din = da w^T, dW = a_in^T da; the centre tap).
// din_cols = ceil(Cin / GN), wgrad_ci = ceil(Cin / GM), wgrad_co = ceil(Cout
// / GN).
template <int TAPS>
__global__ void __launch_bounds__(GT, 1)
    bwd_wgmma_kernel(__grid_constant__ const CUtensorMap wmap,
                     __grid_constant__ const CUtensorMap damap, const bf16* __restrict__ da,
                     const bf16* __restrict__ a_in, float* __restrict__ din,
                     float* __restrict__ part, int P, int H, int W, int Cin, int Cout, int per,
                     int din_blocks, int din_cols, int wgrad_ci, int wgrad_co) {
  extern __shared__ uint8_t smem[];
  const Ring<> ring(smem);
  const int b = blockIdx.x;  // 32-bit, once per block
  if (b < din_blocks) {
    conv_tile<true, TAPS>(ring, &wmap, da, nullptr, din, P, H, W, Cout, Cin, b / din_cols * GM,
                          b % din_cols * GN);
  } else {
    const int w = b - din_blocks, tiles = wgrad_ci * wgrad_co, zt = w / tiles, t = w % tiles;
    wgrad_tile(ring, &damap, a_in, part + (long long)zt * Cin * Cout, P, H, W, Cin, Cout, per,
               t % wgrad_ci * GM, t / wgrad_ci * GN, zt / TAPS, TAPS == 1 ? 4 : zt % 9);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The 3-D map of w (taps, K, N) bf16: dims (N, K, taps), innermost first.
int weight_map(CUtensorMap* map, const void* w, int K, int N, int taps = 9) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  return bf16_tensor_map(map, w, 3, dims, strides);
}

// The 2-D map of a row-major bf16 (rows, cols) matrix: dims (cols, rows).
int rows_map(CUtensorMap* map, const void* m, long long rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows},
                   strides[1] = {(cuuint64_t)cols * 2};
  return bf16_tensor_map(map, m, 2, dims, strides);
}

// bwd_wgmma_kernel<TAPS> on the stream: din (P, Cin) float32 and the dW
// partials part (splits, TAPS, Cin, Cout) float32 of da (P, Cout) and a_in
// (P, Cin) bf16 with w (TAPS, Cin, Cout) bf16; dW's pixels in `splits`
// ranges of equal steps (the last may be short). Channel counts multiples of
// 8, operands 16-byte aligned.
template <int TAPS>
int bwd_products(const bf16* da, const bf16* a_in, const bf16* w, float* din, float* part, int P,
                 int H, int W, int Cin, int Cout, int splits, cudaStream_t stream) {
  CUtensorMap wmap, damap;
  int code = weight_map(&wmap, w, Cin, Cout, TAPS);
  if (code != 0) return code;
  if ((code = rows_map(&damap, da, P, Cout)) != 0) return code;
  const int steps = (P + GK - 1) / GK, per = (steps + splits - 1) / splits;
  const int din_cols = (Cin + GN - 1) / GN, din_blocks = (P + GM - 1) / GM * din_cols;
  const int wgrad_ci = (Cin + GM - 1) / GM, wgrad_co = (Cout + GN - 1) / GN;
  cudaError_t err = cudaFuncSetAttribute(bwd_wgmma_kernel<TAPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = din_blocks + wgrad_ci * wgrad_co * TAPS * splits;
  bwd_wgmma_kernel<TAPS><<<blocks, GT, SMEM, stream>>>(wmap, damap, da, a_in, din, part, P, H, W,
                                                       Cin, Cout, per, din_blocks, din_cols,
                                                       wgrad_ci, wgrad_co);
  return (int)cudaGetLastError();
}

}  // namespace
