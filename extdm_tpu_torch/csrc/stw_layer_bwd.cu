// Kernel 5 in bf16 on Hopper: the gradients of the whole PreNormSTW layer
// x + proj(softmax(rope(q) rope(k)^T + bias + mask) v), qkv = ChanLN(x) Wqkv,
// given only its input x and the output's cotangent g:
//
//   stw_layer_bwd_wgmma  replaces extdm_tpu/ops/pallas_stw.py _stw_bwd_padded
//                        (_make_stw_bwd_kernel; via _stw_bwd_impl,
//                        _fused_layer_bwd) for bf16 layers of up to 512
//                        channels (C a multiple of 32), dim_head 32, 4 or 8
//                        heads, N <= 64 tokens a window: dx, dgamma, dWqkv,
//                        dWproj, dbproj and dbias (heads, N, N).
//                        attention_bwd.cu's stw_layer_bwd keeps the float32
//                        check path.
//   temporal_layer_bwd_wgmma  kernel 6, the same design for the whole
//                        PreNormTemporalAttn layer x + h + Wout(attn(LN(h))),
//                        h = ChanLN(x): replaces pallas_stw.py
//                        _temporal_bwd_impl (_make_temporal_bwd_kernel) for
//                        bf16 layers of T <= 32 frames, up to 512 channels (C
//                        a multiple of 32), dim_head 32, 4 or 8 heads: dx,
//                        dgamma, dln_scale, dln_bias, dWqkv, dWout and dbias
//                        (heads, T, T). attention_bwd.cu's temporal_layer_bwd
//                        keeps float32 and the other shapes.
//
// The temporal layer runs the window kernel templated on the layer kind
// (TP) over tiles of two sequences of 32 frame slots read in place
// (temporal.cuh): ChanLN and then the inner LayerNorm recomputed in place
// (hn, not h, is the A operand and goes to h_tok for dWqkv), rope at the
// frame's position, each row tile against its own sequence's 32 keys (the
// bias tables (heads, 32, 32), -inf past T), dbias into one slice per block
// and sequence slot (two row tiles of a block share its elements). The
// per-token pass (3.) runs the LayerNorm backward (dhn ln_scale, with hn's
// statistics recomputed from x), adds g for the h residual, then the ChanLN
// backward, writing dx once; its partials are dgamma, dln_scale, dln_bias.
// The entry writes the operands from the caller's parameters into its one
// scratch buffer first (temporal_operands_kernel).
//
// Bound on the H100: operations (three times the forward's products) and,
// at level 0 of the KTH step, the bytes of the per-token intermediates the
// weight gradients need. The launches:
//   1. stw_bwd_window_kernel: one persistent block per SM walks the windows
//      of the padded, rolled volume, reading x and g in place by the rolled
//      coordinates (as kernel 1 does: pad tokens read as zeros, nothing
//      written for them). Per window:
//        - x and g rows by cp.async into 128-byte-swizzled tiles; ChanLN in
//          float32 (h = ChanLN(x) written back in place, bf16, and to
//          h_tok for dWqkv);
//        - dO = g Wproj (all heads) on wgmma in 128-column halves (64
//          columns a warpgroup: 32 accumulators a thread, which keeps the
//          attention's registers out of local memory), Wproj by TMA
//          (MN-major);
//        - per head pair: q/k/v = h Wqkv on wgmma (Wqkv by TMA, K-major;
//          the two warpgroups take 96 columns each), rounded, q scaled and
//          both rotated, as the forward; then on mma.sync (m16n8k16, float
//          accumulators), each warp one (head, 16-row tile):
//            query rows: S = q k^T + bias + mask, P = softmax with each
//              row's own max, O = P v (to o_tok for dWproj), dP = dO v^T,
//              D = rowsum(P dP), dS = P (dP - D) (dbias), dq = dS k;
//            key rows (S^T recomputed from the query rows' max and sum, as
//              FlashAttention's backward: no P or dS tile in shared memory):
//              dv = P^T dO, dk = dS^T q.
//          dq (rope undone, scaled), dk (rope undone) and dv go to dqkv.
//        Operands that a product reads transposed come by ldmatrix.trans
//        from the same row-major tiles. The rotary cos and sin are computed
//        where they are used (a table load in the middle of each chain cost
//        more). The window kernel is latency-bound: one 256-thread block an
//        SM (255 registers a thread), each pass a chain of dependent
//        products between barriers.
//      The weights stream through a ring of stages (one per 64-channel
//      block of the products) refilled as soon as a block barrier shows a
//      stage consumed, across window boundaries.
//   2. stw_bwd_dh_kernel: dh = dqkv Wqkv (tokens x C, float32) on
//      conv_ring.cuh's wgmma tile (one tap: a plain GEMM, Wqkv read in place
//      by TMA as (K = 3 hid) x (N = C), MN-major; 64-column tiles at C = 64).
//   3. ln_bwd_kernel: the ChanLN backward needs two row sums over all C,
//      mean(dxhat) and mean(dxhat xhat): 16 or 32 lanes a token, dh read
//      back from where launch 2 kept it (the two-round channel tiling reads
//      back rather than recomputes: not measured against recomputing), dx =
//      g + rstd (dxhat - m1 - xhat m2) written in place; dgamma and dbproj
//      as per-block partials. Its C <= 512 limit is the window kernel's
//      shared memory (h and g tiles of C columns).
//   4. stw_bwd_wgrad_kernel: dWqkv = dqkv^T h and dWproj = g^T o, token
//      reductions on conv_ring.cuh's wgrad_tile (M = channels, K = tokens,
//      MN-major operands), split over tokens, one partial per split.
//   5. sum_parts: the partials of dbias, the vectors and the weight
//      gradients added in a fixed order. A block's dbias partial takes its
//      windows' dS by reductions (red.global.add), each element owned by one
//      thread, so they land in program order: no two threads add to one
//      address, and the gradients repeat bit for bit.
// Rounding, as JAX's backward (pallas_stw.py _make_stw_bwd_kernel): q, k,
// v, P, dO and dS are bf16 operands of their products, the softmax and dS
// algebra float32; h, dqkv and o are cast to bf16 before the weight
// gradients, so the per-token intermediates are written in bf16.
#include "conv_ring.cuh"
#include "temporal.cuh"

namespace {

constexpr int ROWS = 64;       // a window's tokens, padded: one wgmma M tile
constexpr int BOX = 64 * 128;  // bytes of a 64 x 64 bf16 box / swizzled tile
constexpr int HEAD = 32;       // dim_head
constexpr int SMEM_MAX = 232448;
constexpr int STAGE_BOXES = 3;  // a ring stage: one head pair's q, k, v boxes (dO: two)

// The block's shared memory, in bytes from a 1024-aligned base: the h tile
// (nkp boxes), the g tile (then, aliased, the head pair's Q, K and V boxes),
// dO (hk boxes), the weight ring (stages of 3 boxes), its
// mbarriers, the window's token indices and each query row's softmax max,
// 1 / sum and D for the two heads of a pair. Its size is the stw_bwd_smem
// query's (fused_stw.stw_bwd_plan picks the ring's stages with it).
struct BwdPlan {
  int hid, nkp, hk, halves, pairs, steps, stages;
  unsigned a, gr, o, w, bar, row, stat, total;
  __host__ __device__ BwdPlan(int C, int heads, int stages_) : stages(stages_) {
    hid = heads * HEAD;
    nkp = (C + 63) / 64;
    hk = hid / 64;
    halves = hid / 128;  // dO in 128-column halves, 64 a warpgroup
    pairs = heads / 2;
    steps = nkp * (halves + pairs);  // dO's halves' K-blocks, then each pair's
    a = 0;
    gr = a + nkp * BOX;
    o = gr + (nkp > 3 ? nkp : 3) * BOX;
    w = o + hk * BOX;
    bar = w + stages * STAGE_BOXES * BOX;
    row = bar + 8 * stages;
    stat = row + ROWS * 4;
    total = stat + 2 * ROWS * 3 * 4 + 1024;  // + alignment of the base
  }
};

struct Args {
  const bf16* x;
  const bf16* g;
  bf16* h_tok;            // (tokens, C): h = ChanLN(x) (temporal: hn = LN(h)), for dWqkv
  bf16* o_tok;            // (tokens, hid): the heads' outputs, for dWproj
  bf16* dqkv;             // (tokens, 3 hid): dq | dk | dv
  float* bias_part;       // (gridDim, heads, N, N); temporal: (2 gridDim, heads, T, T)
  const float* gamma;     // (C)
  const float* ln_scale;  // temporal: the inner LayerNorm's (C); window: null
  const float* ln_bias;
  const bf16* bm;         // (M, heads, 64, 64): bf16(bias + mask m), -inf past N;
                          //   temporal: (heads, 32, 32), -inf past T
  const bf16* bmt;        // the same, transposed in its last two dims
  const int* mask_ids;    // (windows of one sample) or null: M = 1
  int T, H, W;            // x (B, T, H, W, C), unpadded; temporal: W = 1, H = a frame's pixels
  int D1, D2, D3;         // the padded volume: multiples of the window (temporal: 1)
  int st, sh, sw;         // the shift (the roll by -shift is read in place)
  int wd, wh, ww, nwin, C, rot, heads;  // temporal: window 1, nwin = tiles
  int nseq;               // temporal: B H sequences
  float eps;
};

// Token index in x of row r of window `win` of the padded volume rolled by
// -shift, or -1 for a pad token or past the window's tokens (kernel 1's
// addressing, stw_layer.cu token_offset, in tokens). Temporal: of row r of
// tile `win` (temporal.cuh seq_token).
template <bool TP>
__device__ __forceinline__ int token_index(const Args& a, int win, int r) {
  if constexpr (TP) return (int)seq_token(win, r, a.T, a.H, a.nseq);
  const int N = a.wd * a.wh * a.ww;
  if (r >= N) return -1;
  const int nWh = a.D2 / a.wh, nWw = a.D3 / a.ww, nW = (a.D1 / a.wd) * nWh * nWw;
  const int b = win / nW, wi = win % nW;
  const int td = wi / (nWh * nWw), th = (wi / nWw) % nWh, tw = wi % nWw;
  const int i0 = r / (a.wh * a.ww), i1 = (r / a.ww) % a.wh, i2 = r % a.ww;
  const int t = (td * a.wd + i0 + a.st) % a.D1, h = (th * a.wh + i1 + a.sh) % a.D2;
  const int w = (tw * a.ww + i2 + a.sw) % a.D3;
  if (t >= a.T || h >= a.H || w >= a.W) return -1;
  return ((b * a.T + t) * a.H + h) * a.W + w;
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8; register i of lane 4 r + c holds rows 2 c, 2 c + 1
// of column r of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// cos and sin of position r at dims d, d + 1 (d even, < rot): the angle r
// 10000^(-d / rot) of rotary_tables, the same for both dims of the pair;
// computed where it is needed rather than loaded from a table (a global
// load in the middle of each epilogue's chain cost more than the math).
__device__ __forceinline__ float4 rope_cs(int r, int d, int rot) {
  float s, c;
  __sincosf((float)r * exp2f(-13.287712379549449f * (float)d / (float)rot), &s, &c);
  return make_float4(c, s, c, s);
}

// One row's 32 columns c0..c0+31 held by a quad of lanes (lane 4 g + t has
// v[j] = the two bf16 at columns c0 + 8 j + 2 t, + 1), stored at dst (none
// when dst is null). Four-byte stores: gathering 16-byte chunks by shuffles
// within the quad measured slower (a longer chain at the end of each pass).
__device__ __forceinline__ void store_row32(bf16* dst, const uint32_t (&v)[4], int lane) {
  if (dst != nullptr)
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * (lane & 3)) = v[j];
}

// Shared address of element (r, c) of a row-major tile of 64-column
// 128-byte-swizzled boxes (c a multiple of 2).
__device__ __forceinline__ uint32_t at(uint32_t tile, int r, int c) {
  return tile + (c >> 6) * BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The A fragment of a 16 x 16 block at (r0, c0) of a row-major tile (r0 a
// multiple of 16, c0 of 8): a0 = (r0 + g, c0 + 2 t..), a1 = (r0 + g + 8, ..),
// a2, a3 the same 8 columns on.
__device__ __forceinline__ void a_frag(uint32_t tile, int r0, int c0, int g8, int t4,
                                       uint32_t (&a)[4]) {
  a[0] = ld_shared_u32(at(tile, r0 + g8, c0 + 2 * t4));
  a[1] = ld_shared_u32(at(tile, r0 + g8 + 8, c0 + 2 * t4));
  a[2] = ld_shared_u32(at(tile, r0 + g8, c0 + 8 + 2 * t4));
  a[3] = ld_shared_u32(at(tile, r0 + g8 + 8, c0 + 8 + 2 * t4));
}

// B of an 8-column tile n0.. over k0..k0+15 when the tile stores B^T row-major
// (rows n, k contiguous): b0 = (n0 + g, k0 + 2 t..), b1 = 8 k on.
__device__ __forceinline__ void b_frag(uint32_t tile, int n0, int k0, int g8, int t4,
                                       uint32_t& b0, uint32_t& b1) {
  b0 = ld_shared_u32(at(tile, n0 + g8, k0 + 2 * t4));
  b1 = ld_shared_u32(at(tile, n0 + g8, k0 + 8 + 2 * t4));
}

// acc[j] += A (16 x 16, fragment a) B for the four 8-column tiles of B at
// rows k0..k0+15 and columns c0..c0+31 of a row-major tile (rows k, n
// contiguous): B through ldmatrix.trans.
__device__ __forceinline__ void mma_trans_b(float (&acc)[4][4], const uint32_t (&a)[4],
                                            uint32_t tile, int k0, int c0, int lane) {
  const int kr = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_trans(at(tile, kr, c0 + 16 * half + 8 * (lane >> 4)), b0, b1, b2, b3);
    mma_bf16(acc[2 * half], a[0], a[1], a[2], a[3], b0, b1);
    mma_bf16(acc[2 * half + 1], a[0], a[1], a[2], a[3], b2, b3);
  }
}

// The A fragment of k-step kk from a 16 x 8 J float tile in C-fragment
// layout (columns 8 j + 2 t..): scores times `scale` per row half.
template <int J>
__device__ __forceinline__ void a_from_c(const float (&c)[J][4], int kk, float s0, float s1,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0] * s0, c[2 * kk][1] * s0);
  a[1] = pack_bf16(c[2 * kk][2] * s1, c[2 * kk][3] * s1);
  a[2] = pack_bf16(c[2 * kk + 1][0] * s0, c[2 * kk + 1][1] * s0);
  a[3] = pack_bf16(c[2 * kk + 1][2] * s1, c[2 * kk + 1][3] * s1);
}

// wgmma D (64 x 96) = A (64 x 16) B (16 x 96), both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                                bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"((int)accumulate));
}

// The rows of window `win` of `src` (x or g) into a tile at shared address
// dst (zero rows for pad tokens and past N); one cp.async group.
__device__ __forceinline__ void load_rows(const Args& a, const BwdPlan& p, const bf16* src,
                                          uint32_t dst, const int* row_tok) {
  const int cpr = p.nkp * 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * cpr; e += GT) {
    const int r = e / cpr, q = e % cpr, tok = row_tok[r];
    const bool ok = tok >= 0 && 8 * q < a.C;
    cp_async16(dst + (q >> 3) * BOX + sw128(r, q & 7),
               ok ? src + (long long)tok * a.C + 8 * q : src, ok);
  }
}

// Thread 0: the TMA boxes of window step i into dst on mbarrier bar: the
// dO steps (half i / nkp: Wproj rows of K-block i % nkp, columns of heads
// 4 half .. + 3, a box a warpgroup), then each head pair's (q, k, v rows of
// pair (i - d) / nkp at K-block (i - d) % nkp, d = the dO steps).
__device__ __forceinline__ void issue_step(const BwdPlan& p, const CUtensorMap* mq,
                                           const CUtensorMap* mp, int i, uint32_t dst,
                                           uint32_t bar) {
  const int d = p.nkp * p.halves;
  if (i < d) {
    const int hf = i / p.nkp, kb = i % p.nkp;
    mbar_expect_tx(bar, 2 * BOX);
#pragma unroll
    for (int b = 0; b < 2; ++b) tma_load_2d(dst + b * BOX, mp, bar, 64 * (2 * hf + b), 64 * kb);
  } else {
    const int j = i - d, pair = j / p.nkp, kb = j % p.nkp;
    mbar_expect_tx(bar, 3 * BOX);
#pragma unroll
    for (int which = 0; which < 3; ++which)
      tma_load_2d(dst + which * BOX, mq, bar, 64 * kb, which * p.hid + 64 * pair);
  }
}

template <bool TP>
__global__ void __launch_bounds__(GT, 1)
    stw_bwd_window_kernel(__grid_constant__ const CUtensorMap mq,
                          __grid_constant__ const CUtensorMap mp, const Args a, const BwdPlan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_addr(base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7, wl = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  // Window: N tokens in nt live 16-row tiles, each against all 2 nt live
  // 8-row tiles of the other side. Temporal (temporal.cuh): N = T; row tile
  // rt is sequence rt / 2's and runs against that sequence's nkt 8-row tiles
  // from kt0 = 4 (rt / 2); dbias goes to one slice per sequence slot.
  constexpr int NJT = TP ? SEQ / 8 : 8;
  constexpr int BMS = TP ? SEQ : ROWS;  // row stride of the bias tables
  const int N = TP ? a.T : a.wd * a.wh * a.ww, nt = (N + 15) / 16;
  const int nkt = TP ? (N + 7) / 8 : 2 * nt, nkk = TP ? (N + 15) / 16 : nt;
  const int nW = (a.D1 / a.wd) * (a.D2 / a.wh) * (a.D3 / a.ww);
  int* row_tok = reinterpret_cast<int*>(base + p.row);
  float* stat = reinterpret_cast<float*>(base + p.stat);  // [head of pair][row][max, 1/sum, D]
  const uint32_t bars = sb + p.bar, A = sb + p.a, G = sb + p.gr, O = sb + p.o;
  const uint32_t Q = G, K = G + BOX, V = G + 2 * BOX;  // the pair's tiles, over g's
  const int my = (a.nwin - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long long total = (long long)my * p.steps;
  const float qscale = rsqrtf((float)HEAD);
  const int hid = p.hid, hid3 = 3 * p.hid;
  const int slots = TP ? 2 : 1;  // dbias slices of the block
  float* bpart = a.bias_part + (long long)blockIdx.x * slots * a.heads * N * N;
  for (int e = tid; e < slots * a.heads * N * N; e += GT) bpart[e] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (long long gi = 0; gi < p.stages && gi < total; ++gi)
      issue_step(p, &mq, &mp, (int)(gi % p.steps), sb + p.w + (int)gi * STAGE_BOXES * BOX,
                 bars + 8 * (int)gi);

  long long gi = 0;  // the next step to consume
  auto acquire = [&]() -> uint32_t {
    const int s = (int)(gi % p.stages);
    mbar_wait(bars + 8 * s, (uint32_t)((gi / p.stages) & 1));
    return sb + p.w + s * STAGE_BOXES * BOX;
  };
  auto release = [&]() {  // every warpgroup is done with step gi: refill its slot
    __syncthreads();
    const long long nxt = gi + p.stages;
    const int s = (int)(gi % p.stages);
    if (tid == 0 && nxt < total)
      issue_step(p, &mq, &mp, (int)(nxt % p.steps), sb + p.w + s * STAGE_BOXES * BOX,
                 bars + 8 * s);
    ++gi;
  };

  for (int win = blockIdx.x; win < a.nwin; win += gridDim.x) {
    if (tid < ROWS) row_tok[tid] = token_index<TP>(a, win, tid);
    const int mrow = a.mask_ids != nullptr ? a.mask_ids[win % nW] : 0;
    __syncthreads();
    load_rows(a, p, a.x, A, row_tok);
    load_rows(a, p, a.g, G, row_tok);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- ChanLN in place, four threads a token (every 4th 16-byte chunk
    // each), float32 statistics; h rows also to h_tok
    {
      uint8_t* Ag = base + p.a;
      const int r = tid >> 2, q0 = tid & 3, nq = a.C / 8, tok = row_tok[r];
      float s = 0.f;
      for (int q = q0; q < nq; q += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(Ag + (q >> 3) * BOX + sw128(r, q & 7));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mean = s / a.C;
      float var = 0.f;
      for (int q = q0; q < nq; q += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(Ag + (q >> 3) * BOX + sw128(r, q & 7));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = __bfloat162float(e[i]) - mean;
          var += d * d;
        }
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      const float rstd = rsqrtf(var / a.C + a.eps);
      if (TP || tok >= 0) {  // pad tokens and rows past N stay zero
        float s2 = 0.f;  // temporal: the sum of h, for the inner LayerNorm
        for (int q = q0; q < nq; q += 4) {
          uint4* ptr = reinterpret_cast<uint4*>(Ag + (q >> 3) * BOX + sw128(r, q & 7));
          uint4 v = *ptr;
          bf16* e = reinterpret_cast<bf16*>(&v);
          const float4 g0 = __ldg(reinterpret_cast<const float4*>(a.gamma + 8 * q));
          const float4 g1 = __ldg(reinterpret_cast<const float4*>(a.gamma + 8 * q + 4));
          const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            e[i] = __float2bfloat16((__bfloat162float(e[i]) - mean) * rstd * gm[i]);
            s2 += __bfloat162float(e[i]);
          }
          *ptr = v;
          if (!TP) *reinterpret_cast<uint4*>(a.h_tok + (long long)tok * a.C + 8 * q) = v;
        }
        if constexpr (TP)  // hn = LN(h) in place and to h_tok (dWqkv's operand)
          inner_layer_norm(Ag, r, q0, a.C, s2, a.eps, a.ln_scale, a.ln_bias, tok >= 0,
                           tok >= 0 ? a.h_tok + (long long)tok * a.C : nullptr);
      }
    }
    fence_proxy_async();
    __syncthreads();

    // ---- dO = g Wproj^T over K = C in 128-column halves, 64 columns (two
    // heads) a warpgroup: 32 accumulators, not 64, so that the block's
    // long-lived registers stay out of local memory
    for (int hf = 0; hf < p.halves; ++hf) {
      float acc[32];
      for (int kb = 0; kb < p.nkp; ++kb) {
        const uint32_t B = acquire() + wg * BOX;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)  // B: rows c of 64 j, MN-major
          wgmma_m64n64k16<0, 1>(acc, wgmma_desc(G + kb * BOX + 32 * k, 16, 1024),
                                wgmma_desc(B + 2048 * k, BOX, 1024), kb > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          st_shared_u32(at(O, 16 * wl + g8 + 8 * hh, (2 * hf + wg) * 64 + 8 * j + 2 * t4),
                        pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
    }
    __syncthreads();  // dO complete; g's tile is free for Q, K, V

    for (int pr = 0; pr < p.pairs; ++pr) {
      // ---- q/k/v of heads 2 pr, 2 pr + 1: 64 x 192 over K = C, 96 columns
      // per warpgroup (wg 0: q, k of the first head; wg 1: k of the second, v)
      {
        float acc[48];
        for (int kb = 0; kb < p.nkp; ++kb) {
          const uint32_t B = acquire() + wg * 96 * 128;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_m64n96k16(acc, wgmma_desc(A + kb * BOX + 32 * k, 16, 1024),
                            wgmma_desc(B + 32 * k, 16, 1024), kb > 0 || k > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          release();
        }
        // epilogue: bf16 q (scaled, rotated), k (rotated), v into their tiles;
        // rows past N are zero and take no rotation
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int col = wg * 96 + 8 * j + 2 * t4, which = col >> 6, c = col & 63, d = c & 31;
          const uint32_t tile = which == 0 ? Q : which == 1 ? K : V;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * wl + g8 + 8 * hh;
            float v0 = round_to<bf16>(acc[4 * j + 2 * hh]);
            float v1 = round_to<bf16>(acc[4 * j + 2 * hh + 1]);
            if (which == 0) {
              v0 *= qscale;
              v1 *= qscale;
            }
            const int pos = TP ? r % SEQ : r;  // the token's position: its frame
            if (which < 2 && pos < N && d < a.rot) {
              const float4 cs = rope_cs(pos, d, a.rot);
              const float w0 = v0 * cs.x - v1 * cs.y, w1 = v1 * cs.z + v0 * cs.w;
              v0 = w0;
              v1 = w1;
            }
            st_shared_u32(at(tile, r, c), pack_bf16(v0, v1));
          }
        }
      }
      __syncthreads();

      const int hh = warp >> 2, h = 2 * pr + hh, rt = warp & 3, r0 = 16 * rt;
      const int qc = 32 * hh, oc = 32 * h;  // the head's columns in Q/K/V and in dO
      const int kt0 = TP ? 4 * (rt >> 1) : 0;  // the first 8-row tile of the other side
      const bool live = TP ? ((rt & 1) == 0 || N > 16) && 2 * win + (rt >> 1) < a.nseq : r0 < N;
      float* hstat = stat + hh * ROWS * 3;
      // ---- query rows r0..r0+15 of head h
      if (live) {
        const bf16* bmt = a.bm + (long long)(mrow * a.heads + h) * BMS * BMS;
        uint32_t bv[NJT][2];
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[jt][e] = __ldg(reinterpret_cast<const unsigned*>(
                bmt + ((r0 + g8 + 8 * e) % BMS) * BMS + 8 * jt + 2 * t4));
        float sc[NJT][4];
        {
          uint32_t qa[2][4];
          a_frag(Q, r0, qc, g8, t4, qa[0]);
          a_frag(Q, r0, qc + 16, g8, t4, qa[1]);
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[jt][e] = 0.f;
            if (jt < nkt) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                uint32_t b0, b1;
                b_frag(K, 8 * (kt0 + jt), qc + 16 * ks, g8, t4, b0, b1);
                mma_bf16(sc[jt], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b0, b1);
              }
            }
          }
        }
        float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // -inf from the table: a padding key or row
            const uint32_t pair = bv[jt][e >> 1];
            sc[jt][e] += __uint_as_float(e & 1 ? pair & 0xffff0000u : pair << 16);
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[jt][e]);
          }
        float inv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
          if (mx[e] == __int_as_float(0xff800000)) mx[e] = 0.f;  // padding row
          mx[e] *= LOG2E;
        }
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[jt][e] = ex2(fmaf(sc[jt][e], LOG2E, -mx[e >> 1]));  // exp(s - max)
            inv[e >> 1] += sc[jt][e];
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          inv[e] += __shfl_xor_sync(0xffffffffu, inv[e], 1);
          inv[e] += __shfl_xor_sync(0xffffffffu, inv[e], 2);
          inv[e] = inv[e] > 0.f ? 1.f / inv[e] : 0.f;
        }
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jt][e] *= inv[e >> 1];  // P, float32
        const int tok0 = row_tok[r0 + g8], tok1 = row_tok[r0 + g8 + 8];
        {  // O = P v -> o_tok
          float oc4[4][4] = {};
#pragma unroll
          for (int kk = 0; kk < NJT / 2; ++kk) {
            if (kk >= nkk) break;
            uint32_t pa[4];
            a_from_c(sc, kk, 1.f, 1.f, pa);
            mma_trans_b(oc4, pa, V, 8 * kt0 + 16 * kk, qc, lane);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = e ? tok1 : tok0;
            const uint32_t v[4] = {pack_bf16(oc4[0][2 * e], oc4[0][2 * e + 1]),
                                   pack_bf16(oc4[1][2 * e], oc4[1][2 * e + 1]),
                                   pack_bf16(oc4[2][2 * e], oc4[2][2 * e + 1]),
                                   pack_bf16(oc4[3][2 * e], oc4[3][2 * e + 1])};
            store_row32(tok >= 0 ? a.o_tok + (long long)tok * hid + oc : nullptr, v, lane);
          }
        }
        float dp[NJT][4];  // dP = dO v^T
        {
          uint32_t da[2][4];
          a_frag(O, r0, oc, g8, t4, da[0]);
          a_frag(O, r0, oc + 16, g8, t4, da[1]);
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[jt][e] = 0.f;
            if (jt < nkt) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                uint32_t b0, b1;
                b_frag(V, 8 * (kt0 + jt), qc + 16 * ks, g8, t4, b0, b1);
                mma_bf16(dp[jt], da[ks][0], da[ks][1], da[ks][2], da[ks][3], b0, b1);
              }
            }
          }
        }
        float D[2] = {0.f, 0.f};
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) D[e >> 1] += sc[jt][e] * dp[jt][e];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          D[e] += __shfl_xor_sync(0xffffffffu, D[e], 1);
          D[e] += __shfl_xor_sync(0xffffffffu, D[e], 2);
        }
        // dS = P (dP - D), in place of dP, added to dbias over the block's
        // windows: each element of the block's slice is this thread's alone,
        // so the adds (reductions in L2, nothing returned, nothing waited
        // for) land in program order, the same order every run
        float* bh = bpart + ((long long)(TP ? r0 / SEQ : 0) * a.heads + h) * N * N;
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dp[jt][e] = sc[jt][e] * (dp[jt][e] - D[e >> 1]);
            const int i = (r0 + g8 + 8 * (e >> 1)) % BMS, j = 8 * jt + 2 * t4 + (e & 1);
            if (i < N && j < N) atomicAdd(bh + i * N + j, dp[jt][e]);
          }
        if (t4 == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* s = hstat + (r0 + g8 + 8 * e) * 3;
            s[0] = mx[e];
            s[1] = inv[e];
            s[2] = D[e];
          }
        }
        {  // dq = dS k, rope undone, scaled -> dqkv
          float dq[4][4] = {};
#pragma unroll
          for (int kk = 0; kk < NJT / 2; ++kk) {
            if (kk >= nkk) break;
            uint32_t pa[4];
            a_from_c(dp, kk, 1.f, 1.f, pa);
            mma_trans_b(dq, pa, K, 8 * kt0 + 16 * kk, qc, lane);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = (r0 + g8 + 8 * e) % BMS, tok = e ? tok1 : tok0;
            uint32_t v[4];
#pragma unroll
            for (int jd = 0; jd < 4; ++jd) {
              const int d = 8 * jd + 2 * t4;
              float y0 = dq[jd][2 * e], y1 = dq[jd][2 * e + 1];
              if (d < a.rot) {
                const float4 cs = rope_cs(r, d, a.rot);
                const float w0 = y0 * cs.x + y1 * cs.w, w1 = y1 * cs.z - y0 * cs.y;
                y0 = w0;
                y1 = w1;
              }
              v[jd] = pack_bf16(y0 * qscale, y1 * qscale);
            }
            store_row32(tok >= 0 ? a.dqkv + (long long)tok * hid3 + oc : nullptr, v, lane);
          }
        }
      }
      __syncthreads();  // every query row's max, 1 / sum and D

      // ---- key rows k0..k0+15 of head h: S^T, P^T, dP^T, dS^T; dv, dk
      const int k0 = r0;
      if (live) {
        const bf16* bmt = a.bmt + (long long)(mrow * a.heads + h) * BMS * BMS;
        uint32_t bv[NJT][2];
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[jt][e] = __ldg(reinterpret_cast<const unsigned*>(
                bmt + ((k0 + g8 + 8 * e) % BMS) * BMS + 8 * jt + 2 * t4));
        // S^T and P^T first, dv from them; then dP^T, dS^T in its place and
        // dk: P^T and dP^T are live together only for dS^T
        float pt[NJT][4];
        {
          uint32_t ka[2][4];
          a_frag(K, k0, qc, g8, t4, ka[0]);
          a_frag(K, k0, qc + 16, g8, t4, ka[1]);
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) pt[jt][e] = 0.f;
            if (jt < nkt) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                uint32_t b0, b1;
                b_frag(Q, 8 * (kt0 + jt), qc + 16 * ks, g8, t4, b0, b1);
                mma_bf16(pt[jt], ka[ks][0], ka[ks][1], ka[ks][2], ka[ks][3], b0, b1);
              }
            }
          }
        }
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // column = query 8 (kt0 + jt) + 2 t + e % 2
            if (jt >= nkt) break;
            const uint32_t pair = bv[jt][e >> 1];
            const float* s = hstat + (8 * (kt0 + jt) + 2 * t4 + (e & 1)) * 3;
            const float sv = pt[jt][e] + __uint_as_float(e & 1 ? pair & 0xffff0000u : pair << 16);
            pt[jt][e] = ex2(fmaf(sv, LOG2E, -s[0])) * s[1];   // P^T
          }
        float dv[4][4] = {}, dk[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < NJT / 2; ++kk) {
          if (kk >= nkk) break;
          uint32_t pa[4];
          a_from_c(pt, kk, 1.f, 1.f, pa);
          mma_trans_b(dv, pa, O, 8 * kt0 + 16 * kk, oc, lane);
        }
        float dpt[NJT][4];
        {
          uint32_t va[2][4];
          a_frag(V, k0, qc, g8, t4, va[0]);
          a_frag(V, k0, qc + 16, g8, t4, va[1]);
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dpt[jt][e] = 0.f;
            if (jt < nkt) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                uint32_t b0, b1;
                b_frag(O, 8 * (kt0 + jt), oc + 16 * ks, g8, t4, b0, b1);
                mma_bf16(dpt[jt], va[ks][0], va[ks][1], va[ks][2], va[ks][3], b0, b1);
              }
            }
          }
        }
#pragma unroll
        for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (jt >= nkt) break;
            dpt[jt][e] = pt[jt][e] *
                         (dpt[jt][e] - hstat[(8 * (kt0 + jt) + 2 * t4 + (e & 1)) * 3 + 2]);
          }
#pragma unroll
        for (int kk = 0; kk < NJT / 2; ++kk) {
          if (kk >= nkk) break;
          uint32_t pa[4];
          a_from_c(dpt, kk, 1.f, 1.f, pa);
          mma_trans_b(dk, pa, Q, 8 * kt0 + 16 * kk, qc, lane);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = k0 + g8 + 8 * e, tok = row_tok[r];
          bf16* dst = tok >= 0 ? a.dqkv + (long long)tok * hid3 + oc : nullptr;
          uint32_t vk[4], vv[4];
#pragma unroll
          for (int jd = 0; jd < 4; ++jd) {
            const int d = 8 * jd + 2 * t4;
            float y0 = dk[jd][2 * e], y1 = dk[jd][2 * e + 1];
            if (d < a.rot) {
              const float4 cs = rope_cs(r % BMS, d, a.rot);
              const float w0 = y0 * cs.x + y1 * cs.w, w1 = y1 * cs.z - y0 * cs.y;
              y0 = w0;
              y1 = w1;
            }
            vk[jd] = pack_bf16(y0, y1);
            vv[jd] = pack_bf16(dv[jd][2 * e], dv[jd][2 * e + 1]);
          }
          store_row32(dst != nullptr ? dst + hid : nullptr, vk, lane);
          store_row32(dst != nullptr ? dst + 2 * hid : nullptr, vv, lane);
        }
      }
      __syncthreads();  // Q, K, V and the row statistics are the next pair's
    }
  }
}

// dh (tokens, C) float32 = dqkv (tokens, 3 hid) Wqkv (3 hid, C): kernel 10's
// tile with one tap. Grid: (ceil(tokens / GM), ceil(C / BN)). A 3-stage
// ring for its few reduction steps (3 hid / GK = 12 at 8 heads), as kernel
// 3's convs of few steps: two blocks an SM with 128-column tiles, three
// with 64 (C = 64).
template <int BN>
__global__ void __launch_bounds__(GT, BN == 64 ? 3 : 2)
    stw_bwd_dh_kernel(__grid_constant__ const CUtensorMap wmap, const bf16* __restrict__ dqkv,
                      float* __restrict__ dh, int tokens, int K, int C) {
  extern __shared__ uint8_t smem[];
  const Ring<3, BN> ring(smem);
  conv_tile<false, 1, 3, BN>(ring, &wmap, dqkv, nullptr, dh, tokens, 1, 1, K, C, blockIdx.x * GM,
                             blockIdx.y * BN);
}

template <int BN>
cudaError_t dh_product(const CUtensorMap& wmap, const bf16* dqkv, float* dh, int tokens, int K,
                       int C, cudaStream_t stream) {
  constexpr int bytes = ring_smem<3, BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      stw_bwd_dh_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  stw_bwd_dh_kernel<BN><<<dim3((tokens + GM - 1) / GM, (C + BN - 1) / BN), GT, bytes, stream>>>(
      wmap, dqkv, dh, tokens, K, C);
  return cudaGetLastError();
}

// The ChanLN backward, LPR lanes a token (32 / LPR tokens a warp at once):
// xhat = (x - mean) rstd (recomputed as the forward computes it), dxhat = dh
// gamma, dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat));
// part (gridDim, 2, C) = this block's sums of dh xhat (dgamma) and g
// (dbproj). Lane l of a token's LPR takes channels 4 (l + LPR i) .. + 3,
// i < CH (C a multiple of 32: a lane's four are in or out together), by 8-
// and 16-byte loads.
// TP, the temporal layer (kernel 6): dh is d(hn) and the pass runs the
// inner LayerNorm's backward first: h = bf16(xhat gamma) and hhat = LN(h)
// recomputed, dhhat = dhn ln_scale, dh = rstd2 (dhhat - mean(dhhat) - hhat
// mean(dhhat hhat)) + g (the h residual), then the ChanLN backward above;
// part (gridDim, 3, C) = sums of dh xhat (dgamma), dhn hhat (dln_scale) and
// dhn (dln_bias).
template <int CH, int LPR, bool TP>
__global__ void __launch_bounds__(GT) ln_bwd_kernel(const bf16* __restrict__ x,
                                                   const bf16* __restrict__ g,
                                                   const float* __restrict__ dh,
                                                   const float* __restrict__ gamma,
                                                   const float* __restrict__ ln_scale,
                                                   bf16* __restrict__ dx, float* __restrict__ part,
                                                   int tokens, int C, float eps) {
  constexpr int RPW = 32 / LPR;  // tokens a warp at once
  constexpr int NV = TP ? 3 : 2;  // the per-channel sums
  __shared__ float red[GT / 32][CH * 4 * LPR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, l = lane % LPR;
  auto row_sum = [](float v) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float sums[NV][CH][4] = {}, gm[CH][4], ls[CH][4];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = 4 * (l + LPR * i);
    const float4 v = c < C ? *reinterpret_cast<const float4*>(gamma + c) : make_float4(0, 0, 0, 0);
    gm[i][0] = v.x, gm[i][1] = v.y, gm[i][2] = v.z, gm[i][3] = v.w;
    if constexpr (TP) {
      const float4 w =
          c < C ? *reinterpret_cast<const float4*>(ln_scale + c) : make_float4(0, 0, 0, 0);
      ls[i][0] = w.x, ls[i][1] = w.y, ls[i][2] = w.z, ls[i][3] = w.w;
    }
  }
  const int stride = gridDim.x * (GT / 32) * RPW;
  // every lane runs the same number of iterations (the shuffles): rows past
  // the last token read and write nothing
  for (int t0 = (blockIdx.x * (GT / 32) + warp) * RPW; t0 < tokens; t0 += stride) {
    const int t = t0 + lane / LPR;
    const bool live = t < tokens;
    const long long row = (long long)(live ? t : 0) * C;
    float xv[CH][4], dv[CH][4], s = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 4 * (l + LPR * i);
      const bool ok = live && c < C;
      const uint2 xr = ok ? *reinterpret_cast<const uint2*>(x + row + c) : make_uint2(0, 0);
      const float4 d =
          ok ? *reinterpret_cast<const float4*>(dh + row + c) : make_float4(0, 0, 0, 0);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
      xv[i][0] = x01.x, xv[i][1] = x01.y, xv[i][2] = x23.x, xv[i][3] = x23.y;
      dv[i][0] = d.x, dv[i][1] = d.y, dv[i][2] = d.z, dv[i][3] = d.w;
      s += xv[i][0] + xv[i][1] + xv[i][2] + xv[i][3];
    }
    const float mean = row_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = 4 * (l + LPR * i) < C ? xv[i][e] - mean : 0.f;
        var += d * d;
      }
    const float rstd = rsqrtf(row_sum(var) / C + eps);
    float gv[CH][4];  // g (zero past C and past the last token)
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 4 * (l + LPR * i);
      const uint2 gr =
          live && c < C ? *reinterpret_cast<const uint2*>(g + row + c) : make_uint2(0, 0);
      const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.x));
      const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.y));
      gv[i][0] = g01.x, gv[i][1] = g01.y, gv[i][2] = g23.x, gv[i][3] = g23.y;
    }
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[i][e] = (xv[i][e] - mean) * rstd;  // xhat
    if constexpr (TP) {  // dv: dhn -> dh of h = ChanLN(x), the h residual's g included
      float hv[CH][4], s2 = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hv[i][e] = round_to<bf16>(xv[i][e] * gm[i][e]);  // h as the forward rounded it; 0 past C
          s2 += hv[i][e];
        }
      const float mean2 = row_sum(s2) / C;
      float var2 = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = 4 * (l + LPR * i) < C;
          hv[i][e] = in ? hv[i][e] - mean2 : 0.f;
          var2 += hv[i][e] * hv[i][e];
        }
      const float rstd2 = rsqrtf(row_sum(var2) / C + eps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hv[i][e] *= rstd2;  // hhat; dhn and ln_scale are 0 past C
          sums[1][i][e] += dv[i][e] * hv[i][e];
          sums[2][i][e] += dv[i][e];
          dv[i][e] *= ls[i][e];  // dhhat
          m1 += dv[i][e];
          m2 += dv[i][e] * hv[i][e];
        }
      m1 = row_sum(m1) / C;
      m2 = row_sum(m2) / C;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = 4 * (l + LPR * i) < C;
          dv[i][e] = in ? rstd2 * (dv[i][e] - m1 - hv[i][e] * m2) + gv[i][e] : 0.f;
        }
    }
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // gamma and dh are 0 past C
        sums[0][i][e] += dv[i][e] * xv[i][e];
        dv[i][e] *= gm[i][e];  // dxhat
        m1 += dv[i][e];
        m2 += dv[i][e] * xv[i][e];
      }
    m1 = row_sum(m1) / C;
    m2 = row_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = 4 * (l + LPR * i);
      if (live && c < C) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!TP) sums[1][i][e] += gv[i][e];  // dbproj
          o[e] = gv[i][e] + rstd * (dv[i][e] - m1 - xv[i][e] * m2);
        }
        *reinterpret_cast<uint2*>(dx + row + c) = make_uint2(pack_bf16(o[0], o[1]),
                                                             pack_bf16(o[2], o[3]));
      }
    }
  }
  // the warp's token slots own the same channels: add them, then the warps'
  // sums in order, one vector at a time
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          sums[v][i][e] += __shfl_xor_sync(0xffffffffu, sums[v][i][e], o);
        if (lane < LPR) red[warp][4 * (l + LPR * i) + e] = sums[v][i][e];
      }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += GT) {
      float s = 0.f;
      for (int w = 0; w < GT / 32; ++w) s += red[w][c];
      part[((long long)blockIdx.x * NV + v) * C + c] = s;
    }
    __syncthreads();
  }
}

// dWqkv = dqkv^T h and dWproj = g^T o in one launch: blocks [0, q_blocks)
// are dWqkv's tiles (3 hid tiles fastest, then C tiles, then the token
// splits), the rest dWproj's (C tiles, hid tiles, splits); each writes its
// split's partial (or the gradient itself with one split).
__global__ void __launch_bounds__(GT, 1)
    stw_bwd_wgrad_kernel(__grid_constant__ const CUtensorMap hmap,
                         __grid_constant__ const CUtensorMap omap, const bf16* __restrict__ dqkv,
                         const bf16* __restrict__ g, float* __restrict__ part_q,
                         float* __restrict__ part_p, int tokens, int hid, int C, int per_q,
                         int per_p, int q_blocks) {
  extern __shared__ uint8_t smem[];
  const Ring<> ring(smem);
  const int b = blockIdx.x;
  if (b < q_blocks) {
    const int mi = (3 * hid + GM - 1) / GM, ni = (C + GN - 1) / GN, tiles = mi * ni;
    const int z = b / tiles, t = b % tiles;
    wgrad_tile(ring, &hmap, dqkv, part_q + (long long)z * 3 * hid * C, tokens, 1, 1, 3 * hid, C,
               per_q, t % mi * GM, t / mi * GN, z, 4);
  } else {
    const int mi = (C + GM - 1) / GM, ni = (hid + GN - 1) / GN, tiles = mi * ni;
    const int w = b - q_blocks, z = w / tiles, t = w % tiles;
    wgrad_tile(ring, &omap, g, part_p + (long long)z * C * hid, tokens, 1, 1, C, hid, per_p,
               t % mi * GM, t / mi * GN, z, 4);
  }
}

template <int CH, int LPR, bool TP>
cudaError_t ln_bwd(const bf16* x, const bf16* g, const float* dh, const float* gamma,
                   const float* ln_scale, bf16* dx, float* part, int blocks, int tokens, int C,
                   float eps, cudaStream_t stream) {
  ln_bwd_kernel<CH, LPR, TP><<<blocks, GT, 0, stream>>>(x, g, dh, gamma, ln_scale, dx, part, tokens,
                                                        C, eps);
  return cudaGetLastError();
}

// C = 32 and 64: 8 and 16 lanes a token; else 32 lanes, 1 to 4 chunks of 128
template <bool TP>
cudaError_t ln_bwd_any(const bf16* x, const bf16* g, const float* dh, const float* gamma,
                       const float* ln_scale, bf16* dx, float* part, int blocks, int tokens, int C,
                       float eps, cudaStream_t s) {
  const float* ls = ln_scale;
  return C <= 32    ? ln_bwd<1, 8, TP>(x, g, dh, gamma, ls, dx, part, blocks, tokens, C, eps, s)
         : C <= 64  ? ln_bwd<1, 16, TP>(x, g, dh, gamma, ls, dx, part, blocks, tokens, C, eps, s)
         : C <= 128 ? ln_bwd<1, 32, TP>(x, g, dh, gamma, ls, dx, part, blocks, tokens, C, eps, s)
         : C <= 256 ? ln_bwd<2, 32, TP>(x, g, dh, gamma, ls, dx, part, blocks, tokens, C, eps, s)
                    : ln_bwd<4, 32, TP>(x, g, dh, gamma, ls, dx, part, blocks, tokens, C, eps, s);
}

// Launches 2-5 of either layer (the header's list): dh = dqkv Wqkv, the
// per-token pass (dx and the vectors' partials), dWqkv = dqkv^T h_tok and
// dWproj = g^T o_tok, and the sums of the partials. wmap: Wqkv as the dh
// product reads it; hmap, omap: h_tok and o_tok as the weight gradients read them.
template <bool TP>
int after_windows(const CUtensorMap& wmap, const CUtensorMap& hmap, const CUtensorMap& omap,
                  const bf16* x, const bf16* g, bf16* dx, const bf16* dqkv, float* dh,
                  const float* gamma, const float* ln_scale, float* vec_part, float* part_q,
                  float* part_p, float* vec_out, float* dwqkv, float* dwproj, int tokens, int C,
                  int hid, float eps, int ln_blocks, int splits_q, int splits_p, cudaStream_t s) {
  cudaError_t err;
  // 2. dh = dqkv Wqkv
  err = C <= 64 ? dh_product<64>(wmap, dqkv, dh, tokens, 3 * hid, C, s)
                : dh_product<GN>(wmap, dqkv, dh, tokens, 3 * hid, C, s);
  if (err != cudaSuccess) return (int)err;
  // 3. the norms' backward: dx and the vectors' partials
  err = ln_bwd_any<TP>(x, g, dh, gamma, ln_scale, dx, vec_part, ln_blocks, tokens, C, eps, s);
  if (err != cudaSuccess) return (int)err;
  if ((err = sum_parts(vec_part, ln_blocks, (TP ? 3LL : 2LL) * C, vec_out, s)) != cudaSuccess)
    return (int)err;
  // 4. dWqkv and dWproj
  const int steps = (tokens + GK - 1) / GK;
  const int per_q = (steps + splits_q - 1) / splits_q, per_p = (steps + splits_p - 1) / splits_p;
  const int q_blocks = (3 * hid + GM - 1) / GM * ((C + GN - 1) / GN) * splits_q;
  const int p_blocks = (C + GM - 1) / GM * ((hid + GN - 1) / GN) * splits_p;
  if ((splits_q > 1 && part_q == nullptr) || (splits_p > 1 && part_p == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(stw_bwd_wgrad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
      cudaSuccess)
    return (int)err;
  stw_bwd_wgrad_kernel<<<q_blocks + p_blocks, GT, SMEM, s>>>(
      hmap, omap, dqkv, g, splits_q == 1 ? dwqkv : part_q, splits_p == 1 ? dwproj : part_p,
      tokens, hid, C, per_q, per_p, q_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (splits_q > 1 && (err = sum_parts(part_q, splits_q, 3LL * hid * C, dwqkv, s)) != cudaSuccess)
    return (int)err;
  if (splits_p > 1 && (err = sum_parts(part_p, splits_p, (long long)C * hid, dwproj, s)) !=
                          cudaSuccess)
    return (int)err;
  return 0;
}

template <bool TP>
int window_kernel(const CUtensorMap& mq, const CUtensorMap& mp, const Args& a, const BwdPlan& p,
                  int grid, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      stw_bwd_window_kernel<TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (err != cudaSuccess) return (int)err;
  stw_bwd_window_kernel<TP><<<grid, GT, p.total, s>>>(mq, mp, a, p);
  return (int)cudaGetLastError();
}

// The temporal backward's scratch, carved in this order from the caller's
// buffer, each region 256-byte aligned (its size: temporal_bwd_scratch_bytes):
// the operands (temporal.cuh TemporalOperands), hn_tok (tokens, C), o_tok
// (tokens, hid), dqkv (tokens, 3 hid) bf16;
// dhn (tokens, C), bias_part (2 grid, heads, T, T), vec_part (ln_blocks, 3,
// C), part_q (splits_q, 3 hid, C) and part_p (splits_p, C, hid) float32
// (the last two empty with one split).
struct TemporalBwdScratch {
  TemporalOperands ops;
  size_t hn, o, dqkv, dh, bias, vec, pq, pp, total;
  TemporalBwdScratch(long long tokens, int C, int heads, int T, int grid, int ln_blocks,
                     int splits_q, int splits_p)
      : ops(C, heads) {
    size_t at = ops.total;
    auto take = [&at](size_t bytes) {
      const size_t off = at;
      at += (bytes + 255) / 256 * 256;
      return off;
    };
    const size_t hid = (size_t)heads * HEAD, n = (size_t)tokens;
    hn = take(n * C * 2);
    o = take(n * hid * 2);
    dqkv = take(n * 3 * hid * 2);
    dh = take(n * C * 4);
    bias = take(2ull * grid * heads * T * T * 4);
    vec = take(3ull * ln_blocks * C * 4);
    pq = take(splits_q > 1 ? (size_t)splits_q * 3 * hid * C * 4 : 0);
    pp = take(splits_p > 1 ? (size_t)splits_p * C * hid * 4 : 0);
    total = at;
  }
};

}  // namespace

// Bytes of the window kernel's dynamic shared memory (BwdPlan.total) for a
// layer of C channels and `heads` heads with a weight ring of `stages`
// stages; -1 for a layer the body does not take.
extern "C" long long stw_bwd_smem(int C, int heads, int stages) {
  if (C < 32 || C > 512 || C % 32 || heads < 4 || heads > 8 || heads % 4 || stages < 2) return -1;
  return BwdPlan(C, heads, stages).total;
}

// Bytes of the scratch temporal_layer_bwd_wgmma takes (TemporalBwdScratch);
// -1 for a layer it refuses.
extern "C" long long temporal_bwd_scratch_bytes(long long tokens, int C, int heads, int T,
                                                int grid, int ln_blocks, int splits_q,
                                                int splits_p) {
  if (tokens < 0 || C < 32 || C > 512 || C % 32 || heads < 4 || heads > 8 || heads % 4 || T < 1 ||
      T > SEQ || grid < 1 || ln_blocks < 1 || splits_q < 1 || splits_p < 1)
    return -1;
  return (long long)TemporalBwdScratch(tokens, C, heads, T, grid, ln_blocks, splits_q, splits_p)
      .total;
}

// x, g, dx (B, T, H, W, C) bf16, contiguous: the layer's input, the output's
// cotangent and the input's gradient, read and written in place of JAX's pad
// and roll by -shift (st, sh, sw); wqkv (3 hid, C), wproj (C, hid) bf16 in
// Linear layout; gamma (C) float32; bm and bmt (M, heads, 64, 64) bf16, the
// bias plus each of the M deduplicated shift masks, -inf past N, and its
// transpose in the last two dims; mask_ids (windows of one sample) int32 or
// null (M = 1); rot: the rotated dims of each head (rope computed in place).
// Scratch: h_tok (tokens, C), o_tok (tokens, hid) and dqkv (tokens, 3 hid)
// bf16; dh (tokens, C), bias_part (grid, heads, N, N), vec_part (ln_blocks,
// 2, C) float32; part_q (splits_q, 3 hid, C) and part_p (splits_p, C, hid)
// float32 (each unused, may be null, with one split). Out, float32: vec_out
// (dgamma | dbproj), bias_out (heads, N, N), dwqkv (3 hid, C), dwproj (C,
// hid). The plan's stages and smem and the grids come from
// fused_stw.stw_bwd_plan.
extern "C" int stw_layer_bwd_wgmma(const void* x, const void* g, void* dx, const void* wqkv,
                                   const void* wproj, const float* gamma, const void* bm,
                                   const void* bmt, const int* mask_ids,
                                   void* h_tok, void* o_tok, void* dqkv, float* dh,
                                   float* bias_part, float* vec_part, float* part_q,
                                   float* part_p, float* vec_out, float* bias_out, float* dwqkv,
                                   float* dwproj, int B, int T, int H, int W, int C, int wd,
                                   int wh, int ww, int st, int sh, int sw, int heads, int rot,
                                   float eps, int stages, int smem, int grid, int ln_blocks,
                                   int splits_q, int splits_p, void* stream) {
  const int N = wd * wh * ww;
  if (N < 1 || N > ROWS || heads < 4 || heads > 8 || heads % 4 || C < 32 || C > 512 || C % 32 ||
      rot % 2 || rot > HEAD || stages < 2 || grid < 1 || ln_blocks < 1 || splits_q < 1 ||
      splits_p < 1 || st < 0 || sh < 0 || sw < 0 ||
      (long long)B * T * H * W >= (1LL << 31) - GM)
    return (int)cudaErrorInvalidValue;
  const BwdPlan p(C, heads, stages);
  if ((int)p.total != smem || p.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int Tp = (T + wd - 1) / wd * wd, Hp = (H + wh - 1) / wh * wh, Wp = (W + ww - 1) / ww * ww;
  const int nwin = B * (Tp / wd) * (Hp / wh) * (Wp / ww), tokens = B * T * H * W;
  if (nwin == 0) return 0;
  const int hid = heads * HEAD;
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap mq, mp, mw, mh, mo;
  int code = rows_map(&mq, wqkv, 3 * hid, C);
  if (code == 0) code = rows_map(&mp, wproj, C, hid);
  if (code == 0) code = weight_map(&mw, wqkv, 3 * hid, C, 1);
  if (code == 0) code = rows_map(&mh, h_tok, tokens, C);
  if (code == 0) code = rows_map(&mo, o_tok, tokens, hid);
  if (code != 0) return code;
  const Args a{(const bf16*)x, (const bf16*)g, (bf16*)h_tok, (bf16*)o_tok, (bf16*)dqkv, bias_part,
               gamma, nullptr, nullptr, (const bf16*)bm, (const bf16*)bmt, mask_ids, T, H, W,
               Tp, Hp, Wp, st, sh, sw, wd, wh, ww, nwin, C, rot, heads, 0, eps};
  grid = grid < nwin ? grid : nwin;
  // 1. the windows
  if ((code = window_kernel<false>(mq, mp, a, p, grid, s)) != 0) return code;
  const cudaError_t err = sum_parts(bias_part, grid, (long long)heads * N * N, bias_out, s);
  if (err != cudaSuccess) return (int)err;
  return after_windows<false>(mw, mh, mo, (const bf16*)x, (const bf16*)g, (bf16*)dx,
                              (const bf16*)dqkv, dh, gamma, nullptr, vec_part, part_q, part_p,
                              vec_out, dwqkv, dwproj, tokens, C, hid, eps, ln_blocks, splits_q,
                              splits_p, s);
}

// x, g, dx (B, T, H W, C) bf16, contiguous: the temporal layer's input, the
// output's cotangent and the input's gradient; gamma, ln_scale, ln_bias (C)
// in vdtype, wqkv (3 hid, C) and wout (C, hid) in Linear layout in wdtype,
// bias (heads, T, T) in bdtype (0 float32, 1 bf16), contiguous: the
// parameters as the caller holds them. T <= 32. scratch: scratch_bytes of
// device memory (temporal_bwd_scratch_bytes). Out, float32: vec_out (dgamma |
// dln_scale | dln_bias), bias_out (heads, T, T), dwqkv (3 hid, C), dwout (C,
// hid). stages, smem, grid and ln_blocks come from fused_stw.temporal_bwd_plan,
// the splits from the conv engine's cost model (conv_engine.wgrad_splits).
extern "C" int temporal_layer_bwd_wgmma(const void* x, const void* g, void* dx, const void* gamma,
                                        const void* ln_scale, const void* ln_bias, int vdtype,
                                        const void* wqkv, const void* wout, int wdtype,
                                        const void* bias, int bdtype, void* scratch,
                                        long long scratch_bytes, float* vec_out, float* bias_out,
                                        float* dwqkv, float* dwout, int B, int T, int HW, int C,
                                        int heads, int rot, float eps, int stages, int smem,
                                        int grid, int ln_blocks, int splits_q, int splits_p,
                                        void* stream) {
  const long long tokens = (long long)B * T * HW;
  if (T < 1 || T > SEQ || HW < 1 || heads < 4 || heads > 8 || heads % 4 || C < 32 || C > 512 ||
      C % 32 || rot % 2 || rot > HEAD || stages < 2 || grid < 1 || ln_blocks < 1 ||
      splits_q < 1 || splits_p < 1 || (vdtype | wdtype | bdtype) & ~1 ||
      tokens >= (1LL << 31) - GM)
    return (int)cudaErrorInvalidValue;
  const BwdPlan p(C, heads, stages);
  if ((int)p.total != smem || p.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int nseq = B * HW, tiles = (nseq + 1) / 2;
  if (tiles == 0) return 0;
  grid = grid < tiles ? grid : tiles;
  const TemporalBwdScratch sc(tokens, C, heads, T, grid, ln_blocks, splits_q, splits_p);
  if ((long long)sc.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  const int hid = heads * HEAD;
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  const OperandPtrs d = sc.ops.at(base);
  cudaError_t err = temporal_operands(wqkv, wout, wdtype, gamma, ln_scale, ln_bias, vdtype, bias,
                                      bdtype, d, C, heads, T, s);
  if (err != cudaSuccess) return (int)err;
  bf16 *wq = d.wq, *wo = d.wo;
  bf16 *hn = (bf16*)(base + sc.hn), *o = (bf16*)(base + sc.o), *dqkv = (bf16*)(base + sc.dqkv);
  const float* vec = d.vec;
  float* bias_part = (float*)(base + sc.bias);
  CUtensorMap mq, mp, mw, mh, mo;
  int code = rows_map(&mq, wq, 3 * hid, C);
  if (code == 0) code = rows_map(&mp, wo, C, hid);
  if (code == 0) code = weight_map(&mw, wq, 3 * hid, C, 1);
  if (code == 0) code = rows_map(&mh, hn, tokens, C);
  if (code == 0) code = rows_map(&mo, o, tokens, hid);
  if (code != 0) return code;
  const Args a{(const bf16*)x, (const bf16*)g, hn, o, dqkv, bias_part, vec, vec + C, vec + 2 * C,
               d.bm, d.bmt, nullptr, T, HW,
               1, 1, 1, 1, 0, 0, 0, 1, 1, 1, tiles, C, rot, heads, nseq, eps};
  // 1. the tiles of two sequences
  if ((code = window_kernel<true>(mq, mp, a, p, grid, s)) != 0) return code;
  if ((err = sum_parts(bias_part, 2 * grid, (long long)heads * T * T, bias_out, s)) != cudaSuccess)
    return (int)err;
  return after_windows<true>(mw, mh, mo, (const bf16*)x, (const bf16*)g, (bf16*)dx, dqkv,
                             (float*)(base + sc.dh), vec, vec + C, (float*)(base + sc.vec),
                             splits_q > 1 ? (float*)(base + sc.pq) : nullptr,
                             splits_p > 1 ? (float*)(base + sc.pp) : nullptr, vec_out, dwqkv,
                             dwout, (int)tokens, C, hid, eps, ln_blocks, splits_q, splits_p, s);
}
