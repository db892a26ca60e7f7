// Kernels 1 and 2 in bf16 on Hopper: the whole PreNormSTW layer, x +
// proj(softmax(rope(q) rope(k)^T + bias + mask) v) with qkv = ChanLN(x) Wqkv,
// over 3-D windows of the padded, rolled (B, T, H, W, C) input; and the whole
// PreNormTemporalAttn layer, x + h + Wout(softmax(rope(q) rope(k)^T + bias) v)
// with h = ChanLN(x) and qkv = LN(h) Wqkv, attention over each pixel's T
// frames. One body, templated on where a tile's rows come from (Rows: the
// window layer's volume, the temporal layer's sequences, or pre-windowed
// tokens).
//
//   stw_layer_wgmma       replaces extdm_tpu/ops/pallas_stw.py fused_stw_layer
//                         (_fused_padded -> _make_kernel) for bf16 layers of
//                         up to 512 channels (C a multiple of 32), dim_head 32
//                         and 4 or 8 heads. attention.cu's stw_layer keeps the
//                         float32 check path and the other head shapes
//                         (C <= 256).
//   temporal_layer_wgmma  replaces pallas_stw.py fused_temporal_layer
//                         (_temporal_impl -> _make_temporal_kernel) for bf16
//                         layers of T <= 32 frames, up to 512 channels (C a
//                         multiple of 32), dim_head 32 and 4 or 8 heads.
//                         attention.cu's temporal_layer keeps float32 and the
//                         other shapes (C <= 256, T <= 64).
//   stw_layer_wm_wgmma    replaces pallas_stw.py fused_stw_layer_wm
//                         (_fused_padded_wm -> _make_kernel_wm): kernel 1's
//                         layer over pre-windowed tokens (B, nW, N, C), the
//                         same bf16 shapes; a tile is one window's N
//                         contiguous rows, and the shift masks come expanded
//                         per window (a bias + mask table each). attention.cu's
//                         stw_layer_wm keeps float32 and the other shapes.
//
// The temporal layer differs from the window layer in its rows, its norms
// and its residual (temporal.cuh): a tile is two sequences of 32 frame slots
// read in place from (B, T, H, W, C) (no pad of T, no permute; JAX's sequence
// packing, its packed bias and pair-swapped rope columns are Mosaic
// workarounds and are not copied); step 1 runs ChanLN and then the inner
// LayerNorm (ln_scale, ln_bias) in place, keeping each row's ChanLN mean and
// 1 / std so that step 5 recomputes h from x for the residual; rope takes the
// frame's position; step 4 runs each row tile against its own sequence's 32
// keys only (four 8-key tiles, not eight), the bias table (heads, 32, 32)
// with -inf past T; step 5 adds x + (h + bf16(O Wout^T)), no output bias.
// The entry first writes the operands in the layout the body reads (bf16
// weights, float32 vectors, the bias table) from the caller's tensors into
// the caller's scratch (temporal_operands_kernel): one call from Python.
//
// Bound on the H100: operations. Per token the layer does 2 C 3 hd + 2 hd C
// flops of projections and 4 N hd of attention (hd = heads x 32 = 256,
// N <= 64) against 2 C bytes in and out. A block owns one window of N <= 64
// tokens (a 64-row tile) at a time and walks the windows persistently (one
// block per SM). Per window:
//   1. x's rows arrive by 16-byte cp.async (zero rows past N) into a
//      128-byte-swizzled K-major tile, prefetched one window ahead where
//      shared memory allows; ChanLN statistics in float32, four threads per
//      row, and the normalised bf16 tile written back in place: the A operand.
//   2. q/k/v for four heads at a time on wgmma: each warpgroup takes one
//      head pair, a 64 x 192 product (q, k, v of two heads) over K = C.
//      Wqkv is read in place, K-major from its Linear layout (out, in), in
//      64 x 64 boxes by TMA completing on mbarriers.
//   3. The product's epilogue rounds to bf16, scales q, applies the rotary
//      embedding (its pairs are neighbours in a thread's fragment) and
//      writes bf16 q into the output tile O (q of a head is read only by the
//      warp that overwrites it with that head's output), k row-major and v
//      transposed: nothing goes back to float in shared memory.
//   4. Attention for every (head, 16-row tile) of the four heads across all
//      8 warps: mma.sync m16n8k16, the scores in registers, each row's own
//      max, P as the A operand of P v. Bias and mask come as one bf16 table
//      of bias + mask per distinct mask (the reference adds them and casts
//      to the compute type), 64 x 64 with -inf past N so that padding keys
//      and rows need no test: one 4-byte load per pair of scores, issued
//      before the score product so that its latency hides under it.
//   5. The output projection as a second wgmma product, O (64 x hd) x
//      Wproj^T in column chunks of CW per warpgroup (Wproj K-major by TMA);
//      the epilogue adds b_proj and the residual x and writes bf16 once.
//      Tiling the output over channels keeps no output tile in registers
//      across heads: C goes to 512.
// Weights: at C = 64 all of Wqkv and Wproj (128 KB) stay resident in shared
// memory for every window a block takes (loaded once by TMA); above, they
// stream through a ring of 48 KB stages (a head pair's q/k/v boxes for each
// warpgroup), refilled as soon as a block barrier shows a stage consumed,
// and the ring runs across window boundaries so the next window's weights
// arrive under this window's tail. The layout, ring depth and resident or
// streamed weights come from the host's plan (ops/fused_stw.py stw_plan);
// the kernel recomputes the layout from the same fields and refuses a plan
// whose size disagrees. The pad and roll of the shifted layers, and their
// inverses, are not copies here: each window row's token is found in the
// unpadded input by its rolled coordinates (pad tokens read as zeros and
// are not written), so the layer reads x and writes its output once.
#include "temporal.cuh"

namespace {

constexpr int NT = 256;            // two warpgroups
constexpr int ROWS = 64;           // a window's tokens, padded: one wgmma M tile
constexpr int BOX = 64 * 128;      // bytes of a 64 x 64 bf16 box / swizzled tile
constexpr int QKV_STEP = 6 * BOX;  // one q/k/v step: two head pairs' q, k, v boxes
constexpr int HEAD = 32;           // dim_head
constexpr int SMEM_MAX = 232448;

// The block's shared memory, in bytes from a 1024-aligned base, and the
// steps of one window: groups x nkp q/k/v steps (head group, 64-channel
// K-block), then rounds x hk output steps (column round, 64-wide K-block of
// the heads' outputs). Mirrors fused_stw.stw_plan.
// The temporal layer's plan adds each row's ChanLN mean and 1 / std after
// the row offsets (temporal_smem, fused_stw.temporal_plan).
struct Plan {
  int hid, nkp, cw, rounds, groups, hk, qkv_steps, steps, pboxes, resident, stages, a_bufs;
  unsigned a, o, k, vt, w, bar, row, stat, total;
  __host__ __device__ Plan(int C, int heads, int cw_, int resident_, int stages_, int a_bufs_,
                           bool temporal = false)
      : cw(cw_), resident(resident_), stages(stages_), a_bufs(a_bufs_) {
    hid = heads * HEAD;
    nkp = (C + 63) / 64;
    rounds = (C + 2 * cw - 1) / (2 * cw);
    groups = heads / 4;
    hk = hid / 64;
    qkv_steps = groups * nkp;
    steps = qkv_steps + rounds * hk;
    pboxes = 2 * cw / 64 < nkp ? 2 * cw / 64 : nkp;
    a = 0;
    o = a + a_bufs * nkp * BOX;
    k = o + hk * BOX;
    vt = k + 2 * BOX;
    w = vt + 2 * BOX;
    bar = w + (resident ? qkv_steps * QKV_STEP + rounds * hk * pboxes * BOX : stages * QKV_STEP);
    row = bar + 8 * (resident ? 1 : stages);
    stat = row + ROWS * 8;
    total = stat + (temporal ? ROWS * 8 : 0) + 1024;  // + alignment of the base
  }
  // Output boxes of column round rho (64 channels each, up to 2 cw / 64).
  __device__ __forceinline__ int round_boxes(int rho) const {
    const int first = rho * (2 * cw / 64), n = nkp - first;
    return n < 2 * cw / 64 ? n : 2 * cw / 64;
  }
  // Where window step i sits: its own place when resident, else ring slot gi % stages.
  __device__ __forceinline__ unsigned step_off(int i, long long gi) const {
    if (resident)
      return w + (i < qkv_steps ? i * QKV_STEP
                                : qkv_steps * QKV_STEP + (i - qkv_steps) * pboxes * BOX);
    return w + (unsigned)(gi % stages) * QKV_STEP;
  }
};

struct Args {
  const bf16* x;
  bf16* out;
  const float* gamma;     // (C)
  const float* bproj;     // (C); temporal: null
  const bf16* bm;         // (M, heads, 64, 64): bf16(bias + mask m), -inf past N;
                          //   temporal: (heads, 32, 32), -inf past T
  const int* mask_ids;    // (windows of one sample) or null: M = 1
  const float4* rope;     // (N, rot / 2): cos, sin of dims 2 i and 2 i + 1 (temporal: T)
  const float* ln_scale;  // temporal: the inner LayerNorm's (C); window: null
  const float* ln_bias;
  int T, H, W;              // the layer input x (B, T, H, W, C), unpadded; temporal: W = 1,
                            //   H = the pixels of a frame
  int D1, D2, D3;            // the padded volume: multiples of the window (temporal: 1)
  int st, sh, sw;            // the shift (the roll by -shift is read in place)
  int wd, wh, ww, nwin, C, rot, heads;  // temporal: window 1, nwin = tiles
  int nseq;                  // temporal: B H sequences
  float eps;
};

// Where a tile's rows come from: the window layer's padded, rolled volume
// (kernel 1), two pixels' frame sequences (kernel 2), or one window's N
// contiguous rows of pre-windowed tokens (B, nW, N, C) (kernel 9; its Args
// describe them as windows (N, 1, 1) of a (B, nW N, 1, 1) volume).
enum Rows { kWindow, kTemporal, kWindowMajor };

// Element offset in x of row r of window `win` of the padded volume rolled
// by -shift (JAX's pad and roll, read in place: token (t, h, w) of the
// rolled volume is (t + st, h + sh, w + sw) mod the padded sizes of the
// padded one), or -1 for a pad token or past the window's tokens. Temporal:
// of row r of tile `win` (temporal.cuh seq_token). Window-major: row r of
// window `win`'s N rows.
template <int R>
__device__ __forceinline__ long long token_offset(const Args& a, int win, int r) {
  if constexpr (R == kTemporal) {
    const long long tok = seq_token(win, r, a.T, a.H, a.nseq);
    return tok < 0 ? -1 : tok * a.C;
  }
  if constexpr (R == kWindowMajor) return r < a.wd ? ((long long)win * a.wd + r) * a.C : -1;
  const int N = a.wd * a.wh * a.ww;
  if (r >= N) return -1;
  const int nWh = a.D2 / a.wh, nWw = a.D3 / a.ww, nW = (a.D1 / a.wd) * nWh * nWw;
  const int b = win / nW, wi = win % nW;
  const int td = wi / (nWh * nWw), th = (wi / nWw) % nWh, tw = wi % nWw;
  const int i0 = r / (a.wh * a.ww), i1 = (r / a.ww) % a.wh, i2 = r % a.ww;
  const int t = (td * a.wd + i0 + a.st) % a.D1, h = (th * a.wh + i1 + a.sh) % a.D2;
  const int w = (tw * a.ww + i2 + a.sw) % a.D3;
  if (t >= a.T || h >= a.H || w >= a.W) return -1;  // a pad token: zero, not written
  return (((b * (long long)a.T + t) * a.H + h) * a.W + w) * a.C;
}

// The rows of window `win` into the A tile at shared address dst; one cp.async group.
template <int R>
__device__ __forceinline__ void load_x(const Args& a, const Plan& p, uint32_t dst, int win) {
  const int cpr = p.nkp * 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * cpr; e += NT) {
    const int r = e / cpr, q = e % cpr;
    const long long off = token_offset<R>(a, win, r);
    const bool ok = off >= 0 && 8 * q < a.C;
    cp_async16(dst + (q >> 3) * BOX + sw128(r, q & 7), ok ? a.x + off + 8 * q : a.x, ok);
  }
  cp_async_commit();
}

// Thread 0: the TMA boxes of window step i into dst, on mbarrier bar (armed
// for the step's bytes when `arm`).
__device__ __forceinline__ void issue_step(const Plan& p, const CUtensorMap* mq,
                                           const CUtensorMap* mp, int i, uint32_t dst,
                                           uint32_t bar, bool arm) {
  if (i < p.qkv_steps) {
    const int g = i / p.nkp, kb = i % p.nkp;
    if (arm) mbar_expect_tx(bar, QKV_STEP);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int which = 0; which < 3; ++which)  // q, k, v rows of head pair 2 g + w
        tma_load_2d(dst + (3 * w + which) * BOX, mq, bar, 64 * kb,
                    which * p.hid + 64 * (2 * g + w));
  } else {
    const int j = i - p.qkv_steps, rho = j / p.hk, kb = j % p.hk;
    const int nb = p.round_boxes(rho), first = rho * (2 * p.cw / 64);
    if (arm) mbar_expect_tx(bar, nb * BOX);
    for (int b = 0; b < nb; ++b) tma_load_2d(dst + b * BOX, mp, bar, 64 * kb, 64 * (first + b));
  }
}

template <int CW, int R>
__global__ void __launch_bounds__(NT, 1)
    stw_wgmma_kernel(__grid_constant__ const CUtensorMap mq, __grid_constant__ const CUtensorMap mp,
                     const Args a, const Plan p) {
  constexpr bool TP = R == kTemporal;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the swizzle atoms; derived from smem_raw by pointer
  // arithmetic so the compiler keeps shared-space (32-bit) addressing
  uint8_t* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_addr(base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7, wl = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  // Window: N tokens in nt live 16-row tiles, each row against all 2 nt live
  // 8-key tiles. Temporal: N = T frames; row tile rt belongs to sequence
  // rt / 2 and runs against that sequence's nkt 8-key tiles from kt0 = 4 (rt / 2).
  constexpr int NJT = TP ? SEQ / 8 : 8;        // 8-key tiles a row tile attends
  constexpr int BMS = TP ? SEQ : ROWS;         // row stride of the bias table
  const int N = TP ? a.T : a.wd * a.wh * a.ww, nt = (N + 15) / 16;
  const int nkt = TP ? (N + 7) / 8 : 2 * nt, nkk = TP ? (N + 15) / 16 : nt;
  const int nW = (a.D1 / a.wd) * (a.D2 / a.wh) * (a.D3 / a.ww);
  long long* row_s = reinterpret_cast<long long*>(base + p.row);
  float2* stat_s = reinterpret_cast<float2*>(base + p.stat);  // temporal: ChanLN mean, 1 / std
  const uint32_t bars = sb + p.bar;
  const int my = (a.nwin - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long long total = (long long)my * p.steps;
  const float qscale = rsqrtf((float)HEAD);

  if (tid == 0) {
    for (int s = 0; s < (p.resident ? 1 : p.stages); ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && my > 0) {
    if (p.resident) {  // every step's boxes once, on one barrier
      unsigned bytes = p.qkv_steps * QKV_STEP;
      for (int rho = 0; rho < p.rounds; ++rho) bytes += p.hk * p.round_boxes(rho) * BOX;
      mbar_expect_tx(bars, bytes);
      for (int i = 0; i < p.steps; ++i)
        issue_step(p, &mq, &mp, i, sb + p.step_off(i, 0), bars, false);
    } else {
      for (long long gi = 0; gi < p.stages && gi < total; ++gi)
        issue_step(p, &mq, &mp, (int)(gi % p.steps), sb + p.step_off(0, gi),
                   bars + 8 * (int)gi, true);
    }
  }
  if (my > 0) load_x<R>(a, p, sb + p.a, blockIdx.x);

  long long gi = 0;  // the next step to consume
  // Waits for step gi's boxes; returns their shared address.
  auto acquire = [&](int i) -> uint32_t {
    if (p.resident) {
      mbar_wait(bars, 0);
    } else {
      mbar_wait(bars + 8 * (int)(gi % p.stages), (uint32_t)((gi / p.stages) & 1));
    }
    return sb + p.step_off(i, gi);
  };
  // After every warpgroup has finished with step gi: refill its ring slot.
  auto release = [&]() {
    if (!p.resident) {
      __syncthreads();
      const long long nxt = gi + p.stages;
      if (tid == 0 && nxt < total)
        issue_step(p, &mq, &mp, (int)(nxt % p.steps), sb + p.step_off(0, nxt),
                   bars + 8 * (int)(gi % p.stages), true);
    }
    ++gi;
  };

  int it = 0;
  for (int win = blockIdx.x; win < a.nwin; win += gridDim.x, ++it) {
    const int next = win + gridDim.x;
    const uint32_t A = sb + p.a + (p.a_bufs == 2 ? (it & 1) : 0) * p.nkp * BOX;
    uint8_t* Ag = base + (A - sb);
    if (p.a_bufs == 2 && next < a.nwin) {
      load_x<R>(a, p, sb + p.a + ((it + 1) & 1) * p.nkp * BOX, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < ROWS) row_s[tid] = token_offset<R>(a, win, tid);
    const int mrow = a.mask_ids != nullptr ? a.mask_ids[win % nW] : 0;
    // whether 16-row tile rt has live rows (a sequence's second tile needs T > 16)
    auto live_tile = [&](int rt) {
      return TP ? ((rt & 1) == 0 || N > 16) && 2 * win + (rt >> 1) < a.nseq : rt < nt;
    };
    __syncthreads();

    // ---- 1. ChanLN in place: four threads per token (every 4th 16-byte
    // chunk each), float32 statistics; rows past N stay zero
    {
      const int r = tid >> 2, q0 = tid & 3, nq = a.C / 8;
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
      if (TP || r < N) {
        float s2 = 0.f;  // temporal: the sum of h = ChanLN(x), for the inner LayerNorm
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
        }
        if constexpr (TP) {  // hn = LN(h) in place; the row's ChanLN statistics for step 5
          inner_layer_norm(Ag, r, q0, a.C, s2, a.eps, a.ln_scale, a.ln_bias, row_s[r] >= 0,
                           nullptr);
          if (q0 == 0) stat_s[r] = make_float2(mean, rstd);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    for (int g = 0; g < p.groups; ++g) {
      // ---- 2. q/k/v of head pair 2 g + wg: 64 x 192 over K = C
      float acc[96];
      for (int kb = 0; kb < p.nkp; ++kb) {
        const uint32_t B = acquire(g * p.nkp + kb) + wg * 3 * BOX;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n192k16<0, 0>(acc, wgmma_desc(A + kb * BOX + 32 * k, 16, 1024),
                                 wgmma_desc(B + 32 * k, 16, 1024), kb > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release();
      }
      // ---- 3. epilogue: bf16 q (scaled, rotated) into O, k (rotated), v^T.
      // Fragment tile jq = 4 lp + jd of a section (q: tiles 0-7 of acc, k:
      // 8-15, v: 16-23) holds dims 8 jd + 2 t4 (+1) of head 4 g + 2 wg + lp,
      // rows r = 16 wl + g8 (+8), so r % 8 == g8: q lands in O's 64-column
      // block 2 g + wg and k in K's block wg, both at chunk jq; v^T rows
      // 64 wg + 8 jq + 2 t4 (+1), whose swizzle key is 2 t4 (+1). Rows past
      // N are zero (so are their products) and take no rotation.
      {
        const uint32_t qrow = sb + p.o + (2 * g + wg) * BOX + (16 * wl + g8) * 128 + 4 * t4;
        const uint32_t krow = sb + p.k + wg * BOX + (16 * wl + g8) * 128 + 4 * t4;
#pragma unroll
        for (int jd = 0; jd < 4; ++jd)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * wl + g8 + 8 * hh, d = 8 * jd + 2 * t4;
            const int pos = TP ? r % SEQ : r;  // the token's position: its frame
            float4 cs = make_float4(1.f, 0.f, 1.f, 0.f);  // c0, s0, c1, s1
            if (pos < N && d < a.rot) cs = __ldg(a.rope + pos * (a.rot / 2) + d / 2);
#pragma unroll
            for (int lp = 0; lp < 2; ++lp) {
              const int jq = 4 * lp + jd, e = 4 * jq + 2 * hh;
              const uint32_t at = ((jq ^ g8) << 4) + hh * 8 * 128;
              const float q0 = round_to<bf16>(acc[e]) * qscale;
              const float q1 = round_to<bf16>(acc[e + 1]) * qscale;
              st_shared_u32(qrow + at, pack_bf16(q0 * cs.x - q1 * cs.y, q1 * cs.z + q0 * cs.w));
              const float k0 = round_to<bf16>(acc[32 + e]), k1 = round_to<bf16>(acc[32 + e + 1]);
              st_shared_u32(krow + at, pack_bf16(k0 * cs.x - k1 * cs.y, k1 * cs.z + k0 * cs.w));
            }
          }
        const uint32_t vrow = sb + p.vt + (64 * wg + 2 * t4) * 128 + 2 * g8;
#pragma unroll
        for (int jq = 0; jq < 8; ++jq)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 64 + 4 * jq + 2 * hh, rc = 2 * wl + hh;  // the key's 16-byte chunk
            const uint32_t row = vrow + jq * 8 * 128;
            st_shared_u16(row + ((rc ^ (2 * t4)) << 4),
                          __bfloat16_as_ushort(__float2bfloat16(acc[e])));
            st_shared_u16(row + 128 + ((rc ^ (2 * t4 + 1)) << 4),
                          __bfloat16_as_ushort(__float2bfloat16(acc[e + 1])));
          }
      }
      __syncthreads();
      if (g == p.groups - 1 && p.a_bufs == 1 && next < a.nwin)
        load_x<R>(a, p, sb + p.a, next);  // the A tile is free: the next window's rows

      // ---- 4. attention: (local head, 16-row tile) units over the 8 warps;
      // warp w takes head 4 g + w % 4, row tiles w / 4 and w / 4 + 2
      {
        const int lh = warp & 3, h = 4 * g + lh;
        // bf16 bias + mask of this thread's scores in both units, pairs of
        // keys, in flight before the first score product; the table is
        // 64 x 64 with -inf past N
        const bf16* bmt = a.bm + (long long)(mrow * a.heads + h) * BMS * BMS;
        uint32_t bvs[2][NJT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (live_tile((warp >> 2) + 2 * i)) {
#pragma unroll
            for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                bvs[i][jt][hh] = __ldg(reinterpret_cast<const unsigned*>(
                    bmt + ((16 * ((warp >> 2) + 2 * i) + g8 + 8 * hh) % BMS) * BMS + 8 * jt +
                    2 * t4));
          }
        // Every fragment row below is congruent to g8 mod 8, so its swizzled
        // 16-byte chunk is (chunk ^ g8): addresses are a base plus constants.
        const uint32_t kbase = sb + p.k + (lh >> 1) * BOX + g8 * 128 + 4 * t4;
        const uint32_t vbase = sb + p.vt + (lh * HEAD + g8) * 128 + 4 * t4;
        const int hq = 4 * (h & 1), kq = 4 * (lh & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rt = (warp >> 2) + 2 * i, r0 = 16 * rt;
          if (!live_tile(rt)) break;  // then neither is the unit two tiles on
          const int kt0 = TP ? 4 * (rt >> 1) : 0;  // the row's first 8-key tile
          const uint32_t(&bv)[NJT][2] = bvs[i];
          const uint32_t obase = sb + p.o + (h >> 1) * BOX + (r0 + g8) * 128 + 4 * t4;
          uint32_t qa[2][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const uint32_t c0 = ((hq + 2 * ks) ^ g8) << 4, c1 = ((hq + 2 * ks + 1) ^ g8) << 4;
            qa[ks][0] = ld_shared_u32(obase + c0);
            qa[ks][1] = ld_shared_u32(obase + 8 * 128 + c0);
            qa[ks][2] = ld_shared_u32(obase + c1);
            qa[ks][3] = ld_shared_u32(obase + 8 * 128 + c1);
          }
          float sc[NJT][4];
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[jt][e] = 0.f;
            if (jt < nkt) {
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                const uint32_t row = kbase + (kt0 + jt) * 1024;
                const uint32_t b0 = ld_shared_u32(row + (((kq + 2 * ks) ^ g8) << 4));
                const uint32_t b1 = ld_shared_u32(row + (((kq + 2 * ks + 1) ^ g8) << 4));
                mma_bf16(sc[jt], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b0, b1);
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
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {  // a row lives in the 4 lanes sharing g8
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            if (mx[hh] == __int_as_float(0xff800000)) mx[hh] = 0.f;  // padding row
            mx[hh] *= LOG2E;
          }
#pragma unroll
          for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[jt][e] = ex2(fmaf(sc[jt][e], LOG2E, -mx[e >> 1]));  // exp(s - max)
              sum[e >> 1] += sc[jt][e];
            }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
            sum[hh] = sum[hh] > 0.f ? 1.f / sum[hh] : 0.f;
          }
          float oc[4][4];
#pragma unroll
          for (int jd = 0; jd < 4; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) oc[jd][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NJT / 2; ++kk) {  // 16 keys a step: score tiles 2 kk, 2 kk + 1
            if (kk >= nkk) break;
            const uint32_t a0 = pack_bf16(sc[2 * kk][0] * sum[0], sc[2 * kk][1] * sum[0]);
            const uint32_t a1 = pack_bf16(sc[2 * kk][2] * sum[1], sc[2 * kk][3] * sum[1]);
            const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0] * sum[0], sc[2 * kk + 1][1] * sum[0]);
            const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2] * sum[1], sc[2 * kk + 1][3] * sum[1]);
            const uint32_t c0 = ((kt0 + 2 * kk) ^ g8) << 4, c1 = ((kt0 + 2 * kk + 1) ^ g8) << 4;
#pragma unroll
            for (int jd = 0; jd < 4; ++jd) {
              const uint32_t row = vbase + jd * 1024;
              mma_bf16(oc[jd], a0, a1, a2, a3, ld_shared_u32(row + c0), ld_shared_u32(row + c1));
            }
          }
#pragma unroll
          for (int jd = 0; jd < 4; ++jd) {
            const uint32_t c = ((hq + jd) ^ g8) << 4;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              st_shared_u32(obase + hh * 8 * 128 + c,
                            pack_bf16(oc[jd][2 * hh], oc[jd][2 * hh + 1]));
          }
        }
      }
      fence_proxy_async();  // O is read by the output product's wgmma
      __syncthreads();
    }

    // ---- 5. out = x + O Wproj^T + b_proj (temporal: x + (h + O Wout^T)), CW
    // columns per warpgroup a round
    for (int rho = 0; rho < p.rounds; ++rho) {
      const int c0 = rho * 2 * CW + wg * CW;
      const bool active = c0 < a.C;
      float acc[CW / 2];
      for (int kb = 0; kb < p.hk; ++kb) {
        const uint32_t B = acquire(p.qkv_steps + rho * p.hk + kb) + wg * (CW / 64) * BOX;
        if (active) {
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint64_t da = wgmma_desc(sb + p.o + kb * BOX + 32 * k, 16, 1024);
            const uint64_t db = wgmma_desc(B + 32 * k, 16, 1024);
            if constexpr (CW == 64)
              wgmma_m64n64k16<0, 0>(acc, da, db, kb > 0 || k > 0);
            else
              wgmma_m64n128k16<0, 0>(acc, da, db, kb > 0 || k > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        release();
      }
      if (active) {  // every residual and bias (temporal: gamma) load in flight before the stores
        const long long off0 = row_s[16 * wl + g8], off1 = row_s[16 * wl + g8 + 8];
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(a.x);
        __nv_bfloat162 xv[CW / 8][2];
        float2 bv[CW / 8];
        const float* bvec = TP ? a.gamma : a.bproj;
        float2 st[2] = {};
        if constexpr (TP) st[0] = stat_s[16 * wl + g8], st[1] = stat_s[16 * wl + g8 + 8];
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
          const int c = c0 + 8 * j + 2 * t4;
          const bool ok = c < a.C;
          bv[j] = ok ? __ldg(reinterpret_cast<const float2*>(bvec + c)) : make_float2(0.f, 0.f);
          xv[j][0] = ok && off0 >= 0 ? __ldg(x2 + (off0 + c) / 2) : __nv_bfloat162();
          xv[j][1] = ok && off1 >= 0 ? __ldg(x2 + (off1 + c) / 2) : __nv_bfloat162();
        }
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
          const int c = c0 + 8 * j + 2 * t4;
          if (c >= a.C) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const long long off = hh ? off1 : off0;
            if (off < 0) continue;
            const int e = 4 * j + 2 * hh;
            const float x0 = __low2float(xv[j][hh]), x1 = __high2float(xv[j][hh]);
            float y0, y1;
            if constexpr (TP) {  // h recomputed as step 1 rounded it; x + (h + o) in float32
              const float h0 = round_to<bf16>((x0 - st[hh].x) * st[hh].y * bv[j].x);
              const float h1 = round_to<bf16>((x1 - st[hh].x) * st[hh].y * bv[j].y);
              y0 = x0 + (h0 + round_to<bf16>(acc[e]));
              y1 = x1 + (h1 + round_to<bf16>(acc[e + 1]));
            } else {
              y0 = x0 + round_to<bf16>(acc[e] + bv[j].x);
              y1 = x1 + round_to<bf16>(acc[e + 1] + bv[j].y);
            }
            *reinterpret_cast<uint32_t*>(a.out + off + c) = pack_bf16(y0, y1);
          }
        }
      }
    }
    __syncthreads();  // row_s, stat_s, O and (one A buffer) are the next window's
  }
}

template <int CW, int R>
int launch(const CUtensorMap& mq, const CUtensorMap& mp, const Args& a, const Plan& p, int grid,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      stw_wgmma_kernel<CW, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.total);
  if (err != cudaSuccess) return (int)err;
  stw_wgmma_kernel<CW, R><<<grid, NT, p.total, stream>>>(mq, mp, a, p);
  return (int)cudaGetLastError();
}

// The plan's checks shared by both entries.
bool plan_ok(int C, int heads, int rot, int cw, int resident, int stages, int a_bufs, int grid) {
  return !(heads < 4 || heads > 8 || heads % 4 || C < 32 || C > 512 || C % 32 || rot % 2 ||
           rot > HEAD || (cw != 64 && cw != 128) || (a_bufs != 1 && a_bufs != 2) ||
           (!resident && stages < 1) || grid < 1);
}

// The TMA maps of Wqkv (3 hid, C) and Wproj / Wout (C, hid), bf16.
int weight_maps(CUtensorMap* mq, CUtensorMap* mp, const void* wqkv, const void* wproj, int C,
                int hid) {
  const cuuint64_t dq[2] = {(cuuint64_t)C, (cuuint64_t)(3 * hid)}, sq[1] = {(cuuint64_t)C * 2};
  const cuuint64_t dp[2] = {(cuuint64_t)hid, (cuuint64_t)C}, sp[1] = {(cuuint64_t)hid * 2};
  const int err = bf16_tensor_map(mq, wqkv, 2, dq, sq);
  return err != 0 ? err : bf16_tensor_map(mp, wproj, 2, dp, sp);
}

}  // namespace

// x, out (B, T, H, W, C) bf16, contiguous: the layer's input and output,
// read and written in place of JAX's pad and roll by -shift (st, sh, sw)
// and their inverses; wqkv (3 heads 32, C), wproj (C, heads 32) bf16 in Linear layout;
// gamma, bproj (C) float32; bm (M, heads, 64, 64) bf16, the bias plus each
// of the M deduplicated shift masks, -inf past N, and mask_ids (windows of
// one sample) int32, or null when M = 1; rope (N, rot / 2, 4)
// float32: cos and sin of each dim pair. The
// plan's fields (cw, resident, stages, a_bufs), its shared-memory bytes and
// the grid (persistent blocks) come from fused_stw.stw_plan.
extern "C" int stw_layer_wgmma(const void* x, void* out, const float* gamma, const void* wqkv,
                               const void* wproj, const float* bproj, const void* bm,
                               const int* mask_ids, const float* rope, int B, int T, int H, int W,
                               int C, int wd, int wh, int ww, int st, int sh, int sw, int heads,
                               int rot, float eps, int cw, int resident, int stages, int a_bufs,
                               int smem, int grid, void* stream) {
  const int N = wd * wh * ww;
  if (N < 1 || N > ROWS || !plan_ok(C, heads, rot, cw, resident, stages, a_bufs, grid))
    return (int)cudaErrorInvalidValue;
  const Plan p(C, heads, cw, resident, stages, a_bufs);
  if ((int)p.total != smem || p.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int Tp = (T + wd - 1) / wd * wd, Hp = (H + wh - 1) / wh * wh, Wp = (W + ww - 1) / ww * ww;
  if (st < 0 || sh < 0 || sw < 0) return (int)cudaErrorInvalidValue;
  const int nwin = B * (Tp / wd) * (Hp / wh) * (Wp / ww);
  if (nwin == 0) return 0;
  const int hid = heads * HEAD;
  CUtensorMap mq, mp;
  const int err = weight_maps(&mq, &mp, wqkv, wproj, C, hid);
  if (err != 0) return err;
  const Args a{(const bf16*)x, (bf16*)out, gamma, bproj, (const bf16*)bm, mask_ids,
               (const float4*)rope, nullptr, nullptr, T, H, W, Tp, Hp, Wp, st, sh, sw, wd, wh,
               ww, nwin, C, rot, heads, 0, eps};
  grid = grid < nwin ? grid : nwin;
  if (cw == 64) return launch<64, kWindow>(mq, mp, a, p, grid, (cudaStream_t)stream);
  return launch<128, kWindow>(mq, mp, a, p, grid, (cudaStream_t)stream);
}

// Kernel 9 in bf16: the same layer over pre-windowed tokens. x, out (B, nW,
// N, C) bf16, contiguous: a window's N tokens are N contiguous rows, read
// and written in place; bm (M, heads, 64, 64) as for stw_layer_wgmma, with
// mask_ids (nW) int32 naming each window's table (one table a window for
// the expanded masks), or null when M = 1; the rest as stw_layer_wgmma's
// (fused_stw.stw_plan).
extern "C" int stw_layer_wm_wgmma(const void* x, void* out, const float* gamma, const void* wqkv,
                                  const void* wproj, const float* bproj, const void* bm,
                                  const int* mask_ids, const float* rope, int B, int nW, int N,
                                  int C, int heads, int rot, float eps, int cw, int resident,
                                  int stages, int a_bufs, int smem, int grid, void* stream) {
  if (N < 1 || N > ROWS || nW < 0 || !plan_ok(C, heads, rot, cw, resident, stages, a_bufs, grid))
    return (int)cudaErrorInvalidValue;
  const Plan p(C, heads, cw, resident, stages, a_bufs);
  if ((int)p.total != smem || p.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int nwin = B * nW;
  if (nwin == 0) return 0;
  CUtensorMap mq, mp;
  const int err = weight_maps(&mq, &mp, wqkv, wproj, C, heads * HEAD);
  if (err != 0) return err;
  const Args a{(const bf16*)x, (bf16*)out, gamma, bproj, (const bf16*)bm, mask_ids,
               (const float4*)rope, nullptr, nullptr, nW, 1, 1, nW * N, 1, 1, 0, 0, 0, N, 1, 1,
               nwin, C, rot, heads, 0, eps};
  grid = grid < nwin ? grid : nwin;
  if (cw == 64) return launch<64, kWindowMajor>(mq, mp, a, p, grid, (cudaStream_t)stream);
  return launch<128, kWindowMajor>(mq, mp, a, p, grid, (cudaStream_t)stream);
}

// Bytes of the temporal body's dynamic shared memory (Plan.total) for C
// channels, `heads` heads and the plan's fields; -1 for a layer it refuses.
extern "C" long long temporal_smem(int C, int heads, int cw, int resident, int stages,
                                   int a_bufs) {
  if (!plan_ok(C, heads, 0, cw, resident, stages, a_bufs, 1)) return -1;
  return Plan(C, heads, cw, resident, stages, a_bufs, true).total;
}

// Bytes of the scratch temporal_layer_wgmma takes (temporal.cuh TemporalOperands).
extern "C" long long temporal_scratch_bytes(int C, int heads) {
  if (C < 32 || C > 512 || C % 32 || heads < 4 || heads > 8 || heads % 4) return -1;
  return (long long)TemporalOperands(C, heads).total;
}

// The first launch of both temporal entries alone, into the caller's
// tensors wq (3 hid, C), wo (C, hid), bm, bmt (heads, 32, 32) bf16 and vec (3
// C) float32: a check of the operands against fused_stw.temporal_operands_plain.
extern "C" int temporal_operands_only(const void* wqkv, const void* wout, int wdtype,
                                      const void* gamma, const void* ln_scale,
                                      const void* ln_bias, int vdtype, const void* bias,
                                      int bdtype, void* wq, void* wo, float* vec, void* bm,
                                      void* bmt, int C, int heads, int T, void* stream) {
  if (T < 1 || T > SEQ || C < 1 || heads < 1 || (vdtype | wdtype | bdtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const OperandPtrs d{(bf16*)wq, (bf16*)wo, vec, (bf16*)bm, (bf16*)bmt};
  return (int)temporal_operands(wqkv, wout, wdtype, gamma, ln_scale, ln_bias, vdtype, bias,
                                bdtype, d, C, heads, T, (cudaStream_t)stream);
}

// x, out (B, T, H W, C) bf16, contiguous: the layer's input and output;
// gamma, ln_scale, ln_bias (C) in vdtype, wqkv (3 hid, C) and wout (C, hid)
// in Linear layout in wdtype, bias (heads, T, T) in bdtype (0 float32, 1
// bf16), all contiguous: the parameters as the caller holds them, written
// into scratch (temporal_scratch_bytes) in the body's layout first; rope (T,
// rot / 2, 4) float32: cos and sin of each dim pair. T <= 32. The plan's
// fields, its shared-memory bytes and the grid (persistent blocks) come from
// fused_stw.temporal_plan.
extern "C" int temporal_layer_wgmma(const void* x, void* out, const void* gamma,
                                    const void* ln_scale, const void* ln_bias, int vdtype,
                                    const void* wqkv, const void* wout, int wdtype,
                                    const void* bias, int bdtype, const float* rope, void* scratch,
                                    int B, int T, int HW, int C, int heads, int rot, float eps,
                                    int cw, int resident, int stages, int a_bufs, int smem,
                                    int grid, void* stream) {
  if (T < 1 || T > SEQ || HW < 1 || !plan_ok(C, heads, rot, cw, resident, stages, a_bufs, grid) ||
      (vdtype | wdtype | bdtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const Plan p(C, heads, cw, resident, stages, a_bufs, true);
  if ((int)p.total != smem || p.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int nseq = B * HW, tiles = (nseq + 1) / 2;
  if (tiles == 0) return 0;
  const int hid = heads * HEAD;
  cudaStream_t s = (cudaStream_t)stream;
  const OperandPtrs d = TemporalOperands(C, heads).at(static_cast<uint8_t*>(scratch));
  cudaError_t e = temporal_operands(wqkv, wout, wdtype, gamma, ln_scale, ln_bias, vdtype, bias,
                                    bdtype, d, C, heads, T, s);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mp;
  const int err = weight_maps(&mq, &mp, d.wq, d.wo, C, hid);
  if (err != 0) return err;
  const float* vec = d.vec;
  const Args a{(const bf16*)x, (bf16*)out, vec, nullptr, d.bm, nullptr,
               (const float4*)rope, vec + C, vec + 2 * C, T, HW, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1,
               tiles, C, rot, heads, nseq, eps};
  grid = grid < tiles ? grid : tiles;
  if (cw == 64) return launch<64, kTemporal>(mq, mp, a, p, grid, s);
  return launch<128, kTemporal>(mq, mp, a, p, grid, s);
}
