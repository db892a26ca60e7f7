// Backward of the whole attention layers of the diffusion UNet, given only
// the layer's inputs and the output's cotangent g:
//
//   stw_layer_bwd       replaces extdm_tpu/ops/pallas_stw.py _stw_bwd_padded
//                       (kernel _make_stw_bwd_kernel; via _stw_bwd_impl,
//                       _fused_layer_bwd): dx, dgamma, dWqkv, dWproj, dbproj and
//                       dbias (heads, N, N) of x + proj(attn(rope(ChanLN(x) Wqkv))).
//   temporal_layer_bwd  replaces pallas_stw.py _temporal_bwd_impl (kernel
//                       _make_temporal_bwd_kernel; via _fused_temporal_bwd): dx,
//                       dgamma_cln, dLN scale, dLN bias, dWqkv, dWout and dbias
//                       (heads, T, T) of x + a + attn(LN(a)), a = ChanLN(x).
//
// Bound on the H100: operations. A backward given only the inputs recomputes
// the forward's products and takes two products for each (the gradient of
// its input and of its weight), three times the forward's work.
//
// Design. One thread block owns one window (or the T-frame sequences of
// 64 / T pixels, as in the forward) at a time and walks over windows in a
// grid-stride loop, so that each block keeps one slice of partial sums.
// Per window it loads x and g once, recomputes the norms, and per head
// recomputes q/k/v, rope and P = softmax(q k^T + bias + mask) with a true
// per-row max, rounding where the forward rounds (q/k/v, P and the head
// output in the activation type). It then forms dO = g Wproj_h, dv = P^T dO,
// dS = P (dO v^T - rowsum(dO o)), dq = dS k and dk = dS^T q with rope undone,
// and adds [dq dk dv] Wqkv_h into the gradient of the normalised input, held
// in registers across heads. The norm backward(s) and the residual(s) follow
// in the epilogue, which writes dx once.
//
// Sums over windows run in two passes, with no atomics, so the result is
// deterministic:
//   - dbias and the per-channel vectors (dgamma, dbproj / dLN scale, dLN bias)
//     go into the block's own slice of a partial-sum buffer, read-modify-write
//     (only that block touches it); sum_parts adds the slices in order.
//   - dWqkv = h^T dqkv and dWproj = g^T o are products over every token. The
//     window kernel writes per-token dqkv, o and h (the q/k/v product's input)
//     to device memory, and atb_kernel takes the products split over tokens,
//     each split into its own partial buffer, summed in order by sum_parts.
// All products are float FMAs in this first version (operands in the
// activation type, sums in float32); the tensor cores are later work.
//
// Limits (the wrapper checks them): rows <= 64, dh <= 32, C <= 256.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KC = 32;   // channel chunk of the staged q/k/v and projection weights
constexpr int JC = 16;   // dqkv columns staged per step of the input-gradient product
constexpr int RPT = 4;   // rows per thread of the row x column tiles (rows ty + 16 i)
constexpr int QPT = 6;   // q/k/v columns per thread (3 * dh <= 16 * QPT)

struct BwdArgs {
  const float* gamma;     // (C) ChanLayerNorm scale
  const float* ln_scale;  // (C) temporal LayerNorm scale (temporal only)
  const float* ln_bias;   // (C)
  const float* bias;      // (heads, L, L)
  const float* masks;     // (n_unique, L, L) or null
  const int* mask_ids;    // (n_windows) or null
  const float* cos_t;     // (L, rot)
  const float* sin_t;     // (L, rot)
  float* dqkv;            // (tokens, 3 * hid): d q | d k | d v, heads within each
  float* o_tok;           // (tokens, hid): head outputs
  float* vec_part;        // (gridDim, NV, C)
  float* bias_part;       // (gridDim, heads, L, L)
  int D1, D2, D3;         // stw: padded T, H, W; temporal: T, H*W, 1
  int wd, wh, ww;         // stw window; temporal: (T, 1, 1)
  int G, nseq, units;     // sequences per block, sequences in all, windows / groups in all
  int C, heads, dh, rot;
  float eps;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory layout of one block, in bytes; the host sizes the launch
// with the same struct. dq reuses dO's buffer (dO is dead once dS is formed)
// and the per-channel reduction reuses the weight staging buffer.
struct BwdLayout {
  int HS, VS, PS;
  size_t rowstat, hs, gs, q, k, v, o, dout, dk, dv, p, wbuf, total;
  __host__ __device__ BwdLayout(int N, int L, int C, int dh, int tsize) {
    HS = C + (tsize == 4 ? 1 : 2);
    VS = dh + 1;
    PS = L + 1;
    rowstat = 64 * sizeof(long long);  // rowoff comes first
    hs = rowstat + 4 * 64 * sizeof(float);
    gs = align16(hs + (size_t)N * HS * tsize);
    q = align16(gs + (size_t)N * HS * tsize);
    const size_t vb = (size_t)N * VS * 4;
    k = q + vb;
    v = k + vb;
    o = v + vb;
    dout = o + vb;
    dk = dout + vb;
    dv = dk + vb;
    p = dv + vb;
    wbuf = align16(p + (size_t)N * PS * 4);
    size_t wq = (size_t)KC * (3 * dh + 1), wr = (size_t)JC * C, red = (size_t)16 * C;
    size_t w = wq > wr ? wq : wr;
    total = wbuf + (w > red ? w : red) * 4;
  }
};

__device__ __forceinline__ float row16_sum(float v) {  // sum over the 16 lanes of a row group
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int MODE, int OJ>
__global__ void __launch_bounds__(NT) attn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                                     T* __restrict__ dx, T* __restrict__ h_tok,
                                                     const T* __restrict__ wqkv,
                                                     const T* __restrict__ wproj, BwdArgs a) {
  constexpr int NV = MODE == 0 ? 2 : 3;  // stw: dgamma, dbproj; temporal: dgamma, dln_scale, dln_bias
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int C = a.C, dh = a.dh, hid = a.heads * a.dh, q3 = 3 * a.dh;
  const int L = a.wd * a.wh * a.ww, N = a.G * L;
  const BwdLayout lay(N, L, C, dh, sizeof(T));
  const int HS = lay.HS, VS = lay.VS, PS = lay.PS;

  long long* rowoff = reinterpret_cast<long long*>(smem);  // token offset, -1: none
  float* rowstat = reinterpret_cast<float*>(smem + lay.rowstat);  // mean, rstd, mean2, rstd2
  T* hs = reinterpret_cast<T*>(smem + lay.hs);  // q/k/v product input (ChanLN(x), or LN(a))
  T* gs = reinterpret_cast<T*>(smem + lay.gs);  // cotangent rows
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ks = reinterpret_cast<float*>(smem + lay.k);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  float* os = reinterpret_cast<float*>(smem + lay.o);
  float* dos = reinterpret_cast<float*>(smem + lay.dout);
  float* dqs = dos;
  float* dks = reinterpret_cast<float*>(smem + lay.dk);
  float* dvs = reinterpret_cast<float*>(smem + lay.dv);
  float* ps = reinterpret_cast<float*>(smem + lay.p);  // P, then dS
  float* wbuf = reinterpret_cast<float*>(smem + lay.wbuf);

  float* vpart = a.vec_part + (size_t)blockIdx.x * NV * C;
  float* bpart = a.bias_part + (size_t)blockIdx.x * a.heads * L * L;
  for (int e = tid; e < NV * C; e += NT) vpart[e] = 0.f;
  for (int e = tid; e < a.heads * L * L; e += NT) bpart[e] = 0.f;
  const float qscale = rsqrtf((float)dh);
  const int hrot = a.rot / 2;

  for (int unit = blockIdx.x; unit < a.units; unit += gridDim.x) {
    __syncthreads();  // the previous window is done with shared memory
    // ---- token addresses (as the forward)
    int mask_row = -1;
    if (MODE == 0) {
      const int nWt = a.D1 / a.wd, nWh = a.D2 / a.wh, nWw = a.D3 / a.ww;
      const int nW = nWt * nWh * nWw;
      const int b = unit / nW, wi = unit % nW;
      const int td = wi / (nWh * nWw), th = (wi / nWw) % nWh, tw = wi % nWw;
      for (int n = tid; n < N; n += NT) {
        const int i0 = n / (a.wh * a.ww), i1 = (n / a.ww) % a.wh, i2 = n % a.ww;
        const long long t = td * a.wd + i0, h = th * a.wh + i1, w = tw * a.ww + i2;
        rowoff[n] = (((b * (long long)a.D1 + t) * a.D2 + h) * a.D3 + w) * C;
      }
      if (a.masks != nullptr) mask_row = a.mask_ids[wi];
    } else {
      for (int n = tid; n < N; n += NT) {
        const int seq = unit * a.G + n / L, b = seq / a.D2, m = seq % a.D2;
        rowoff[n] = seq < a.nseq ? ((b * (long long)a.D1 + n % L) * a.D2 + m) * C : -1;
      }
    }
    __syncthreads();

    // ---- load x and g rows; rows of no token are zero
    for (int e = tid; e < N * C; e += NT) {
      const int n = e / C, c = e % C;
      const bool ok = rowoff[n] >= 0;
      hs[n * HS + c] = ok ? x[rowoff[n] + c] : from_f<T>(0.f);
      gs[n * HS + c] = ok ? g[rowoff[n] + c] : from_f<T>(0.f);
    }
    __syncthreads();

    // ---- norms, one warp per row, exactly as the forward
    for (int n = warp; n < N; n += NT / 32) {
      T* row = hs + n * HS;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(row[c]);
      const float mean = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(row[c]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / C + a.eps);
      for (int c = lane; c < C; c += 32) row[c] = from_f<T>((to_f(row[c]) - mean) * rstd * a.gamma[c]);
      float mean2 = 0.f, rstd2 = 0.f;
      if (MODE == 1) {
        __syncwarp();
        s = 0.f;
        for (int c = lane; c < C; c += 32) s += to_f(row[c]);
        mean2 = warp_sum(s) / C;
        v = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float d = to_f(row[c]) - mean2;
          v += d * d;
        }
        rstd2 = rsqrtf(warp_sum(v) / C + a.eps);
        for (int c = lane; c < C; c += 32)
          row[c] = from_f<T>((to_f(row[c]) - mean2) * rstd2 * a.ln_scale[c] + a.ln_bias[c]);
      }
      if (lane == 0) {
        rowstat[4 * n] = mean;
        rowstat[4 * n + 1] = rstd;
        rowstat[4 * n + 2] = mean2;
        rowstat[4 * n + 3] = rstd2;
      }
    }
    __syncthreads();
    for (int e = tid; e < N * C; e += NT) {  // the weight-gradient product's input rows
      const int n = e / C, c = e % C;
      if (rowoff[n] >= 0) h_tok[rowoff[n] + c] = hs[n * HS + c];
    }

    float acc[RPT * OJ];  // gradient of the q/k/v product's input, kept across heads
#pragma unroll
    for (int i = 0; i < RPT * OJ; ++i) acc[i] = 0.f;

    for (int hd = 0; hd < a.heads; ++hd) {
      // ---- recompute q (scaled), k, v = hs Wqkv[head rows]^T, rounded as the forward
      float qa[QPT][RPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int i = 0; i < RPT; ++i) qa[j][i] = 0.f;
      const int WQS = q3 + 1;
      for (int k0 = 0; k0 < C; k0 += KC) {
        __syncthreads();
        for (int e = tid; e < KC * q3; e += NT) {
          const int j = e / KC, kk = e % KC;
          const int o = (j / dh) * hid + hd * dh + (j % dh);
          wbuf[kk * WQS + j] = (k0 + kk < C) ? to_f(wqkv[(long long)o * C + k0 + kk]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(KC, C - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float av[RPT], wv[QPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = ty + 16 * i;
            av[i] = r < N ? to_f(hs[r * HS + k0 + kk]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            const int col = tx + 16 * j;
            wv[j] = col < q3 ? wbuf[kk * WQS + col] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < QPT; ++j) qa[j][i] = fmaf(av[i], wv[j], qa[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + 16 * i, col = tx + 16 * j;
          if (r < N && col < q3) {
            const int which = col / dh, d = col % dh;
            const float v = round_to<T>(qa[j][i]);
            if (which == 0) qs[r * VS + d] = v * qscale;
            else if (which == 1) ks[r * VS + d] = v;
            else vs[r * VS + d] = v;
          }
        }
      __syncthreads();
      for (int e = tid; e < N * hrot; e += NT) {  // rotary embedding on q and k
        const int n = e / hrot, p = 2 * (e % hrot), pos = n % L;
        const float c0 = a.cos_t[pos * a.rot + p], s0 = a.sin_t[pos * a.rot + p];
        const float c1 = a.cos_t[pos * a.rot + p + 1], s1 = a.sin_t[pos * a.rot + p + 1];
        float* qr = qs + n * VS;
        float* kr = ks + n * VS;
        const float q0 = qr[p], q1 = qr[p + 1], k0v = kr[p], k1v = kr[p + 1];
        qr[p] = q0 * c0 - q1 * s0;
        qr[p + 1] = q1 * c1 + q0 * s1;
        kr[p] = k0v * c0 - k1v * s0;
        kr[p + 1] = k1v * c1 + k0v * s1;
      }
      __syncthreads();

      // ---- P = softmax over the row's own sequence, and o = P v; one warp per row
      const float* bias_h = a.bias + (long long)hd * L * L;
      const float* mask_w = mask_row >= 0 ? a.masks + (long long)mask_row * L * L : nullptr;
      for (int i = warp; i < N; i += NT / 32) {
        const int iq = i % L, kbase = i - iq;
        const float* qr = qs + i * VS;
        float s[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j < L) {
            const float* kr = ks + (kbase + j) * VS;
            float dot = 0.f;
            for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
            dot += bias_h[iq * L + j];
            if (mask_w != nullptr) dot += mask_w[iq * L + j];
            s[u] = dot;
          } else {
            s[u] = __int_as_float(0xff800000);  // -inf
          }
        }
        const float m = warp_max(fmaxf(s[0], s[1]));
        const float e0 = lane < L ? expf(s[0] - m) : 0.f;
        const float e1 = lane + 32 < L ? expf(s[1] - m) : 0.f;
        const float inv = 1.f / warp_sum(e0 + e1);
        float* prow = ps + i * PS;
        if (lane < L) prow[lane] = round_to<T>(e0 * inv);
        if (lane + 32 < L) prow[lane + 32] = round_to<T>(e1 * inv);
        __syncwarp();
        if (lane < dh) {
          float o = 0.f;
          for (int j = 0; j < L; ++j) o = fmaf(prow[j], vs[(kbase + j) * VS + lane], o);
          os[i * VS + lane] = round_to<T>(o);
        }
      }

      // ---- dO = g Wproj[:, head slice]: rows ty + 16 i, columns tx + 16 j
      float da[2][RPT];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < RPT; ++i) da[j][i] = 0.f;
      const int WPS = dh + 1;
      for (int k0 = 0; k0 < C; k0 += KC) {
        __syncthreads();
        for (int e = tid; e < KC * dh; e += NT) {
          const int kk = e / dh, d = e % dh;
          wbuf[kk * WPS + d] = (k0 + kk < C) ? to_f(wproj[(long long)(k0 + kk) * hid + hd * dh + d]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(KC, C - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float gv[RPT], wv[2];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = ty + 16 * i;
            gv[i] = r < N ? to_f(gs[r * HS + k0 + kk]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) wv[j] = tx + 16 * j < dh ? wbuf[kk * WPS + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) da[j][i] = fmaf(gv[i], wv[j], da[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty + 16 * i, d = tx + 16 * j;
          if (r < N && d < dh) dos[r * VS + d] = da[j][i];
        }
      __syncthreads();

      // ---- dv = P^T dO over each key's own sequence
      for (int e = tid; e < N * dh; e += NT) {
        const int j = e / dh, d = e % dh, jl = j % L, base = j - jl;
        float s = 0.f;
        for (int il = 0; il < L; ++il) s = fmaf(ps[(base + il) * PS + jl], dos[(base + il) * VS + d], s);
        dvs[j * VS + d] = s;
      }
      __syncthreads();
      // ---- dS = P (dO v^T - rowsum(dO o)), in place of P; one warp per row
      for (int i = warp; i < N; i += NT / 32) {
        const int kbase = i - i % L;
        const float dsum = warp_sum(lane < dh ? dos[i * VS + lane] * os[i * VS + lane] : 0.f);
        for (int j = lane; j < L; j += 32) {
          const float* vr = vs + (kbase + j) * VS;
          float dp = 0.f;
          for (int d = 0; d < dh; ++d) dp = fmaf(dos[i * VS + d], vr[d], dp);
          ps[i * PS + j] *= dp - dsum;
        }
      }
      __syncthreads();
      // ---- dq = dS k (into dO's buffer), dk = dS^T q; dbias += dS over the block's rows
      for (int e = tid; e < N * dh; e += NT) {
        const int n = e / dh, d = e % dh, nl = n % L, base = n - nl;
        float sq = 0.f, sk = 0.f;
        for (int jl = 0; jl < L; ++jl) {
          sq = fmaf(ps[n * PS + jl], ks[(base + jl) * VS + d], sq);
          sk = fmaf(ps[(base + jl) * PS + nl], qs[(base + jl) * VS + d], sk);
        }
        dqs[n * VS + d] = sq;
        dks[n * VS + d] = sk;
      }
      for (int e = tid; e < L * L; e += NT) {
        const int iq = e / L, jl = e % L;
        float s = 0.f;
        for (int gi = 0; gi < a.G; ++gi) {
          const int r = gi * L + iq;
          if (rowoff[r] >= 0) s += ps[r * PS + jl];
        }
        bpart[hd * L * L + e] += s;
      }
      __syncthreads();
      // ---- undo rope on dq and dk, then the q scale
      for (int e = tid; e < N * hrot; e += NT) {
        const int n = e / hrot, p = 2 * (e % hrot), pos = n % L;
        const float c0 = a.cos_t[pos * a.rot + p], s0 = a.sin_t[pos * a.rot + p];
        const float c1 = a.cos_t[pos * a.rot + p + 1], s1 = a.sin_t[pos * a.rot + p + 1];
        float* qr = dqs + n * VS;
        float* kr = dks + n * VS;
        const float q0 = qr[p], q1 = qr[p + 1], k0v = kr[p], k1v = kr[p + 1];
        qr[p] = q0 * c0 + q1 * s1;
        qr[p + 1] = q1 * c1 - q0 * s0;
        kr[p] = k0v * c0 + k1v * s1;
        kr[p + 1] = k1v * c1 - k0v * s0;
      }
      __syncthreads();
      for (int e = tid; e < N * dh; e += NT) dqs[(e / dh) * VS + e % dh] *= qscale;
      __syncthreads();

      // ---- per-token dqkv and o for the weight-gradient products
      for (int e = tid; e < N * q3; e += NT) {
        const int n = e / q3, j = e % q3, which = j / dh, d = j % dh;
        if (rowoff[n] < 0) continue;
        const long long tok = rowoff[n] / C;
        const float* src = which == 0 ? dqs : which == 1 ? dks : dvs;
        a.dqkv[tok * 3 * hid + which * hid + hd * dh + d] = src[n * VS + d];
        if (which == 0) a.o_tok[tok * hid + hd * dh + d] = os[n * VS + d];
      }
      // ---- acc += [dq dk dv] Wqkv[head rows], JC rows of Wqkv staged at a time
      for (int j0 = 0; j0 < q3; j0 += JC) {
        __syncthreads();
        for (int e = tid; e < JC * C; e += NT) {
          const int jj = e / C, c = e % C, j = j0 + jj;
          const int o = (j / dh) * hid + hd * dh + (j % dh);
          wbuf[jj * C + c] = j < q3 ? to_f(wqkv[(long long)o * C + c]) : 0.f;
        }
        __syncthreads();
        const int jmax = min(JC, q3 - j0);
        for (int jj = 0; jj < jmax; ++jj) {
          const int j = j0 + jj, which = j / dh, d = j % dh;
          const float* src = which == 0 ? dqs : which == 1 ? dks : dvs;
          float dv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = ty + 16 * i;
            dv[i] = r < N ? src[r * VS + d] : 0.f;
          }
#pragma unroll
          for (int jc = 0; jc < OJ; ++jc) {
            const int c = tx + 16 * jc;
            const float w = c < C ? wbuf[jj * C + c] : 0.f;
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[i * OJ + jc] = fmaf(dv[i], w, acc[i * OJ + jc]);
          }
        }
      }
    }

    // ---- epilogue: norm backward(s) and residual(s) per row; dx written once
    float sv[NV][OJ];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int jc = 0; jc < OJ; ++jc) sv[v][jc] = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const bool rv = r < N && rowoff[r] >= 0;
      const long long off = rv ? rowoff[r] : 0;
      const float mean = r < N ? rowstat[4 * r] : 0.f, rstd = r < N ? rowstat[4 * r + 1] : 0.f;
      float xh[OJ], gv[OJ], dxh[OJ];
      float s1 = 0.f, s2 = 0.f;
      if constexpr (MODE == 0) {
#pragma unroll
        for (int jc = 0; jc < OJ; ++jc) {
          const int c = tx + 16 * jc;
          const bool ok = rv && c < C;
          xh[jc] = ok ? (to_f(x[off + c]) - mean) * rstd : 0.f;
          gv[jc] = ok ? to_f(g[off + c]) : 0.f;
          const float d = ok ? acc[i * OJ + jc] : 0.f;
          dxh[jc] = ok ? d * a.gamma[c] : 0.f;
          s1 += dxh[jc];
          s2 += dxh[jc] * xh[jc];
          sv[0][jc] += d * xh[jc];
          sv[1][jc] += gv[jc];
        }
      } else {
        const float mean2 = r < N ? rowstat[4 * r + 2] : 0.f, rstd2 = r < N ? rowstat[4 * r + 3] : 0.f;
        float ah[OJ], dah[OJ];
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int jc = 0; jc < OJ; ++jc) {
          const int c = tx + 16 * jc;
          const bool ok = rv && c < C;
          xh[jc] = ok ? (to_f(x[off + c]) - mean) * rstd : 0.f;
          gv[jc] = ok ? to_f(g[off + c]) : 0.f;
          const float av = ok ? round_to<T>((to_f(x[off + c]) - mean) * rstd * a.gamma[c]) : 0.f;
          ah[jc] = ok ? (av - mean2) * rstd2 : 0.f;
          const float d = ok ? acc[i * OJ + jc] : 0.f;
          sv[1][jc] += d * ah[jc];
          sv[2][jc] += d;
          dah[jc] = ok ? d * a.ln_scale[c] : 0.f;
          t1 += dah[jc];
          t2 += dah[jc] * ah[jc];
        }
        t1 = row16_sum(t1) / C;
        t2 = row16_sum(t2) / C;
#pragma unroll
        for (int jc = 0; jc < OJ; ++jc) {
          const int c = tx + 16 * jc;
          const bool ok = rv && c < C;
          const float dat = ok ? gv[jc] + rstd2 * (dah[jc] - t1 - ah[jc] * t2) : 0.f;
          sv[0][jc] += dat * xh[jc];
          dxh[jc] = ok ? dat * a.gamma[c] : 0.f;
          s1 += dxh[jc];
          s2 += dxh[jc] * xh[jc];
        }
      }
      s1 = row16_sum(s1) / C;
      s2 = row16_sum(s2) / C;
#pragma unroll
      for (int jc = 0; jc < OJ; ++jc) {
        const int c = tx + 16 * jc;
        if (rv && c < C) dx[off + c] = from_f<T>(gv[jc] + rstd * (dxh[jc] - s1 - xh[jc] * s2));
      }
    }
    // per-channel sums over the window's rows into the block's slice, in a fixed order
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      __syncthreads();
#pragma unroll
      for (int jc = 0; jc < OJ; ++jc) {
        const int c = tx + 16 * jc;
        if (c < C) wbuf[ty * C + c] = sv[v][jc];
      }
      __syncthreads();
      for (int c = tid; c < C; c += NT) {
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += wbuf[t * C + c];
        vpart[v * C + c] += s;
      }
    }
  }
}

// part[z] = sum over the rows r of split z of A[r, m] B[r, n]: (M, K) per split.
template <typename TA, typename TB>
__global__ void __launch_bounds__(NT) atb_kernel(const TA* __restrict__ A, const TB* __restrict__ Bm,
                                                long long rows, int M, int K, long long rows_per_split,
                                                float* __restrict__ part) {
  __shared__ float as[16][64];
  __shared__ float bs[16][64];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const long long r_begin = blockIdx.z * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += 16) {
    __syncthreads();
    for (int e = tid; e < 16 * 64; e += NT) {
      const int rr = e / 64, cc = e % 64;
      const long long r = r0 + rr;
      as[rr][cc] = (r < r_end && m0 + cc < M) ? to_f(A[r * M + m0 + cc]) : 0.f;
      bs[rr][cc] = (r < r_end && k0 + cc < K) ? to_f(Bm[r * K + k0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, k = k0 + tx + 16 * j;
      if (m < M && k < K) part[((long long)blockIdx.z * M + m) * K + k] = acc[i][j];
    }
}

template <typename TA, typename TB>
cudaError_t atb(const TA* A, const TB* Bm, long long rows, int M, int K, int splits, float* part,
                float* out, cudaStream_t stream) {
  const long long per = ((rows + splits - 1) / splits + 15) / 16 * 16;
  const dim3 grid((M + 63) / 64, (K + 63) / 64, splits);
  atb_kernel<TA, TB><<<grid, NT, 0, stream>>>(A, Bm, rows, M, K, per, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, splits, (long long)M * K, out, stream);
}

template <typename T, int MODE, int OJ>
cudaError_t launch_bwd(const void* x, const void* g, void* dx, void* h_tok, const void* wqkv,
                       const void* wproj, const BwdArgs& a, int nblk, size_t bytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T, MODE, OJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T, MODE, OJ><<<nblk, NT, bytes, stream>>>(
      (const T*)x, (const T*)g, (T*)dx, (T*)h_tok, (const T*)wqkv, (const T*)wproj, a);
  return cudaGetLastError();
}

// The window kernel, then the sums over windows and the two weight-gradient
// products. vec_out (NV * C), bias_out (heads, L, L), dwqkv (3 hid, C) and
// dwproj (C, hid) are float32.
template <typename T, int MODE>
int layer_bwd(const void* x, const void* g, void* dx, void* h_tok, const void* wqkv,
              const void* wproj, const BwdArgs& a, int nblk, long long tokens, int splits_qkv,
              int splits_proj, float* w_part, float* vec_out, float* bias_out, float* dwqkv,
              float* dwproj, cudaStream_t stream) {
  const int L = a.wd * a.wh * a.ww, N = a.G * L, hid = a.heads * a.dh;
  if (N > 64 || a.dh > 32 || a.C > 256 || a.rot % 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = BwdLayout(N, L, a.C, a.dh, sizeof(T)).total;
  cudaError_t err;
  if (a.C <= 64) err = launch_bwd<T, MODE, 4>(x, g, dx, h_tok, wqkv, wproj, a, nblk, bytes, stream);
  else if (a.C <= 128) err = launch_bwd<T, MODE, 8>(x, g, dx, h_tok, wqkv, wproj, a, nblk, bytes, stream);
  else err = launch_bwd<T, MODE, 16>(x, g, dx, h_tok, wqkv, wproj, a, nblk, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int NV = MODE == 0 ? 2 : 3;
  if ((err = sum_parts(a.vec_part, nblk, (long long)NV * a.C, vec_out, stream)) != cudaSuccess) return (int)err;
  if ((err = sum_parts(a.bias_part, nblk, (long long)a.heads * L * L, bias_out, stream)) != cudaSuccess)
    return (int)err;
  // dWqkv[j, c] = sum over tokens of dqkv[t, j] h[t, c]; dWproj[c, j] = sum of g[t, c] o[t, j]
  err = atb<float, T>(a.dqkv, (const T*)h_tok, tokens, 3 * hid, a.C, splits_qkv, w_part, dwqkv, stream);
  if (err != cudaSuccess) return (int)err;
  err = atb<T, float>((const T*)g, a.o_tok, tokens, a.C, hid, splits_proj, w_part, dwproj, stream);
  return (int)err;
}

}  // namespace

// x, g: the padded, rolled (B, Tp, Hp, Wp, C) input and cotangent; dx and
// h_tok have their shape. dqkv (tokens, 3 hid), o_tok (tokens, hid),
// vec_part (nblk, 2, C), bias_part (nblk, heads, N, N) and w_part (the larger
// of splits_qkv * 3 hid * C and splits_proj * C * hid) are float32 scratch.
// vec_out is (dgamma | dbproj).
extern "C" int stw_layer_bwd(int dtype, const void* x, const void* g, void* dx, void* h_tok,
                             const void* wqkv, const void* wproj, const float* gamma,
                             const float* bias, const float* masks, const int* mask_ids,
                             const float* cos_t, const float* sin_t, float* dqkv, float* o_tok,
                             float* vec_part, float* bias_part, float* w_part, float* vec_out,
                             float* bias_out, float* dwqkv, float* dwproj, int B, int Tp, int Hp,
                             int Wp, int C, int wd, int wh, int ww, int heads, int dh, int rot,
                             float eps, int nblk, int splits_qkv, int splits_proj, void* stream) {
  const int units = B * (Tp / wd) * (Hp / wh) * (Wp / ww);
  if (units == 0) return 0;
  BwdArgs a{gamma, nullptr, nullptr, bias, masks, mask_ids, cos_t, sin_t, dqkv, o_tok, vec_part,
            bias_part, Tp, Hp, Wp, wd, wh, ww, 1, 0, units, C, heads, dh, rot, eps};
  const long long tokens = (long long)B * Tp * Hp * Wp;
  DISPATCH_DTYPE(dtype, return layer_bwd<T, 0>(x, g, dx, h_tok, wqkv, wproj, a, nblk, tokens,
                                               splits_qkv, splits_proj, w_part, vec_out, bias_out,
                                               dwqkv, dwproj, (cudaStream_t)stream));
  return 0;
}

// As stw_layer_bwd on the unpadded (B, T, H, W, C) tensors; vec_part is
// (nblk, 3, C) and vec_out (dgamma_cln | dln_scale | dln_bias).
extern "C" int temporal_layer_bwd(int dtype, const void* x, const void* g, void* dx, void* h_tok,
                                  const void* wqkv, const void* wproj, const float* gamma,
                                  const float* ln_scale, const float* ln_bias, const float* bias,
                                  const float* cos_t, const float* sin_t, float* dqkv,
                                  float* o_tok, float* vec_part, float* bias_part, float* w_part,
                                  float* vec_out, float* bias_out, float* dwqkv, float* dwproj,
                                  int B, int T, int HW, int C, int heads, int dh, int rot,
                                  float eps, int nblk, int splits_qkv, int splits_proj,
                                  void* stream) {
  const int G = T <= 64 ? 64 / T : 1;
  const int units = (B * HW + G - 1) / G;
  if (units == 0) return 0;
  BwdArgs a{gamma, ln_scale, ln_bias, bias, nullptr, nullptr, cos_t, sin_t, dqkv, o_tok,
            vec_part, bias_part, T, HW, 1, T, 1, 1, G, B * HW, units, C, heads, dh, rot, eps};
  const long long tokens = (long long)B * T * HW;
  DISPATCH_DTYPE(dtype, return layer_bwd<T, 1>(x, g, dx, h_tok, wqkv, wproj, a, nblk, tokens,
                                               splits_qkv, splits_proj, w_part, vec_out, bias_out,
                                               dwqkv, dwproj, (cudaStream_t)stream));
  return 0;
}
