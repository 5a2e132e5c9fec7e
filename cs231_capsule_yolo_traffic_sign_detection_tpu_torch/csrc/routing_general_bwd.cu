// K4g: the VJP of K3g (capsule votes fused with routing by agreement) at
// any capsule shape, for sm_90a.
//
// Replaces the TPU kernel ops/routing_pallas.py:_bwd
// (_routing_bwd_kernel, the custom VJP of routed_capsules_pallas) at
// every shape outside the tuned K4 (csrc/routing_bwd.cu): f32, in_C <= 16,
// K <= 64, D <= 64, any N, B and n_iter.  For the caps' cotangent g (B,
// K, D) it gives dx (B, N, C) and dW (N, K, C, D).  With priors
// P[b,n,k,d] = sum_c x[b,n,c] W[n,k,c,d], V_t = v_0 + ... + v_{t-1} and
// probs_t = softmax_k(sum_d P V_t), the reverse sweep is, for t =
// n_iter-1 ... 0:
//   sbar_t = squash VJP of s_t applied to vbar_t (vbar_{n_iter-1} = g)
//   dP    += probs_t sbar_t                           (node-sum VJP)
//   t >= 1: pbar = sum_d P sbar_t, Lbar += probs_t (pbar - sum_k probs_t
//           pbar)                                     (softmax VJP)
//           vbar_{t-1} = sum_n P Lbar,  dP += v_{t-1} Lbar  (agreement VJP)
// then dx[b,n,c] = sum_{k,d} W dP and dW[n,k,c,d] = sum_b x dP.
//
// Bound on the H100: operations.  The votes, dx and dW are 2 B N K C D
// FLOP each, the reverse sweep and the logits rebuilt from V are
// 5 n_iter - 4 node-sized passes of 2 B N K D: at DarkCapsuleNet3's
// shape (B 1568, N 512, K 43, C 8, D 21) 50.7 GFLOP, 0.76 ms at 67
// TFLOP/s, against about 107 MB moved (chip_smoke.py:routing_bwd_bound).
//
// Design.  The first design rebuilt every softmax of the sweep in each
// launch, and its final launch (one node a block, the batch in groups of
// 4, the per-element state re-read for every node, votes, dx and dW by
// FMAs) took 32 of its 47 ms at DarkCapsuleNet3's shape.  Now what
// crosses node tiles is worked out first, and what a later launch needs
// of a softmax is kept in global memory:
//  1. rg_bwd_prep_kernel, one block per element: v_t = squash(s_t) and
//     the running sums V_t from the s_t K3g saved, bit-equal to the
//     forward's V (the same |s|^2 order, routing_general.cuh), and
//     sbar_{n_iter-1} from g (the "state": 3 n_iter - 2 vectors of K x D
//     an element);
//  2. for t = n_iter-1 ... 1, a pass launch of rg_tile_kernel<true>
//     (routing_general.cuh: clusters of blocks over (node tile, group of
//     16 elements), votes and node sums on the tensor cores, W by TMA),
//     whose rows take Lbar_{t+1} from the previous pass and leave probs_t
//     and Lbar_t per (element, node, capsule) in `coef` (2 (n_iter - 1)
//     B N K floats: 552 MB at DarkCapsuleNet3's shape) and one partial
//     vbar_{t-1} per (element, tile); then rg_bwd_finish_kernel, one block
//     per element, sums the partials in a fixed order and applies the
//     squash VJP;
//  3. the final launch, rg_bwd_final_kernel, one block per (tile of 1-4
//     nodes, range of capsules, share of the batch), W of its nodes in
//     shared memory for its whole life.  Per group of 16 elements, with
//     the coefficients staged: dP = sum_t probs_t sbar_t + sum_t Lbar_t
//     v_{t-1} from the state (read once per group and node tile, not per
//     node: 2n_iter - 1 vectors), then on the tensor cores (3xTF32)
//     dx += dP W^T (the elements as M, D as the product's depth) and
//     dW += x^T dP (in_C as M, the elements as depth: dP reaches the B
//     operand's layout through a 16 x 8 tile of the warp's shared
//     memory), dW kept in registers across the batch share; dx summed
//     over the warps in a fixed order.  With more than one share of the
//     batch (or range of capsules) each writes its own dW (dx) and
//     rg_sum_parts_kernel adds them in a fixed order.
// No atomics: dx, dW and every sum are deterministic.  Arithmetic is f32
// (products 3xTF32), IEEE sqrt, expf and division (no fast math); the
// squash guard is 1e-12.

#include "routing_general.cuh"

namespace {

using namespace cyt::rg;

// index of a vector in an element's state: sbar_t (t < T), V_t
// (1 <= t < T), v_t (t < T - 1)
__host__ __device__ __forceinline__ int sbar_vec(int t) { return t; }
__host__ __device__ __forceinline__ int vsum_vec(int t, int T) {
  return T + t - 1;
}
__host__ __device__ __forceinline__ int v_vec(int t, int T) {
  return 2 * T - 1 + t;
}

// state of one element from the forward's s_t and the cotangent g
__global__ void rg_bwd_prep_kernel(const float* __restrict__ s_saved,
                                   const float* __restrict__ g,
                                   float* __restrict__ state, int B, int K,
                                   int D, int T) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int KD = K * D;
  float* ss = smem;          // [K][D] s_t
  float* gs = ss + KD;       // [K][D] g
  float* n2s = gs + KD;      // [K]
  float* svs = n2s + K;      // [K]
  float* st = state + int64_t(b) * (3 * T - 2) * KD;
  for (int j = threadIdx.x; j < KD; j += blockDim.x)
    gs[j] = g[int64_t(b) * KD + j];
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous t is done with ss
    for (int j = threadIdx.x; j < KD; j += blockDim.x)
      ss[j] = s_saved[(int64_t(t) * B + b) * KD + j];
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      n2s[k] = capsule_n2(ss + k * D, D);
      if (t == T - 1) svs[k] = capsule_dot(ss + k * D, gs + k * D, D);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < KD; j += blockDim.x) {
      const float s = ss[j];
      const int k = j / D;
      if (t < T - 1) {
        // as routing_general.cu:rg_squash_kernel forms v and V
        const float v = s * squash_scale(n2s[k]);
        const float vs = t == 0 ? v : st[vsum_vec(t, T) * KD + j] + v;
        st[v_vec(t, T) * KD + j] = v;
        st[vsum_vec(t + 1, T) * KD + j] = vs;
      } else {
        st[sbar_vec(t) * KD + j] = squash_vjp(s, gs[j], n2s[k], svs[k]);
      }
    }
  }
}

// sbar_{t-1} from the pass's partial vbar_{t-1}, one block per element
__global__ void rg_bwd_finish_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ s_saved,
                                     float* __restrict__ state, int B, int K,
                                     int D, int T, int tiles, int t) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int KD = K * D;
  float* ss = smem;          // [K][D] s_{t-1}
  float* vb = ss + KD;       // [K][D] vbar_{t-1}
  float* n2s = vb + KD;      // [K]
  float* svs = n2s + K;      // [K]
  for (int j = threadIdx.x; j < KD; j += blockDim.x) {
    const float* src = partial + int64_t(b) * tiles * KD + j;
    float v = 0.f;
    for (int i = 0; i < tiles; ++i) v += src[int64_t(i) * KD];
    vb[j] = v;
    ss[j] = s_saved[(int64_t(t - 1) * B + b) * KD + j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    n2s[k] = capsule_n2(ss + k * D, D);
    svs[k] = capsule_dot(ss + k * D, vb + k * D, D);
  }
  __syncthreads();
  float* dst = state + (int64_t(b) * (3 * T - 2) + sbar_vec(t - 1)) * KD;
  for (int j = threadIdx.x; j < KD; j += blockDim.x)
    dst[j] = squash_vjp(ss[j], vb[j], n2s[j / D], svs[j / D]);
}

// ---- the final launch

constexpr int kTerms = 5;  // dP's terms whose state loads go together

// nodes a final block takes for a warp's units a bound and in_C's
// k-steps: dW's registers (UM x nodes x 2 CH) at 48 or fewer
__host__ __device__ constexpr int final_nodes(int um, int ch) {
  return 24 / (um * ch) < 1 ? 1 : (24 / (um * ch) > 4 ? 4 : 24 / (um * ch));
}

struct FinalArgs {
  const float* x;      // (B, N, C)
  const float* w;      // (N, K, C, D)
  const float* state;  // (B, 3 T - 2, K, D)
  const float* coef;   // (2 (T - 1), B, N, K): probs_t, then Lbar_t
  float* dx;           // (B, N, C), or (R, B, N, C) with R > 1
  float* dw;           // (N, K, C, D), or (shares, ...) with shares > 1
  int B, N, K, C, D, T;
  int R, kcs, cw, warps, nt, ntl, share, shares, tiles;
  int bulk;  // W by TMA bulk copies
  int wslot, o_xs, o_cs, o_red, o_tr, floats;
};

void final_layout(FinalArgs& a) {
  const int ch = (a.C + 7) / 8;
  a.wslot = round4(a.kcs * a.C * a.D);
  a.o_xs = a.ntl * a.wslot;                                  // 2 buffers
  a.o_cs = a.o_xs + 2 * round4(a.ntl * kRows * a.C);         // 2 buffers
  a.o_red = a.o_cs + 2 * round4(2 * (a.T - 1) * a.ntl * kRows * a.kcs);
  a.o_tr = a.o_red + a.warps * a.ntl * kRows * 8 * ch;
  a.floats = a.o_tr + a.warps * kRows * 9;
}

template <int UM, int CH>
__global__ void __launch_bounds__(kWarps * 32, 1)
    rg_bwd_final_kernel(const FinalArgs a) {
  constexpr int NTL = final_nodes(UM, CH);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw + 16);
  const int n0 = blockIdx.x * NTL, nn = min(NTL, a.N - n0);
  const int k_lo = blockIdx.y * a.kcs, kcr = min(a.K - k_lo, a.kcs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int K = a.K, C = a.C, D = a.D, CD = C * D, KD = K * D, T = a.T;
  const int nt = a.nt, kcs = a.kcs, nvec = 3 * T - 2, terms = 2 * T - 1;
  const int wk0 = warp * a.cw;
  const int units = max(0, min(a.cw, kcr - wk0)) * nt;
  const int slots = 2 * (T - 1);
  const int xsz = round4(NTL * kRows * C);
  const int csz = round4(slots * NTL * kRows * kcs);
  float* ws = sm;                                  // [NTL][wslot]
  float* red = sm + a.o_red;                       // [warps][NTL][16][8 CH]
  float* tr = sm + a.o_tr + warp * kRows * 9;      // [16][9], the warp's
  const int64_t BNK = int64_t(a.B) * a.N * K;

  // W of the block's nodes and capsules, kept for the block's life
  if (a.bulk) {
    if (tid == 0) {
      cyt::mbar_init(bar, 1);
      cyt::mbar_init_fence();
      const uint32_t bytes = uint32_t(kcr * CD) * sizeof(float);
      cyt::mbar_arrive_expect(bar, bytes * nn);
      for (int i = 0; i < nn; ++i)
        cyt::bulk_copy(ws + i * a.wslot, a.w + (int64_t(n0 + i) * K + k_lo) * CD,
                  bytes, bar);
    }
  } else {
    for (int i = 0; i < nn; ++i)
      for (int j = tid; j < kcr * CD; j += blockDim.x)
        ws[i * a.wslot + j] = a.w[(int64_t(n0 + i) * K + k_lo) * CD + j];
  }
  // a group's x and coefficients into buffer `buf` by cp.async (zero
  // past B, N and the block's capsules)
  auto stage = [&](int grp, int buf) {
    const int b0 = grp * kRows;
    float* xs = sm + a.o_xs + buf * xsz;
    float* cs = sm + a.o_cs + buf * csz;
    for (int i = tid; i < NTL * kRows * C; i += blockDim.x) {
      const int c = i % C, b = (i / C) % kRows, n = i / (C * kRows);
      const bool in = n < nn && b0 + b < a.B;
      cp_async4(xs + i,
                in ? a.x + (int64_t(b0 + b) * a.N + n0 + n) * C + c : a.x,
                in);
    }
    for (int i = tid; i < slots * NTL * kRows * kcs; i += blockDim.x) {
      const int kl = i % kcs, b = (i / kcs) % kRows;
      const int n = (i / (kcs * kRows)) % NTL, sl = i / (kcs * kRows * NTL);
      const bool in = n < nn && b0 + b < a.B && kl < kcr;
      cp_async4(cs + i,
                in ? a.coef + sl * BNK + (int64_t(b0 + b) * a.N + n0 + n) * K +
                         k_lo + kl
                   : a.x,
                in);
    }
    cp_async_commit();
  };

  float dwa[NTL][UM][2 * CH];
#pragma unroll
  for (int i = 0; i < NTL; ++i)
#pragma unroll
    for (int u = 0; u < UM; ++u)
#pragma unroll
      for (int e = 0; e < 2 * CH; ++e) dwa[i][u][e] = 0.f;
  const float uniform = 1.f / K;
  const int groups = (a.B + kRows - 1) / kRows;
  const int g0 = blockIdx.z * a.share, g1 = min(groups, g0 + a.share);
  if (g0 < g1) stage(g0, 0);
  __syncthreads();  // the mbarrier initialised
  if (a.bulk) cyt::mbar_wait(bar, 0);

  for (int grp = g0, buf = 0; grp < g1; ++grp, buf ^= 1) {
    const int b0 = grp * kRows;
    const float* xs = sm + a.o_xs + buf * xsz;     // [NTL][16][C]
    const float* cs = sm + a.o_cs + buf * csz;     // [2(T-1)][NTL][16][kcs]
    cp_async_wait_all();
    __syncthreads();  // the group's staging is in; the previous group is
                      // done with the other buffers and red
    if (grp + 1 < g1) stage(grp + 1, buf ^ 1);

    // this lane's entries of term j's state vector for capsule k, n-tile
    // jj: rows g and g + 8, outputs 2q and 2q + 1 (zero past B and D);
    // term j = 0 is (1/K, sbar_0), j = 2t - 1 (probs_t, sbar_t) and j = 2t
    // (Lbar_t, v_{t-1}) for t >= 1
    auto load = [&](int k, int jj, int j0, float (&sv)[kTerms][4]) {
      const int d0 = jj * 8 + 2 * q;
#pragma unroll
      for (int jb = 0; jb < kTerms; ++jb) {
        const int j = j0 + jb;
        const int vec = j % 2 == 1 || j == 0 ? (j + 1) / 2 : v_vec(j / 2 - 1, T);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = b0 + g + 8 * (e >> 1), d = d0 + (e & 1);
          sv[jb][e] = j < terms && b < a.B && d < D
                          ? a.state[(int64_t(b) * nvec + vec) * KD + k * D + d]
                          : 0.f;
        }
      }
    };
    float dxa[NTL][CH][4];
#pragma unroll
    for (int i = 0; i < NTL; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        dxa[i][c][0] = dxa[i][c][1] = dxa[i][c][2] = dxa[i][c][3] = 0.f;
    float sv[kTerms][4];  // the next unit's first terms, loaded ahead
    if (units > 0) load(k_lo + wk0, 0, 0, sv);
    int kk = 0, jj = 0;
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      if (u < units) {
        const int kl = wk0 + kk, k = k_lo + kl, d0 = jj * 8 + 2 * q;
        auto coef = [&](int sl, int i, int r) {
          return cs[((sl * NTL + i) * kRows + g + 8 * r) * kcs + kl];
        };
        // dP = sum_j coef_j vec_j over the 2T - 1 terms
        float dp[NTL][4];
#pragma unroll
        for (int i = 0; i < NTL; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
        for (int j0 = 0; j0 < terms; j0 += kTerms) {
          if (j0 > 0) load(k, jj, j0, sv);
#pragma unroll
          for (int jb = 0; jb < kTerms; ++jb) {
            const int j = j0 + jb;
            if (j >= terms) break;
            const int sl = j % 2 == 1 ? (j - 1) / 2 : T - 2 + j / 2;
#pragma unroll
            for (int i = 0; i < NTL; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                dp[i][e] = fmaf(j == 0 ? uniform : coef(sl, i, e >> 1),
                                sv[jb][e], dp[i][e]);
          }
        }
        // the next unit's state in flight during this unit's products
        const int jn = jj + 1 == nt ? 0 : jj + 1, kn = jn == 0 ? kk + 1 : kk;
        if (u + 1 < units) load(k_lo + wk0 + kn, jn, 0, sv);
#pragma unroll
        for (int i = 0; i < NTL; ++i) {
          if (i >= nn) break;
          // dx[b, c] += sum_d dP[b, d] W[k, c, d]: the product's depth is
          // the n-tile's 8 outputs, column q of A (and row q of B) being
          // output 2q and column q + 4 output 2q + 1
          const float ad[4] = {dp[i][0], dp[i][2], dp[i][1], dp[i][3]};
          const float* wk = ws + i * a.wslot + kl * CD;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            const int c = ch * 8 + g;
            const float bw[2] = {c < C && d0 < D ? wk[c * D + d0] : 0.f,
                                 c < C && d0 + 1 < D ? wk[c * D + d0 + 1]
                                                     : 0.f};
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // short mma chains, f32 sums
            mma3(t, ad, bw);
#pragma unroll
            for (int e = 0; e < 4; ++e) dxa[i][ch][e] += t[e];
          }
          // dW[k, c, d] += sum_b x[b, c] dP[b, d]: dP to the B operand's
          // layout (element a row, output a column) through the tile
          tr[g * 9 + 2 * q] = dp[i][0];
          tr[g * 9 + 2 * q + 1] = dp[i][1];
          tr[(g + 8) * 9 + 2 * q] = dp[i][2];
          tr[(g + 8) * 9 + 2 * q + 1] = dp[i][3];
          __syncwarp();
          const float* xn = xs + i * kRows * C;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int e0 = ks * 8 + q, e1 = e0 + 4;
            const float bd[2] = {tr[e0 * 9 + g], tr[e1 * 9 + g]};
            const float ax[4] = {g < C ? xn[e0 * C + g] : 0.f,
                                 g + 8 < C ? xn[e0 * C + g + 8] : 0.f,
                                 g < C ? xn[e1 * C + g] : 0.f,
                                 g + 8 < C ? xn[e1 * C + g + 8] : 0.f};
            mma3(t, ax, bd);
          }
#pragma unroll
          for (int e = 0; e < 2 * CH; ++e) dwa[i][u][e] += t[e];
          __syncwarp();
        }
        jj = jn;
        kk = kn;
      }
    }
    // dx: the warps' sums in a fixed order (every warp writes its slot)
#pragma unroll
    for (int i = 0; i < NTL; ++i)
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp * NTL + i) * kRows + g + 8 * (e >> 1)) * 8 * CH +
              ch * 8 + 2 * q + (e & 1)] = dxa[i][ch][e];
    __syncthreads();
    float* dx = a.dx + (a.R > 1 ? int64_t(blockIdx.y) * a.B * a.N * C : 0);
    for (int idx = tid; idx < NTL * kRows * C; idx += blockDim.x) {
      const int c = idx % C, b = (idx / C) % kRows, i = idx / (C * kRows);
      if (i >= nn || b0 + b >= a.B) continue;
      float s = 0.f;
      for (int w = 0; w < a.warps; ++w)
        s += red[((w * NTL + i) * kRows + b) * 8 * CH + c];
      dx[(int64_t(b0 + b) * a.N + n0 + i) * C + c] = s;
    }
  }

  // the block's dW, written once
  float* dw = a.dw + (a.shares > 1 ? int64_t(blockIdx.z) * a.N * K * CD : 0);
  int kk = 0, jj = 0;
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (u < units) {
      const int k = k_lo + wk0 + kk, d0 = jj * 8 + 2 * q;
#pragma unroll
      for (int i = 0; i < NTL; ++i) {
        if (i >= nn) break;
#pragma unroll
        for (int r = 0; r < CH; ++r) {
          const int c = g + 8 * r;
          if (c >= C) continue;
          float* dst = dw + ((int64_t(n0 + i) * K + k) * C + c) * D;
          if (d0 < D) dst[d0] = dwa[i][u][2 * r];
          if (d0 + 1 < D) dst[d0 + 1] = dwa[i][u][2 * r + 1];
        }
      }
      if (++jj == nt) {
        jj = 0;
        ++kk;
      }
    }
  }
}

// out = the `parts` slices of `size` floats summed in slice order
__global__ void rg_sum_parts_kernel(const float* __restrict__ parts,
                                    float* __restrict__ out, int64_t size,
                                    int nparts) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < size;
       i += int64_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nparts; ++z) s += parts[z * size + i];
    out[i] = s;
  }
}

cudaError_t sum_parts(const float* parts, float* out, int64_t size,
                      int nparts, cudaStream_t s) {
  const int64_t blocks = (size + 255) / 256;
  rg_sum_parts_kernel<<<int(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      parts, out, size, nparts);
  return cudaGetLastError();
}

template <int UM, int CH>
cudaError_t launch_final(const FinalArgs& a, cudaStream_t s) {
  auto kernel = rg_bwd_final_kernel<UM, CH>;
  if (allow_smem(kernel) < 0) return cudaGetLastError();
  kernel<<<dim3(unsigned(a.tiles), unsigned(a.R), unsigned(a.shares)),
           unsigned(a.warps * 32), 16 + sizeof(float) * size_t(a.floats),
           s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_final(const FinalArgs& a, cudaStream_t s) {
  const int um = unit_bucket(a.cw * a.nt, a.C <= 8);
  switch (um * 2 + (a.C + 7) / 8 - 1) {
    case 8: return launch_final<4, 1>(a, s);
    case 9: return launch_final<4, 2>(a, s);
    case 16: return launch_final<8, 1>(a, s);
    case 17: return launch_final<8, 2>(a, s);
    case 24: return launch_final<12, 1>(a, s);
    case 25: return launch_final<12, 2>(a, s);
    case 32: return launch_final<16, 1>(a, s);
    case 33: return launch_final<16, 2>(a, s);
    case 48: return launch_final<24, 1>(a, s);
  }
  return cudaErrorInvalidValue;
}

// The final launch's plan: the fewest ranges of capsules R whose block
// (W of its nodes, the group's x and coefficients, dx's warp sums) fits
// the card's shared memory with a warp's units in the registers; then
// batch shares when the node tiles and ranges are fewer than the SMs
// (about two blocks a SM).
int plan_final(FinalArgs& a, int B, int N, int K, int C, int D, int T,
               int64_t w_addr) {
  int dev = 0, sms = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  a.B = B;
  a.N = N;
  a.K = K;
  a.C = C;
  a.D = D;
  a.T = T;
  a.nt = (D + 7) / 8;
  a.bulk = (C * D) % 4 == 0 && (w_addr & 15) == 0;
  const int ch = (C + 7) / 8;
  const int groups = (B + kRows - 1) / kRows;
  for (int R = 1; R <= K; ++R) {
    a.R = R;
    a.kcs = (K + R - 1) / R;
    if ((R - 1) * a.kcs >= K) continue;
    a.warps = min(kWarps, a.kcs);
    a.cw = (a.kcs + a.warps - 1) / a.warps;
    a.warps = (a.kcs + a.cw - 1) / a.cw;
    const int um = unit_bucket(a.cw * a.nt, ch == 1);
    if (um == 0) continue;
    a.ntl = final_nodes(um, ch);
    final_layout(a);
    if (16 + sizeof(float) * size_t(a.floats) > size_t(optin)) continue;
    a.tiles = (N + a.ntl - 1) / a.ntl;
    int64_t shares = 1;
    if (int64_t(a.tiles) * R < sms)
      shares = (2 * int64_t(sms) + int64_t(a.tiles) * R - 1) /
               (int64_t(a.tiles) * R);
    shares = shares > groups ? groups : shares;
    a.share = int((groups + shares - 1) / shares);
    a.shares = (groups + a.share - 1) / a.share;
    return R > 65535 || a.shares > 65535
               ? static_cast<int>(cudaErrorInvalidValue)
               : 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kPlanInts = 16;

// both plans' ints, in order (see cyt_routing_bwd_general_plan)
void plan_ints(const TileArgs& p, const FinalArgs& f, int* out) {
  const int v[kPlanInts] = {p.tile,   p.tiles, p.S,     p.NB,
                            p.warps,  p.cw,    p.nt,    p.bulk,
                            f.R,      f.kcs,   f.cw,    f.warps,
                            f.ntl,    f.share, f.shares, f.tiles};
  for (int i = 0; i < kPlanInts; ++i) out[i] = v[i];
}

int make_plans(TileArgs& p, FinalArgs& f, int64_t B, int64_t N, int64_t K,
               int64_t C, int64_t D, int T, int64_t w_addr) {
  if (!shape_ok(B, N, K, C, D) || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = plan_tile(p, int(B), int(N), int(K), int(C), int(D), 2,
                            w_addr);
  if (err == 0)
    err = plan_final(f, int(B), int(N), int(K), int(C), int(D), T, w_addr);
  return err;
}

}  // namespace

// K4g's launch plans for (B, N, K, C, D, n_iter) on the current device,
// for a W at address w_addr, in out[16]: the pass launches' node tile,
// tiles, blocks a cluster, nodes a chunk, warps, capsules a warp,
// n-tiles a capsule and W by bulk copies; the final launch's capsule
// ranges, capsules a range, capsules a warp, warps, nodes a block, groups
// a batch share, shares and node tiles.  Returns 0, or a CUDA error code.
extern "C" int cyt_routing_bwd_general_plan(int64_t B, int64_t N, int64_t K,
                                            int64_t C, int64_t D, int n_iter,
                                            int64_t w_addr, int* out) {
  TileArgs p = {};
  FinalArgs f = {};
  const int err = make_plans(p, f, B, N, K, C, D, n_iter, w_addr);
  if (err == 0) plan_ints(p, f, out);
  return err;
}

// x: (B, N, C) and w: (N, K, C, D) contiguous f32 as K3g read them;
// s_saved: (n_iter, B, K, D) f32 from K3g; g: (B, K, D) f32; state: (B,
// 3 n_iter - 2, K, D) f32 scratch; partial: (B, pass tiles, K, D) f32
// scratch; coef: (2 (n_iter - 1), B, N, K) f32 scratch; dx_parts: (R, B,
// N, C) f32 scratch when the plan has R > 1 capsule ranges, else null;
// dw_parts: (shares, N, K, C, D) f32 scratch when it has more than one
// batch share, else null; dx: (B, N, C) f32; dw: (N, K, C, D) f32; plan:
// the 16 ints of cyt_routing_bwd_general_plan for this w.  Launches
// 2 n_iter kernels (one more with capsule ranges, one more with batch
// shares) on `stream`.  Returns the first error that is not 0, or 0.
extern "C" int cyt_routing_bwd_general(
    const void* x, const void* w, const void* s_saved, const void* g,
    void* state, void* partial, void* coef, void* dx_parts, void* dw_parts,
    void* dx, void* dw, int64_t B, int64_t N, int64_t K, int64_t C,
    int64_t D, int n_iter, const int* plan, void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  TileArgs p = {};
  FinalArgs f = {};
  int err = make_plans(p, f, B, N, K, C, D, n_iter,
                       reinterpret_cast<int64_t>(w));
  if (err != 0) return err;
  int mine[kPlanInts];
  plan_ints(p, f, mine);
  for (int i = 0; i < kPlanInts; ++i)
    if (mine[i] != plan[i]) return static_cast<int>(cudaErrorInvalidValue);
  if ((f.R > 1 && dx_parts == nullptr) || (f.shares > 1 && dw_parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = int(B), k = int(K), d = int(D), T = n_iter;
  const int KD = k * d, nvec = 3 * T - 2;
  const int64_t BNK = int64_t(B) * N * K;
  const float* ss = static_cast<const float*>(s_saved);
  float* st = static_cast<float*>(state);
  float* pt = static_cast<float*>(partial);
  float* cf = static_cast<float*>(coef);
  const int vec_threads = min((KD + 31) / 32 * 32, 1024);
  const size_t vec_smem = sizeof(float) * size_t(2 * KD + 2 * k);

  rg_bwd_prep_kernel<<<b, vec_threads, vec_smem, s>>>(
      ss, static_cast<const float*>(g), st, b, k, d, T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.vec_stride = int64_t(nvec) * KD;
  p.partial = pt;
  for (int t = T - 1; t >= 1; --t) {
    p.vec0 = st + int64_t(vsum_vec(t, T)) * KD;
    p.vec1 = st + int64_t(sbar_vec(t)) * KD;
    p.lbar_in = t < T - 1 ? cf + (T - 1 + t) * BNK : nullptr;
    p.probs_out = cf + (t - 1) * BNK;
    p.lbar_out = cf + (T - 2 + t) * BNK;
    e = run_tile<true>(p, (b + kRows - 1) / kRows, s);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rg_bwd_finish_kernel<<<b, vec_threads, vec_smem, s>>>(
        pt, ss, st, b, k, d, T, p.tiles, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  f.x = p.x;
  f.w = p.w;
  f.state = st;
  f.coef = cf;
  f.dx = f.R > 1 ? static_cast<float*>(dx_parts) : static_cast<float*>(dx);
  f.dw = f.shares > 1 ? static_cast<float*>(dw_parts)
                      : static_cast<float*>(dw);
  e = run_final(f, s);
  if (e == cudaSuccess && f.R > 1)
    e = sum_parts(f.dx, static_cast<float*>(dx), int64_t(B) * N * C, f.R, s);
  if (e == cudaSuccess && f.shares > 1)
    e = sum_parts(f.dw, static_cast<float*>(dw), int64_t(N) * K * C * D,
                  f.shares, s);
  return static_cast<int>(e);
}
