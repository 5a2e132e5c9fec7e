// Shared by K3g (routing_general.cu) and K4g (routing_general_bwd.cu),
// the routing kernels for every capsule shape outside K3/K4's tuned one:
// the shape limits, the per-capsule arithmetic both directions must do
// bit for bit alike (|s|^2, the squash, its VJP), the 3xTF32 products on
// the tensor cores, and the node-tile pass both directions run
// (rg_tile_kernel: the routing pass of K3g, the reverse-sweep pass of
// K4g).
//
// The pass.  A block takes a group of kRows = 16 elements (the M of
// mma.sync m16n8k8) and a tile of nodes; a thread-block cluster of S
// blocks splits the K capsules when one block's registers or shared
// memory cannot take them all (block r of the cluster takes capsules
// r kcs ... r kcs + kcs - 1), and a warp takes cw whole capsules of its
// block's range, each capsule's D outputs as n-tiles of 8 (the warp's
// "units": cw x ceil(D / 8), a bucket of 4, 8 or 12 run straight-line).
// For each chunk of NB nodes (NB 1 or 2, as the registers allow):
//  1. votes: P (16 elements x 8 outputs) = x (16 x in_C) W (in_C x 8)
//     for each unit on the tensor cores as a split-precision ("3xTF32")
//     product: each operand a is split into hi = tf32(a) (rounded to
//     nearest, ties away, as cvt.rna) and lo = tf32(a - hi), and a b is
//     taken as a_lo b_hi + a_hi b_lo + a_hi b_hi into a fresh f32
//     accumulator (about 2^-22 of |a b| off, where one TF32 pass is 2^-11
//     off; long mma accumulation chains drift, so none is kept); in_C
//     <= 16 is two k-steps.  The votes stay in registers.  Their dot
//     products with the staged per-element vectors (K3g: V = v_0 + ... +
//     v_{t-1}; K4g: V_t and sbar_t), over a capsule's n-tiles in
//     registers and then the 4 lanes of a row by shuffles, give one logit
//     (and pbar) per (element, capsule) in shared memory (copied to the
//     cluster's other blocks);
//  2. one barrier (a cluster barrier with S > 1); then each block forms
//     every row's softmax over the K capsules (8 lanes a row, f32, max
//     subtracted, IEEE expf and division) and K3g's probabilities or
//     K4g's Lbar_t = Lbar_{t+1} + probs (pbar - sum_k probs pbar), which
//     K4g also writes to global memory for its later launches; one block
//     barrier;
//  3. the node sums s (K3g) or vbar (K4g) += coef P by f32 FMAs in
//     registers.
// The first forward pass has no logits (every probability 1/K): no
// barrier pair, and the votes go straight into the sums.  W reaches
// shared memory by TMA bulk copies, one a node, two chunks ahead on two
// mbarriers; where in_C D is not a multiple of 4 (16-byte copies) the
// threads copy it.  The per-element vectors and the tile's x are staged
// once per block.  No atomics: every sum has a fixed order, so two calls
// give the same bits.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace cyt {
namespace rg {

namespace cg = cooperative_groups;

constexpr int kMaxC = 16;    // input capsule dim
constexpr int kMaxK = 64;    // output capsules
constexpr int kMaxD = 64;    // output capsule dim
constexpr int kRows = 16;    // elements a group: the mma's M
constexpr int kWarps = 16;   // warps a block at most
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

inline bool shape_ok(int64_t B, int64_t N, int64_t K, int64_t C, int64_t D) {
  return B > 0 && N > 0 && K > 0 && K <= kMaxK && C > 0 && C <= kMaxC &&
         D > 0 && D <= kMaxD && B * N * K < (int64_t(1) << 40) &&
         B * N * C < (int64_t(1) << 40) &&
         N * K * C * D < (int64_t(1) << 40);
}

// |s|^2 of one capsule, summed in order d = 0 .. D-1: the forward's
// squash and the backward's rebuild of v_t and V_t call this on the same
// s_t, so they agree to the bit
__device__ __forceinline__ float capsule_n2(const float* s, int D) {
  float n2 = 0.f;
  for (int d = 0; d < D; ++d) n2 = fmaf(s[d], s[d], n2);
  return n2;
}

__device__ __forceinline__ float capsule_dot(const float* a, const float* b,
                                             int D) {
  float r = 0.f;
  for (int d = 0; d < D; ++d) r = fmaf(a[d], b[d], r);
  return r;
}

// the squash's scale as the TPU kernel computes it, IEEE sqrt and
// division: v = s * (|s|^2 / (1 + |s|^2) / sqrt(|s|^2 + 1e-12))
__device__ __forceinline__ float squash_scale(float n2) {
  return n2 / (1.f + n2) / sqrtf(n2 + 1e-12f);
}

// squash VJP: sc vbar + 2 s scp <s, vbar>, with sc = n2 u r and its
// derivative scp in the JAX kernel's closed form (u = 1 / (1 + n2),
// r = 1 / sqrt(n2 + 1e-12)); n2 and sv are the capsule's |s|^2, <s, vbar>
__device__ __forceinline__ float squash_vjp(float s, float vbar, float n2,
                                            float sv) {
  const float u = 1.f / (1.f + n2);
  const float r = 1.f / sqrtf(n2 + 1e-12f);
  const float sc = n2 * u * r;
  const float scp = u * r - n2 * u * u * r - 0.5f * n2 * u * r * r * r;
  return sc * vbar + 2.f * s * scp * sv;
}

// ---- 3xTF32 on the tensor cores (as K2's f32 kernel, input_stage.cu)

// cvt.rna.tf32.f32 as two integer operations: add half a TF32 ulp to the
// magnitude's bits, clear the 13 bits that TF32 drops
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 2^-22 of |v|: hi = tf32(v), lo = tf32(v - hi)
// (v - hi is exact in f32)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

template <int kN>
__device__ __forceinline__ void split(const float (&v)[kN],
                                      uint32_t (&hi)[kN],
                                      uint32_t (&lo)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) split(v[i], hi[i], lo[i]);
}

// d += A B, m16n8k8, TF32 operands, f32 accumulation: A 16 x 8 (a0: row
// l / 4, a1: row l / 4 + 8, column l % 4; a2, a3: the same rows, column
// + 4), B 8 x 8 (b0: row l % 4, b1: row + 4; column l / 4), d 16 x 8
// (d0, d1: row l / 4, columns 2 (l % 4) and + 1; d2, d3: row l / 4 + 8)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A B, the same product with a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += A B in split precision, A split already: the two small products
// first (d = A B with `zero`)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b)[2], bool zero = false) {
  uint32_t bh[2], bl[2];
  split(b, bh, bl);
  if (zero)
    mma_tf32_zero(d, al, bh);
  else
    mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     const float (&b)[2]) {
  uint32_t ah[4], al[4];
  split(a, ah, al);
  mma3(d, ah, al, b);
}

// 4 bytes from global to shared memory by cp.async, or zeros when !in
// (src is then any valid address: nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- the node-tile pass

// One launch of rg_tile_kernel: its operands and its plan.  nv: the
// per-element vectors dotted with the votes (0: the first forward pass,
// every probability 1/K; 1: K3g's V; 2: K4g's V_t and sbar_t).
struct TileArgs {
  const float* x;      // (B, N, C)
  const float* w;      // (N, K, C, D)
  const float* vec0;   // element b's vectors at vec + b vec_stride, (K, D)
  const float* vec1;
  int64_t vec_stride;
  const float* lbar_in;  // K4g: Lbar_{t+1} (B, N, K), or null
  float* probs_out;      // K4g: probs_t (B, N, K)
  float* lbar_out;       // K4g: Lbar_t (B, N, K)
  float* partial;        // (B, tiles, K, D): the tile's node sums
  int B, N, K, C, D;
  int nv;
  int S;      // blocks a cluster
  int kcs;    // capsules a block of the cluster
  int cw;     // capsules a warp
  int warps;  // warps a block
  int nt;     // n-tiles of 8 outputs a capsule
  int NB;     // nodes a chunk (1 or 2)
  int tile;   // nodes a block
  int tiles;
  int bulk;   // W by TMA bulk copies
  // shared memory, in floats after 16 bytes of mbarriers
  int wslot, o_vs, o_xs, o_lgp, o_pr, floats;
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

inline void tile_layout(TileArgs& a) {
  const int Dp = a.nt * 8;
  a.wslot = round4(a.kcs * a.C * a.D);
  a.o_vs = 2 * a.NB * a.wslot;
  a.o_xs = a.o_vs + a.nv * kRows * a.kcs * Dp;
  a.o_lgp = a.o_xs + round4(a.tile * kRows * a.C);
  a.o_pr = a.o_lgp + 2 * a.nv * a.NB * kRows * a.K;
  a.floats = a.o_pr + (a.nv > 0 ? a.NB * kRows * a.K : 0);
}

inline size_t tile_bytes(const TileArgs& a) {
  return 16 + sizeof(float) * size_t(a.floats);
}

// the rows of x for k-step ks of node i's votes: a lane's A fragment
__device__ __forceinline__ void x_frag(float (&a)[4], const float* xn,
                                       int C, int ks, int g, int q) {
  const int c0 = ks * 8 + q, c1 = c0 + 4;
  a[0] = c0 < C ? xn[g * C + c0] : 0.f;
  a[1] = c0 < C ? xn[(g + 8) * C + c0] : 0.f;
  a[2] = c1 < C ? xn[g * C + c1] : 0.f;
  a[3] = c1 < C ? xn[(g + 8) * C + c1] : 0.f;
}

// W of capsule `wk` (C x D in shared memory) for k-step ks and n-tile
// jj: a lane's B fragment
__device__ __forceinline__ void w_frag(float (&b)[2], const float* wk,
                                       int C, int D, int ks, int jj, int g,
                                       int q) {
  const int c0 = ks * 8 + q, c1 = c0 + 4, d = jj * 8 + g;
  b[0] = c0 < C && d < D ? wk[c0 * D + d] : 0.f;
  b[1] = c1 < C && d < D ? wk[c1 * D + d] : 0.f;
}

// nodes a chunk for a warp's units a bound: the chunk's votes stay in
// registers (NB x UM x 4) beside the node sums (UM x 4)
__host__ __device__ constexpr int tile_chunk(int um) { return um <= 8 ? 2 : 1; }

template <int NV, int UM, int CH>
__global__ void __launch_bounds__(kWarps * 32, 1)
    rg_tile_kernel(const TileArgs a) {
  constexpr bool kBwd = NV == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw + 16);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = int(cl.block_rank());
  const int tile = blockIdx.x / a.S, grp = blockIdx.y;
  const int b0 = grp * kRows, n0 = tile * a.tile;
  const int nn = min(a.tile, a.N - n0);
  const int k_lo = rank * a.kcs, kcr = min(a.K - k_lo, a.kcs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int K = a.K, C = a.C, D = a.D, CD = C * D, nt = a.nt;
  const int Dp = nt * 8;
  const int wk0 = warp * a.cw;                    // the warp's capsules
  const int units = max(0, min(a.cw, kcr - wk0)) * nt;
  float* wbuf = sm;
  float* vs = sm + a.o_vs;
  float* xs = sm + a.o_xs;
  float* lgp = sm + a.o_lgp;
  float* pr = sm + a.o_pr;
  const int chunks = (nn + a.NB - 1) / a.NB;

  // W of chunk ch's nodes, capsules k_lo .. k_lo + kcr - 1, into buffer
  // ch & 1: one bulk copy a node by thread 0, or every thread's loads
  auto fill = [&](int ch) {
    const int nq = min(a.NB, nn - ch * a.NB);
    float* dst = wbuf + (ch & 1) * a.NB * a.wslot;
    const float* src = a.w + (int64_t(n0 + ch * a.NB) * K + k_lo) * CD;
    if (a.bulk) {
      if (tid == 0) {
        const uint32_t bytes = uint32_t(kcr * CD) * sizeof(float);
        mbar_arrive_expect(&bars[ch & 1], bytes * nq);
        for (int i = 0; i < nq; ++i)
          bulk_copy(dst + i * a.wslot, src + int64_t(i) * K * CD, bytes,
                    &bars[ch & 1]);
      }
    } else {
      for (int i = 0; i < nq; ++i)
        for (int j = tid; j < kcr * CD; j += blockDim.x)
          dst[i * a.wslot + j] = src[int64_t(i) * K * CD + j];
    }
  };

  if (a.bulk && tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  // the group's vectors for the block's capsules (zero past B and D), the
  // tile's x (zero past B)
  for (int i = tid; i < NV * kRows * a.kcs * Dp; i += blockDim.x) {
    const int d = i % Dp, kl = (i / Dp) % a.kcs, b = (i / (Dp * a.kcs)) % kRows;
    const int v = i / (Dp * a.kcs * kRows);
    const float* src = v == 0 ? a.vec0 : a.vec1;
    vs[i] = b0 + b < a.B && kl < kcr && d < D
                ? src[(b0 + b) * a.vec_stride + (k_lo + kl) * D + d]
                : 0.f;
  }
  for (int i = tid; i < nn * kRows * C; i += blockDim.x) {
    const int c = i % C, b = (i / C) % kRows, n = i / (C * kRows);
    xs[i] = b0 + b < a.B ? a.x[(int64_t(b0 + b) * a.N + n0 + n) * C + c]
                         : 0.f;
  }
  __syncthreads();  // mbarriers initialised before the first copy
  fill(0);
  if (chunks > 1) fill(1);
  cl.sync();  // staged; every block of the cluster runs

  // a.NB <= kNB; the first forward pass keeps no votes across a barrier
  constexpr int kNB = NV > 0 ? tile_chunk(UM) : 2;
  const int NB = a.NB;
  float acc[UM][4];  // the node sums: rows g, g + 8; outputs 2q, 2q + 1
#pragma unroll
  for (int u = 0; u < UM; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
  const float uniform = 1.f / K;  // softmax of zero logits
  // the warp's units (capsule kk, n-tile jj) in order, straight-line: a
  // unit past the warp's capsules computes on the last capsule of the
  // block and publishes and stores nothing
  auto next_unit = [&](int& kk, int& jj) {
    const bool wrap = jj + 1 == nt;
    jj = wrap ? 0 : jj + 1;
    kk += wrap ? 1 : 0;
  };

  for (int ch = 0; ch < chunks; ++ch) {
    const int par = ch & 1;
    const float* wq = wbuf + par * NB * a.wslot;
    const int nq = min(NB, nn - ch * NB);
    if (a.bulk) mbar_wait(&bars[par], (ch >> 1) & 1);
    // 1. the chunk's votes, kept in registers until the node sums, and
    // their dot products with the staged vectors, summed over a
    // capsule's n-tiles in registers, then over a row's 4 lanes: one
    // logit (and pbar) per (element, capsule) into lgp
    float P[NV > 0 ? kNB : 1][UM][4];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      if (i >= nq) break;
      const float* xn = xs + (ch * NB + i) * kRows * C;
      uint32_t xh[CH][4], xl[CH][4];
#pragma unroll
      for (int ks = 0; ks < CH; ++ks) {
        float xa[4];
        x_frag(xa, xn, C, ks, g, q);
        split(xa, xh[ks], xl[ks]);
      }
      float run[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [vector][row g, g+8]
      int kk = 0, jj = 0;
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        const int kl = min(wk0 + kk, kcr - 1);
        const float* wk = wq + i * a.wslot + kl * CD;
        float pv[4];  // the unit's votes
#pragma unroll
        for (int ks = 0; ks < CH; ++ks) {
          float b[2];
          w_frag(b, wk, C, D, ks, jj, g, q);
          mma3(pv, xh[ks], xl[ks], b, ks == 0);
        }
        if constexpr (NV == 0) {  // every probability 1/K: sum at once
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(uniform, pv[e], acc[u][e]);
          next_unit(kk, jj);
          continue;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) P[i][u][e] = pv[e];
        }
        const int col = jj * 8 + 2 * q;
        const bool publish = u < units && jj + 1 == nt;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v >= NV) break;
          const float* vv = vs + (v * kRows * a.kcs + kl) * Dp + col;
          const float2 lo = *reinterpret_cast<const float2*>(
              vv + g * a.kcs * Dp);
          const float2 hi = *reinterpret_cast<const float2*>(
              vv + (g + 8) * a.kcs * Dp);
          const float r0 = jj == 0 ? 0.f : run[v][0];
          const float r1 = jj == 0 ? 0.f : run[v][1];
          run[v][0] = fmaf(P[i][u][1], lo.y, fmaf(P[i][u][0], lo.x, r0));
          run[v][1] = fmaf(P[i][u][3], hi.y, fmaf(P[i][u][2], hi.x, r1));
          if (publish) {  // the capsule's last n-tile: over the row's lanes
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float sum = run[v][r];
              sum += __shfl_xor_sync(kFull, sum, 1);
              sum += __shfl_xor_sync(kFull, sum, 2);
              if (q == 0)
                lgp[(((par * NV + v) * NB + i) * kRows + g + 8 * r) * K +
                    k_lo + kl] = sum;
            }
          }
        }
        next_unit(kk, jj);
      }
    }
    if (a.S > 1 && NV > 0) {
      // the warp's logits to the cluster's other blocks
      __syncwarp();
      const int wcaps = max(0, min(a.cw, kcr - wk0));
      for (int e = lane; e < NV * nq * kRows * wcaps; e += 32) {
        const int kc = e % wcaps, r = (e / wcaps) % (nq * kRows);
        const int v = e / (wcaps * nq * kRows);
        float* src = lgp + ((par * NV + v) * NB * kRows + r) * K + k_lo +
                     wk0 + kc;
        const float val = *src;
        for (int rr = 0; rr < a.S; ++rr)
          if (rr != rank) *cl.map_shared_rank(src, rr) = val;
      }
    }
    if constexpr (NV > 0) {
      // every logit of the chunk is in every block; every warp is done
      // with this chunk's W
      if (a.S == 1)
        __syncthreads();
      else
        cl.sync();
      if (ch + 2 < chunks) fill(ch + 2);
      // 2. each row's softmax over the K capsules (and K4g's softmax
      // VJP), 8 lanes a row (k = h, h + 8, ...), 4 rows a warp
      for (int r0 = 4 * warp; r0 < nq * kRows; r0 += 4 * a.warps) {
        const int r = r0 + (lane >> 3), h = lane & 7;
        const int i = r / kRows, b = b0 + r % kRows;
        const int n = n0 + ch * NB + i;
        const float* l0 = lgp + ((par * NV) * NB * kRows + r) * K;
        const int64_t o = (int64_t(b) * a.N + n) * K;
        float prev[8];  // K4g: Lbar_{t+1}, in flight during the softmax
        if constexpr (kBwd) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            prev[j] = a.lbar_in != nullptr && b < a.B && h + 8 * j < K
                          ? a.lbar_in[o + h + 8 * j]
                          : 0.f;
        }
        float p[8], m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = h + 8 * j < K ? l0[h + 8 * j] : __int_as_float(0xff800000);
          m = fmaxf(m, p[j]);
        }
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 4));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = h + 8 * j < K ? expf(p[j] - m) : 0.f;
          sum += p[j];
        }
        sum += __shfl_xor_sync(kFull, sum, 4);
        sum += __shfl_xor_sync(kFull, sum, 2);
        sum += __shfl_xor_sync(kFull, sum, 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] = p[j] / sum;
        if constexpr (kBwd) {
          const float* l1 = l0 + NB * kRows * K;
          float pb[8], dot = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            pb[j] = h + 8 * j < K ? l1[h + 8 * j] : 0.f;
            dot = fmaf(p[j], pb[j], dot);
          }
          dot += __shfl_xor_sync(kFull, dot, 4);
          dot += __shfl_xor_sync(kFull, dot, 2);
          dot += __shfl_xor_sync(kFull, dot, 1);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = h + 8 * j;
            if (k >= K) break;
            const float lb = fmaf(p[j], pb[j] - dot, prev[j]);
            pr[r * K + k] = lb;
            if (rank == 0 && b < a.B) {
              a.probs_out[o + k] = p[j];
              a.lbar_out[o + k] = lb;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (h + 8 * j < K) pr[r * K + h + 8 * j] = p[j];
        }
      }
      __syncthreads();
    } else {
      __syncthreads();  // every warp is done with this chunk's W
      if (ch + 2 < chunks) fill(ch + 2);
    }
    // 3. the node sums: acc += coef P, f32 FMAs, node by node
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      if (NV == 0 || i >= nq) break;
      const float* prow = pr + i * kRows * K + k_lo;
      int kk = 0, jj = 0;
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        const int kl = min(wk0 + kk, kcr - 1);
        const float c0 = prow[g * K + kl];
        const float c1 = prow[(g + 8) * K + kl];
        acc[u][0] = fmaf(c0, P[i][u][0], acc[u][0]);
        acc[u][1] = fmaf(c0, P[i][u][1], acc[u][1]);
        acc[u][2] = fmaf(c1, P[i][u][2], acc[u][2]);
        acc[u][3] = fmaf(c1, P[i][u][3], acc[u][3]);
        next_unit(kk, jj);
      }
    }
  }

  // the tile's node sums of the group's elements
  const int KD = K * D;
  int kk = 0, jj = 0;
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (u < units) {
      const int k = k_lo + wk0 + kk, d = jj * 8 + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + g + 8 * r;
        if (b >= a.B) continue;
        float* dst = a.partial + (int64_t(b) * a.tiles + tile) * KD + k * D;
        if (d < D) dst[d] = acc[u][2 * r];
        if (d + 1 < D) dst[d + 1] = acc[u][2 * r + 1];
      }
      if (++jj == nt) {
        jj = 0;
        ++kk;
      }
    }
  }
  cl.sync();  // no block leaves while its cluster may still write to it
}

// let `kernel` take up to the card's opt-in shared memory; returns it,
// or -1 on a CUDA error
template <typename Kernel>
int allow_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess)
    return -1;
  return optin;
}

// the smallest of 4, 8, 12, 16 (and 24 with `wide`) that holds `units`
inline int unit_bucket(int units, bool wide) {
  const int buckets[] = {4, 8, 12, 16, 24};
  for (int u : buckets)
    if (units <= u && (u <= 16 || wide)) return u;
  return 0;
}

template <int NV, int UM, int CH>
cudaError_t launch_tile(const TileArgs& a, int groups, cudaStream_t s) {
  auto kernel = rg_tile_kernel<NV, UM, CH>;
  if (allow_smem(kernel) < 0) return cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(a.S * a.tiles), unsigned(groups));
  cfg.blockDim = dim3(unsigned(a.warps * 32));
  cfg.dynamicSmemBytes = tile_bytes(a);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(a.S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// rg_tile_kernel<NV, UM, CH> for the pass's vectors, the plan's units a
// warp and in_C
template <int NV>
cudaError_t run_tile_nv(const TileArgs& a, int groups, cudaStream_t s) {
  const int um = unit_bucket(a.cw * a.nt, false);
  const int ch = (a.C + 7) / 8;
  switch (um * 2 + ch - 1) {
    case 8: return launch_tile<NV, 4, 1>(a, groups, s);
    case 9: return launch_tile<NV, 4, 2>(a, groups, s);
    case 16: return launch_tile<NV, 8, 1>(a, groups, s);
    case 17: return launch_tile<NV, 8, 2>(a, groups, s);
    case 24: return launch_tile<NV, 12, 1>(a, groups, s);
    case 25: return launch_tile<NV, 12, 2>(a, groups, s);
  }
  return cudaErrorInvalidValue;
}

// K3g's passes (nv 0 or 1) or K4g's (nv 2)
template <bool kBwd>
cudaError_t run_tile(const TileArgs& a, int groups, cudaStream_t s) {
  if constexpr (kBwd)
    return run_tile_nv<2>(a, groups, s);
  else
    return a.nv == 0 ? run_tile_nv<0>(a, groups, s)
                     : run_tile_nv<1>(a, groups, s);
}

// The plan of a pass over (B, N, K, C, D) with nv staged vectors: the
// fewest blocks a cluster S whose block fits the card's shared memory
// with a tile of at least 16 nodes (or N) and a warp's units in the
// registers (12 n-tiles, with a chunk of tile_chunk nodes); then the
// node tile in
// [16, 64] that minimises the waves of clusters times (tile + 4), the 4
// for a block's staging, on a tie the larger.  Returns 0, or a CUDA
// error code.
inline int plan_tile(TileArgs& a, int B, int N, int K, int C, int D, int nv,
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
  a.nv = nv;
  a.nt = (D + 7) / 8;
  a.bulk = (C * D) % 4 == 0 && (w_addr & 15) == 0;
  const int groups = (B + kRows - 1) / kRows;
  const int min_tile = min(N, 16);
  for (int S = 1; S <= kMaxCluster && S <= K; ++S) {
    a.S = S;
    a.kcs = (K + S - 1) / S;
    if ((S - 1) * a.kcs >= K) continue;  // a block without capsules
    // the fewest capsules a warp, then as many as its bucket of units
    // holds (a full bucket runs no idle units)
    a.cw = (a.kcs + kWarps - 1) / kWarps;
    const int um = unit_bucket(a.cw * a.nt, false);
    if (um == 0 || um > 12) continue;
    a.cw = min(a.kcs, max(a.cw, um / a.nt));
    a.warps = (a.kcs + a.cw - 1) / a.cw;
    a.NB = tile_chunk(um);
    a.tile = min_tile;
    tile_layout(a);
    if (tile_bytes(a) > size_t(optin)) {
      a.NB = 1;
      tile_layout(a);
    }
    if (tile_bytes(a) > size_t(optin)) continue;
    // clusters resident at once: the block's registers allow one a SM
    const int64_t slots = max(1, sms / S);
    int64_t best = -1;
    int best_tile = min_tile;
    for (int t = min(N, 64); t >= min_tile; --t) {
      a.tile = t;
      tile_layout(a);
      if (tile_bytes(a) > size_t(optin)) continue;
      const int64_t clusters = int64_t((N + t - 1) / t) * groups;
      const int64_t cost = (clusters + slots - 1) / slots * (t + 4);
      if (best < 0 || cost < best) {
        best = cost;
        best_tile = t;
      }
    }
    a.tile = best_tile;
    a.tiles = (N + a.tile - 1) / a.tile;
    tile_layout(a);
    return groups > 65535 ? static_cast<int>(cudaErrorInvalidValue) : 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rg
}  // namespace cyt
