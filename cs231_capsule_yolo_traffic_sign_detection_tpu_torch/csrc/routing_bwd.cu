// K4: the VJP of K3 (capsule votes fused with routing by agreement), for
// sm_90a.
//
// Replaces the TPU kernel ops/routing_pallas.py:_bwd
// (_routing_bwd_kernel, the custom VJP of routed_capsules_pallas): for
// the caps' cotangent g (B, K, D) it gives dx (B, N, C) and dW (N, K, C,
// D).  With priors P[b,n,k,d] = sum_c x[b,n,c] W[n,k,c,d], V_t = v_0 +
// ... + v_{t-1} and probs_t = softmax_k(sum_d P V_t), the reverse sweep
// is, for t = n_iter-1 ... 0:
//   sbar_t = squash VJP of s_t applied to vbar_t (vbar_{n_iter-1} = g)
//   dP    += probs_t sbar_t                           (node-sum VJP)
//   t >= 1: pbar = sum_d P sbar_t, Lbar += probs_t (pbar - sum_k probs_t
//           pbar)                                     (softmax VJP)
//           vbar_{t-1} = sum_n P Lbar,  dP += v_{t-1} Lbar  (agreement VJP)
// then dx[b,n,c] = sum_{k,d} W dP and dW[n,k,c,d] = sum_b x dP.
//
// Bound on the H100: operations.  The votes, dx and dW are 2 B N K C D
// FLOP each (0.91 GFLOP at CapsuleNet's B=64), the reverse sweep and the
// logits rebuilt from V are 5 n_iter - 4 node-sized passes of 2 B N K D
// (1.26 GFLOP at n_iter 3), against 62 MB moved (W read, dW written,
// x and dx); chip_smoke.py:routing_bwd_bound counts it.
//
// What crosses node tiles is worked out first: given the per-element
// vectors s_t, sbar_t, V_t and v_t (K x D each, the "state", 3 n_iter - 2
// vectors, 19 KB an element at K = 43, n_iter 3), everything but vbar is
// local to a node.  So a call is
//  1. bwd_prep_kernel, one block per element: v_t = squash(s_t) and the
//     running sums V_t from the s_t K3 saved (bit-equal to the forward's
//     V), and sbar_{n_iter-1} from g;
//  2. for t = n_iter-1 ... 1, a pass launch of routing_bwd_sweep_kernel
//     <false> that writes partial sums of vbar_{t-1}, then
//     bwd_finish_kernel, one block per element, which sums them in a
//     fixed order and applies the squash VJP to get sbar_{t-1};
//  3. the final launch, routing_bwd_sweep_kernel<true>: dx and dW.
//
// The sweep kernel (this design replaces one that, per (node tile,
// group of 4 elements) block, read the group's state and the tile's W
// from L2: at grad_tile 1 the final launch moved the batch's state once
// per node, 1,296 x 1.23 MB = 1.6 GB, and every sweep launch read W 16
// times, 456 MB f32; 6 block barriers per node and group).  Now:
//  - A CTA owns a few nodes (kPassNodes = 4 in a pass, kFinalNodes = 2
//    in the final launch) for the WHOLE batch.  Thread (k, h) holds W
//    of its capsule k and outputs 2h, 2h + 1 for those nodes in
//    registers, loaded once: W is read from L2 once per launch (28.5
//    MB f32), and the final launch keeps the nodes' dW in registers too,
//    written once at the end.
//  - The CTAs of a thread-block cluster (kCluster = 8 along the nodes)
//    share the state: each group of kG elements' state is copied from
//    global memory once per cluster by TMA bulk copies multicast to all
//    8 CTAs (cp.async.bulk .multicast::cluster, completion counted on an
//    mbarrier), double-buffered, so group g+1's state lands while g
//    computes.  A cluster barrier per group releases the buffer.  State
//    read from L2 per call: (N / 16) x 1.23 MB = 0.1 GB in the final
//    launch at CapsuleNet's shape (less in the passes, which copy only
//    the 2 (n_iter - t_stop) vectors they read), down from 1.6 GB.
//  - Barriers: the logits and pbar of the routing iterations do not
//    depend on each other, so those of all iterations, of all the CTA's
//    nodes and of the group's elements (16 to 32 softmax rows at n_iter
//    3) go through shared memory between ONE barrier pair per group: per
//    2 or 4 nodes and all iterations, where the design it replaces paid
//    a pair per node and iteration.  The capsule lanes' sums are a
//    reduce-scatter by shuffles (7 shuffles per 8 values), the softmax
//    runs 8 lanes per row with the row in registers, and dx is reduced
//    over a warp's 4 capsules by shuffles into per-warp partials that
//    one thread per output sums in warp order.
//  - A pass's partial vbar is reduced over the cluster's CTAs through
//    distributed shared memory: each CTA stores its partial into the
//    rank that sums those columns (the stores do not wait), and each
//    rank sums its columns rank by rank in a fixed order after the
//    group's cluster barrier.  The partials per element are one per
//    cluster (41 at CapsuleNet's shape, was 65), summed in a fixed order
//    by the finish launch.
//  - ptxas (sm_90a): 168 registers in the passes, 161 in the final
//    launch (155 with 2-element groups), no spills; one CTA of 11 warps
//    per SM (the registers and, in the final launch, the two 77 KB state
//    stages); 15 clusters of 8 resident at once on an H100 (120 SMs).
//    The votes stay f32 FMAs in both modes: with 4 elements a group an
//    m16n8k8 would idle 12 of its 16 rows, and the votes are not what
//    bounds this design (PERF.md, PR 4).
// No atomics: dx, dW and every sum are deterministic.  Arithmetic is f32
// throughout, IEEE sqrt, expf and division (no fast math); the squash
// guard is 1e-12.  bf16: x and W are read as bf16 and every product and
// sum stays f32 (the votes are f32 FMAs in both modes); dx and dW come
// out f32.

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8;                // input capsule dim
constexpr int kD = 16;               // output capsule dim
constexpr int kPair = 2;             // outputs per thread
constexpr int kLanes = kD / kPair;   // lanes per capsule
constexpr int kMaxK = 48;            // capsules: 384 threads at most
constexpr int kMaxThreads = kMaxK * kLanes;
constexpr int kMaxIter = 5;
constexpr int kPassNodes = 4, kFinalNodes = 2;  // nodes per CTA
constexpr int kCluster = 8;                      // CTAs per cluster
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanes == kC, "dx's reduce-scatter leaves one c per lane");

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Order of an element's state vectors (T = n_iter): sbar_{T-1}, V_{T-1},
// sbar_{T-2}, V_{T-2}, ..., sbar_1, V_1, then sbar_0, v_0 ... v_{T-2}.
// A pass for t_stop reads the first 2 (T - t_stop) vectors only.
__host__ __device__ __forceinline__ int sbar_vec(int t, int T) {
  return 2 * (T - 1 - t);
}
__host__ __device__ __forceinline__ int vsum_vec(int t, int T) {
  return 2 * (T - 1 - t) + 1;
}
__host__ __device__ __forceinline__ int v_vec(int t, int T) {
  return 2 * T - 1 + t;
}
// vectors a launch copies per element
__host__ __device__ __forceinline__ int copied_vecs(int T, int t_stop) {
  return t_stop == 0 ? 3 * T - 2 : 2 * (T - t_stop);
}

// sum over the 16 lanes of a capsule (j = k * 16 + d: an aligned half
// warp), in the order K3's squash uses
__device__ __forceinline__ float capsule_sum(float v) {
#pragma unroll
  for (int off = 1; off < kD; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// state of one element from the forward's s_t and the cotangent g
__global__ void bwd_prep_kernel(const float* __restrict__ s_saved,
                                const float* __restrict__ g,
                                float* __restrict__ state, int B, int K,
                                int T) {
  const int b = blockIdx.x;
  const int KD = K * kD;
  float* st = state + int64_t(b) * (3 * T - 2) * KD;
  // blockDim.x is a multiple of 32: a capsule's lanes share a warp
  for (int j0 = 0; j0 < KD; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < KD;
    float vsum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float s = valid ? s_saved[(int64_t(t) * B + b) * KD + j] : 0.f;
      const float n2 = capsule_sum(s * s);
      if (t < T - 1) {
        // as routing.cu forms v and V
        const float v = s * (n2 / (1.f + n2) / sqrtf(n2 + 1e-12f));
        vsum = t == 0 ? v : vsum + v;
        if (valid) {
          st[v_vec(t, T) * KD + j] = v;
          st[vsum_vec(t + 1, T) * KD + j] = vsum;
        }
      } else {
        const float gb = valid ? g[int64_t(b) * KD + j] : 0.f;
        const float sv = capsule_sum(s * gb);
        if (valid) st[sbar_vec(t, T) * KD + j] = squash_vjp(s, gb, n2, sv);
      }
    }
  }
}

// sbar_{t-1} from the pass's partial vbar_{t-1}, one block per element
__global__ void bwd_finish_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ s_saved,
                                  float* __restrict__ state, int B, int K,
                                  int T, int parts, int t) {
  const int b = blockIdx.x;
  const int KD = K * kD;
  for (int j0 = 0; j0 < KD; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < KD;
    float vbar = 0.f, s = 0.f;
    if (valid) {
      const float* src = partial + int64_t(b) * parts * KD + j;
      for (int i = 0; i < parts; ++i) vbar += src[int64_t(i) * KD];
      s = s_saved[(int64_t(t - 1) * B + b) * KD + j];
    }
    const float n2 = capsule_sum(s * s);
    const float sv = capsule_sum(s * vbar);
    if (valid)
      state[(int64_t(b) * (3 * T - 2) + sbar_vec(t - 1, T)) * KD + j] =
          squash_vjp(s, vbar, n2, sv);
  }
}

// the columns of a pass's group (kG x K x D) each cluster rank sums:
// an even count, so a thread's float2 never straddles two ranks
__host__ __device__ __forceinline__ int chunk(int columns) {
  return ((columns + kCluster - 1) / kCluster + 1) / 2 * 2;
}

// shared memory of a sweep CTA, in floats after the two mbarriers
struct SweepLayout {
  int st, xs, lg, pb, inner, red, floats;
  __host__ __device__ SweepLayout(int K, int n_iter, int nv, int nodes,
                                  int group, int warps, bool final_launch) {
    const int KD = K * kD, rows = nodes * group;
    st = 0;                                   // [2][group][nv][KD]
    xs = st + 2 * group * nv * KD;            // [2][nodes][group][kC]
    // rows of the routing steps t = n_iter-1 ... 1 (steps <= n_iter-1)
    const int all_rows = (n_iter - 1) * rows;
    lg = xs + 2 * rows * kC;                  // [steps][rows][K] probs
    pb = lg + all_rows * K;                   // [steps][rows][K] pbar
    inner = pb + all_rows * K;                // [steps][rows]
    red = (inner + all_rows + 3) / 4 * 4;     // [2][red_size]
    const int red_size =
        final_launch ? rows * warps * kC : kCluster * chunk(group * KD);
    floats = red + 2 * red_size;
  }
  __host__ __device__ size_t bytes() const {
    return 16 + size_t(floats) * sizeof(float);
  }
};

// kFinal false: a pass launch for t_stop >= 1; writes one partial
// vbar_{t_stop-1} per (element, cluster).  kFinal true: the final
// launch (t_stop 0); writes dx and dW.  The grid is a whole number of
// clusters along x; a CTA past the last node still takes part in the
// copies and the cluster's barriers and reductions.
template <typename T, bool kFinal, int kG>
__global__ void __launch_bounds__(kMaxThreads, 1)
    routing_bwd_sweep_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const float* __restrict__ state,
                             float* __restrict__ partial,
                             float* __restrict__ dx, float* __restrict__ dw,
                             int B, int N, int K, int n_iter, int t_stop) {
  constexpr int NT = kFinal ? kFinalNodes : kPassNodes;
  constexpr int kRows = NT * kG;
  constexpr int kXPer = (NT * kG * kC + 31) / 32;  // x prefetch per thread
  static_assert(kRows % 4 == 0, "softmax rows: 4 per warp alike");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + 16);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  constexpr int cs = kCluster;
  const int KD = K * kD;
  const int nvec = 3 * n_iter - 2;
  const int nv = copied_vecs(n_iter, t_stop);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warps = nthreads / 32, warp = tid / 32, lane = tid % 32;
  const SweepLayout L(K, n_iter, nv, NT, kG, warps, kFinal);
  float* st = smem + L.st;
  float* xs = smem + L.xs;
  const int k = tid / kLanes, h = tid % kLanes;
  const bool valid = k < K;
  // this thread's two outputs; a lane past the K capsules reads the
  // first two (its loads stay inside the element's copied state)
  const int my = valid ? k * kD + h * kPair : 0;
  const int n0 = blockIdx.x * NT;
  const int nn = max(0, min(NT, N - n0));
  const int groups = (B + kG - 1) / kG;
  const float uniform = 1.f / K;  // softmax of zero logits

  // thread 0 of every CTA: expect group grp's state in stage s, and issue
  // this rank's share of its copies (element e goes from rank e % cs to
  // all CTAs of the cluster)
  auto issue = [&](int grp, int s) {
    const int b0 = grp * kG, ne = min(kG, B - b0);
    const uint32_t row = uint32_t(nv) * KD * sizeof(float);
    cyt::mbar_arrive_expect(&bars[s], row * ne);
    for (int e = rank; e < ne; e += cs)
      cyt::bulk_copy_multicast(st + (s * kG + e) * nv * KD,
                               state + int64_t(b0 + e) * nvec * KD, row,
                               &bars[s], uint16_t((1u << cs) - 1));
  };
  // x of group grp for the CTA's nodes: element (i, b, c) of xs
  auto x_at = [&](int grp, int idx) {
    const int c = idx % kC, b = (idx / kC) % kG, i = idx / (kC * kG);
    const int bb = grp * kG + b;
    return bb < B && i < nn ? cyt::to_f(x[(int64_t(bb) * N + n0 + i) * kC + c])
                            : 0.f;
  };

  if (tid == 0) {
    cyt::mbar_init(&bars[0], 1);
    cyt::mbar_init(&bars[1], 1);
    cyt::mbar_init_fence();
  }
  // W of the CTA's nodes, this thread's capsule and outputs
  float2 wv[NT][kC];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      wv[i][c] = valid && i < nn
                     ? load_pair(w + ((int64_t(n0 + i) * K + k) * kC + c) *
                                         kD + h * kPair)
                     : make_float2(0.f, 0.f);
  float2 dwr[kFinal ? NT : 1][kC];
#pragma unroll
  for (int i = 0; i < (kFinal ? NT : 1); ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dwr[i][c] = make_float2(0.f, 0.f);
  for (int i = tid; i < NT * kG * kC; i += nthreads) xs[i] = x_at(0, i);
  cluster.sync();  // barriers initialised in every CTA before any copy
  if (tid == 0) {
    issue(0, 0);
    if (groups > 1) issue(1, 1);
  }

  for (int grp = 0; grp < groups; ++grp) {
    const int s = grp & 1, b0 = grp * kG;
    float xn[kXPer];  // next group's x, stored after the compute
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int idx = tid + j * nthreads;
      xn[j] = grp + 1 < groups && idx < NT * kG * kC ? x_at(grp + 1, idx)
                                                     : 0.f;
    }
    cyt::mbar_wait(&bars[s], (grp >> 1) & 1);
    const float* sg = st + s * kG * nv * KD + my;  // + b nv KD + vec KD
    const float* xg = xs + s * NT * kG * kC;

    // votes: this thread's two outputs, every node and element
    float p[NT][kG][kPair];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int b = 0; b < kG; ++b) {
        const float4* xp =
            reinterpret_cast<const float4*>(xg + (i * kG + b) * kC);
        const float4 xa = xp[0], xb = xp[1];
        const float xv[kC] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float p0 = xv[0] * wv[i][0].x, p1 = xv[0] * wv[i][0].y;
#pragma unroll
        for (int c = 1; c < kC; ++c) {
          p0 = fmaf(xv[c], wv[i][c].x, p0);
          p1 = fmaf(xv[c], wv[i][c].y, p1);
        }
        p[i][b][0] = p0;
        p[i][b][1] = p1;
      }

    float lbar[NT][kG], dp[kFinal ? NT : 1][kG][kPair];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int b = 0; b < kG; ++b) lbar[i][b] = 0.f;
#pragma unroll
    for (int i = 0; i < (kFinal ? NT : 1); ++i)
#pragma unroll
      for (int b = 0; b < kG; ++b) dp[i][b][0] = dp[i][b][1] = 0.f;

    // The routing iterations t = n_iter-1 ... max(t_stop, 1), step j for
    // t = n_iter-1-j.  Their logits and pbar do not depend on each other,
    // so every step's rows go through shared memory together: one
    // barrier pair per group for all steps, nodes and elements.
    const int steps = n_iter - max(t_stop, 1);
    for (int j = 0; j < steps; ++j) {
      const int t = n_iter - 1 - j;
      // logits sum_d P V_t (entries 0 .. kRows-1) and pbar = sum_d P
      // sbar_t (kRows .. 2 kRows-1), summed over the capsule's 8 lanes
      const float* sb = sg + sbar_vec(t, n_iter) * KD;
      const float* vt = sg + vsum_vec(t, n_iter) * KD;
      float lq[2 * kRows];
#pragma unroll
      for (int b = 0; b < kG; ++b) {
        const float2 v2 = load_pair(vt + b * nv * KD);
        const float2 s2 = load_pair(sb + b * nv * KD);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          lq[i * kG + b] = fmaf(p[i][b][1], v2.y, p[i][b][0] * v2.x);
          lq[kRows + i * kG + b] = fmaf(p[i][b][1], s2.y, p[i][b][0] * s2.x);
        }
      }
      cyt::reduce_scatter8<2 * kRows>(lq, h);
      float* lgb = smem + L.lg + j * kRows * K;
      float* pbb = smem + L.pb + j * kRows * K;
      if (valid) {
#pragma unroll
        for (int e = 0; e < 2 * kRows / 8; ++e) {
          const int v = h * (2 * kRows / 8) + e;
          if (v < kRows)
            lgb[v * K + k] = lq[e];
          else
            pbb[(v - kRows) * K + k] = lq[e];
        }
      }
    }
    if (steps > 0) {
      __syncthreads();
      cyt::softmax_rows(smem + L.lg, steps * kRows, K, smem + L.pb,
                        smem + L.inner);
      __syncthreads();
    }
    // Lbar and dP, in the order of the reverse sweep
    for (int j = 0; j < steps; ++j) {
      const int t = n_iter - 1 - j;
      const float* lgb = smem + L.lg + j * kRows * K;
      const float* pbb = smem + L.pb + j * kRows * K;
      const float* inb = smem + L.inner + j * kRows;
      const float* sb = sg + sbar_vec(t, n_iter) * KD;
      const float* vprev = sg + v_vec(t - 1, n_iter) * KD;
#pragma unroll
      for (int b = 0; b < kG; ++b) {
        float2 s2 = make_float2(0.f, 0.f), v2 = s2;
        if constexpr (kFinal) {
          s2 = load_pair(sb + b * nv * KD);
          v2 = load_pair(vprev + b * nv * KD);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int r = i * kG + b;
          const float prob = valid ? lgb[r * K + k] : 0.f;
          const float q = valid ? pbb[r * K + k] : 0.f;
          lbar[i][b] = fmaf(prob, q - inb[r], lbar[i][b]);
          if constexpr (kFinal) {
            dp[i][b][0] += fmaf(prob, s2.x, v2.x * lbar[i][b]);
            dp[i][b][1] += fmaf(prob, s2.y, v2.y * lbar[i][b]);
          }
        }
      }
    }
    if constexpr (kFinal) {  // t = 0: probabilities 1/K, no Lbar
      const float* sb = sg + sbar_vec(0, n_iter) * KD;
#pragma unroll
      for (int b = 0; b < kG; ++b) {
        const float2 s2 = load_pair(sb + b * nv * KD);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          dp[i][b][0] = fmaf(uniform, s2.x, dp[i][b][0]);
          dp[i][b][1] = fmaf(uniform, s2.y, dp[i][b][1]);
        }
      }
    }

    const int cols = chunk(kG * KD);  // pass: columns per rank
    float* red =
        smem + L.red + s * (kFinal ? kRows * warps * kC : kCluster * cols);
    if constexpr (!kFinal) {
      // vbar_{t_stop-1}[k,d] = sum_n P Lbar over the CTA's nodes, stored
      // into the shared memory of the rank that sums column j (slot
      // [this rank][j % cols]): the stores go out without waiting
      if (valid) {
#pragma unroll
        for (int b = 0; b < kG; ++b) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            a0 = fmaf(p[i][b][0], lbar[i][b], a0);
            a1 = fmaf(p[i][b][1], lbar[i][b], a1);
          }
          const int j = b * KD + my, owner = j / cols;
          *reinterpret_cast<float2*>(cluster.map_shared_rank(red, owner) +
                                     rank * cols + j - owner * cols) =
              make_float2(a0, a1);
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < kG; ++b) {
        // an element past B has no state in the stage (its slot holds
        // whatever shared memory held before), and a lane past the K
        // capsules shares dx's warp shuffles below: both give zero
        const bool live = valid && b0 + b < B;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float d0 = live ? dp[i][b][0] : 0.f;
          const float d1 = live ? dp[i][b][1] : 0.f;
          // dx[b, n, c] = sum_{k,d} W dP: over the capsule's lanes by a
          // reduce-scatter (lane h keeps c = h), over the warp's 4
          // capsules by shuffles, over the warps below in a fixed order
          float pc[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            pc[c] = fmaf(wv[i][c].y, d1, wv[i][c].x * d0);
            // dW[n,k,c,d] += x[b,n,c] dP[b,k,d], in registers
            const float xv = xg[(i * kG + b) * kC + c];
            dwr[i][c].x = fmaf(xv, d0, dwr[i][c].x);
            dwr[i][c].y = fmaf(xv, d1, dwr[i][c].y);
          }
          cyt::reduce_scatter8<kC>(pc, h);
          pc[0] += __shfl_xor_sync(kFull, pc[0], 8);
          pc[0] += __shfl_xor_sync(kFull, pc[0], 16);
          if (lane < kC) red[((i * kG + b) * warps + warp) * kC + lane] = pc[0];
        }
      }
    }
    if (grp + 1 < groups) {
      float* xd = xs + (s ^ 1) * NT * kG * kC;
#pragma unroll
      for (int j = 0; j < kXPer; ++j) {
        const int idx = tid + j * nthreads;
        if (idx < NT * kG * kC) xd[idx] = xn[j];
      }
    }
    // every CTA is done with stage s and has written red: release
    cluster.sync();
    if constexpr (!kFinal) {
      // this rank's columns of the group, summed over the cluster's CTAs
      // in rank order
      const int parts = gridDim.x / cs, part = blockIdx.x / cs;
      for (int jj = tid; jj < cols; jj += nthreads) {
        const int j = rank * cols + jj, b = j / KD;
        if (j >= kG * KD || b0 + b >= B) continue;
        float sum = red[jj];
#pragma unroll
        for (int q = 1; q < cs; ++q) sum += red[q * cols + jj];
        partial[(int64_t(b0 + b) * parts + part) * KD + j % KD] = sum;
      }
    } else {
      for (int o = tid; o < kRows * kC; o += nthreads) {
        const int c = o % kC, b = (o / kC) % kG, i = o / (kC * kG);
        if (b0 + b >= B || i >= nn) continue;
        float sum = 0.f;
        for (int q = 0; q < warps; ++q)
          sum += red[((i * kG + b) * warps + q) * kC + c];
        dx[(int64_t(b0 + b) * N + n0 + i) * kC + c] = sum;
      }
    }
    if (tid == 0 && grp + 2 < groups) issue(grp + 2, s);
  }

  if (kFinal && valid) {
    // dW of the CTA's nodes, this thread's slots, written once
#pragma unroll
    for (int i = 0; i < (kFinal ? NT : 1); ++i) {
      if (i >= nn) break;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        *reinterpret_cast<float2*>(
            dw + ((int64_t(n0 + i) * K + k) * kC + c) * kD + h * kPair) =
            dwr[i][c];
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still store to it
}

int pass_threads(int K) { return (K * kLanes + 31) / 32 * 32; }

size_t sweep_smem(int K, int n_iter, int t_stop, int group) {
  const bool final_launch = t_stop == 0;
  return SweepLayout(K, n_iter, copied_vecs(n_iter, t_stop),
                     final_launch ? kFinalNodes : kPassNodes, group,
                     pass_threads(K) / 32, final_launch)
      .bytes();
}

// The launch plan of a call: elements per state copy (4, or 2 where two
// stages of 4 elements' state do not fit), cluster size and CTAs of the
// pass and final launches.
struct Plan {
  int group, cluster, pass_ctas, final_ctas;
  int resident[2] = {0, 0};  // clusters resident at once: final, passes
  int parts() const { return pass_ctas / cluster; }
};

template <typename T, bool kFinal, int kG>
cudaError_t launch(const Plan& plan, const void* x, const void* w,
                   const float* state, float* partial, float* dx, float* dw,
                   int B, int N, int K, int n_iter, int t_stop,
                   cudaStream_t s, bool query, int* clusters) {
  auto* kernel = routing_bwd_sweep_kernel<T, kFinal, kG>;
  const size_t smem = sweep_smem(K, n_iter, t_stop, kG);
  if (query) {  // let the kernel take the card's opt-in shared memory
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kFinal ? plan.final_ctas : plan.pass_ctas);
  cfg.blockDim = dim3(pass_threads(K));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const T*>(w), state, partial, dx, dw,
                            B, N, K, n_iter, t_stop);
}

template <typename T, bool kFinal>
cudaError_t launch_group(const Plan& plan, const void* x, const void* w,
                         const float* state, float* partial, float* dx,
                         float* dw, int B, int N, int K, int n_iter,
                         int t_stop, cudaStream_t s, bool query = false,
                         int* clusters = nullptr) {
  if (plan.group == 4)
    return launch<T, kFinal, 4>(plan, x, w, state, partial, dx, dw, B, N, K,
                                n_iter, t_stop, s, query, clusters);
  return launch<T, kFinal, 2>(plan, x, w, state, partial, dx, dw, B, N, K,
                              n_iter, t_stop, s, query, clusters);
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The plan for (B, N, K, n_iter) on the current device, checked: each
// launch's shared memory fits and its clusters can be resident.  Lets
// the kernels take the card's opt-in shared memory, so that a launch
// sets nothing.
template <typename T>
cudaError_t make_plan(int B, int N, int K, int n_iter, Plan* plan) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  plan->group = sweep_smem(K, n_iter, 0, 4) <= size_t(optin) ? 4 : 2;
  if (sweep_smem(K, n_iter, 0, plan->group) > size_t(optin))
    return cudaErrorInvalidValue;
  const int pass_ctas = (N + kPassNodes - 1) / kPassNodes;
  const int final_ctas = (N + kFinalNodes - 1) / kFinalNodes;
  plan->cluster = kCluster;
  plan->pass_ctas = round_up(pass_ctas, plan->cluster);
  plan->final_ctas = round_up(final_ctas, plan->cluster);
  for (int t = 0; t < n_iter; ++t) {
    int clusters = 0;
    err = t == 0 ? launch_group<T, true>(*plan, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, B, N, K,
                                         n_iter, 0, nullptr, true, &clusters)
                 : launch_group<T, false>(*plan, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, nullptr, B, N, K,
                                          n_iter, t, nullptr, true, &clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    const int r = t == 0 ? 0 : 1;
    plan->resident[r] =
        plan->resident[r] ? min(plan->resident[r], clusters) : clusters;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const Plan& plan, const void* x, const void* w,
                const float* s_saved, const float* g, float* state,
                float* partial, float* dx, float* dw, int B, int N, int K,
                int n_iter, cudaStream_t s) {
  const int vec_threads = (K * kD + 31) / 32 * 32;
  bwd_prep_kernel<<<B, vec_threads, 0, s>>>(s_saved, g, state, B, K, n_iter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int t = n_iter - 1; t >= 1; --t) {
    err = launch_group<T, false>(plan, x, w, state, partial, nullptr, nullptr,
                                 B, N, K, n_iter, t, s);
    if (err != cudaSuccess) return err;
    bwd_finish_kernel<<<B, vec_threads, 0, s>>>(partial, s_saved, state, B,
                                                K, n_iter, plan.parts(), t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_group<T, true>(plan, x, w, state, nullptr, dx, dw, B, N, K,
                               n_iter, 0, s);
}

bool shape_ok(int64_t B, int64_t N, int64_t K, int n_iter) {
  return B > 0 && N > 0 && K > 0 && K <= kMaxK && n_iter >= 1 &&
         n_iter <= kMaxIter && B * N * kC < (int64_t(1) << 31) &&
         N * K * kC * kD < (int64_t(1) << 31);
}

}  // namespace

// K4's launch plan for (B, N, K, n_iter) in dtype on the current device:
// plan[0] elements per state copy, plan[1] CTAs per cluster, plan[2]
// nodes per CTA in a pass launch, plan[3] in the final launch, plan[4]
// partial sums per element (the pass launch's clusters), plan[5] and
// plan[6] the clusters resident at once in the final launch and in the
// pass launches (the fewest over them).  Returns 0, or
// a CUDA error code (too much shared memory, clusters that cannot be
// resident).
extern "C" int cyt_routing_bwd_plan(int64_t B, int64_t N, int64_t K,
                                    int n_iter, int dtype, int* out) {
  if (!shape_ok(B, N, K, n_iter))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == cyt::kFloat32)
    err = make_plan<float>(int(B), int(N), int(K), n_iter, &plan);
  else if (dtype == cyt::kBFloat16)
    err = make_plan<__nv_bfloat16>(int(B), int(N), int(K), n_iter, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = plan.group;
  out[1] = plan.cluster;
  out[2] = kPassNodes;
  out[3] = kFinalNodes;
  out[4] = plan.parts();
  out[5] = plan.resident[0];
  out[6] = plan.resident[1];
  return 0;
}

// x: (B, N, C) and w: (N, K, C, D) contiguous in dtype (C = 8, D = 16,
// K <= 48, n_iter <= 5), as K3 read them; s_saved: (n_iter, B, K, D) f32
// from K3; g: (B, K, D) f32; state: (B, 3 n_iter - 2, K, D) f32 scratch,
// 16-byte aligned; partial: (B, plan[4], K, D) f32 scratch; dx: (B, N, C)
// f32; dw: (N, K, C, D) f32; group: plan[0] of cyt_routing_bwd_plan.  Launches 2 n_iter kernels on `stream`.  Returns
// the first error a launch reported, or 0.
extern "C" int cyt_routing_bwd(const void* x, const void* w,
                               const void* s_saved, const void* g,
                               void* state, void* partial, void* dx,
                               void* dw, int64_t B, int64_t N, int64_t K,
                               int64_t C, int64_t D, int n_iter, int group,
                               int dtype, void* stream) {
  if (!shape_ok(B, N, K, n_iter) || C != kC || D != kD ||
      (group != 4 && group != 2) || !cyt::aligned16(state) || (reinterpret_cast<uintptr_t>(w) & 7u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = int(B), n = int(N), k = int(K);
  const Plan plan{group, kCluster,
                  round_up((n + kPassNodes - 1) / kPassNodes, kCluster),
                  round_up((n + kFinalNodes - 1) / kFinalNodes, kCluster)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ss = static_cast<const float*>(s_saved);
  const float* gg = static_cast<const float*>(g);
  float* st = static_cast<float*>(state);
  float* p = static_cast<float*>(partial);
  float* ox = static_cast<float*>(dx);
  float* ow = static_cast<float*>(dw);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == cyt::kFloat32)
    err = run<float>(plan, x, w, ss, gg, st, p, ox, ow, b, n, k, n_iter, s);
  else if (dtype == cyt::kBFloat16)
    err = run<__nv_bfloat16>(plan, x, w, ss, gg, st, p, ox, ow, b, n, k,
                             n_iter, s);
  return static_cast<int>(err);
}
