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
// Design.  The TPU kernel keeps all of W and a dW accumulator (34.6 MB
// each, padded) resident in VMEM and walks the batch one element per
// grid step.  An SM has 228 KB, so here nodes are tiled as in K3, and
// what crosses node tiles is worked out first: given the per-element
// vectors s_t, sbar_t, V_t and v_t (K x D each), everything but vbar is
// local to a node.  So:
//  1. bwd_prep_kernel, one block per element: v_t = squash(s_t) and the
//     running sums V_t from the s_t K3 saved (bit-equal to the forward's
//     V), and sbar_{n_iter-1} from g.  Per element they form the state,
//     3 n_iter - 2 vectors of K x D (77 KB for a group of 4 at K = 43).
//  2. for t = n_iter-1 ... 1, a pass launch, routing_bwd_sweep_kernel
//     <false>, one block per (node tile, group of kBG elements): it
//     recomputes the votes from x and W, rebuilds Lbar from the state
//     (the softmax VJPs of iterations n_iter-1 ... t; Lbar is rebuilt,
//     never stored: (B, K, N) f32 would be 14 MB), and writes one
//     partial vbar_{t-1} per (element, tile); then bwd_finish_kernel,
//     one block per element, sums the partials in a fixed order
//     (deterministic) and applies the squash VJP to get sbar_{t-1}.
//  3. the final launch, routing_bwd_sweep_kernel<true>, one block per
//     node tile for ALL elements: it loops over the groups, rebuilds dP
//     per node, reduces dx over the block (a butterfly over the
//     capsule's 8 lanes, then the K capsules in shared memory, fixed
//     order) and accumulates its tile's dW in shared memory over the
//     whole batch, written once at the end: the TPU kernel's resident
//     accumulator made into a loop.  No atomics: dx and dW are
//     deterministic.
// A thread owns one capsule k and two of its D outputs, as in K3, for
// the kBG = 4 elements of a group (K3 holds 16: the backward carries the
// votes, Lbar and dP per element).  The softmax over K and the sum
// sum_k probs pbar go through shared memory, 16 lanes per element.
// Arithmetic is f32 throughout, IEEE sqrt, expf and division (no fast
// math); the squash guard is 1e-12.  bf16: x and W are read as bf16 and
// every sum and all gradient state stay f32; dx and dW come out f32.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kC = 8;                // input capsule dim
constexpr int kD = 16;               // output capsule dim
constexpr int kPair = 2;             // outputs per thread
constexpr int kLanes = kD / kPair;   // lanes per capsule
constexpr int kBG = 4;               // batch elements per group
constexpr int kMaxK = 48;            // capsules: 384 threads at most
constexpr int kMaxThreads = kMaxK * kLanes;
constexpr int kMaxIter = 5;
constexpr int kPassTileMin = 8, kPassTileMax = 32;  // nodes per pass block
constexpr int kGradTileMax = 16;                    // nodes per final block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanes == kC, "dx's butterfly leaves one input dim per lane");
static_assert(kBG % 2 == 0, "softmax rows: both halves of a warp alike");
static_assert(kBG <= kLanes, "lane h < kBG writes element h's row");

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// index of a vector in an element's state: sbar_t (t < T), V_t
// (1 <= t < T), v_t (t < T - 1)
__host__ __device__ __forceinline__ int sbar_vec(int t) { return t; }
__host__ __device__ __forceinline__ int vsum_vec(int t, int T) {
  return T + t - 1;
}
__host__ __device__ __forceinline__ int v_vec(int t, int T) {
  return 2 * T - 1 + t;
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

// one step of a reduce-scatter over the lanes h ^ kOff (as in K3): after
// kOff = 4, 2, 1, lane h holds the full sum of entry h in l[0]
template <int kHalf, int kOff>
__device__ __forceinline__ void butterfly_step(float* l, int h) {
  const bool upper = h & kOff;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? l[j] : l[j + kHalf];
    const float keep = upper ? l[j + kHalf] : l[j];
    l[j] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
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
        // as routing.cu:routing_squash_kernel forms v and V
        const float v = s * (n2 / (1.f + n2) / sqrtf(n2 + 1e-12f));
        vsum = t == 0 ? v : vsum + v;
        if (valid) {
          st[v_vec(t, T) * KD + j] = v;
          st[vsum_vec(t + 1, T) * KD + j] = vsum;
        }
      } else {
        const float gb = valid ? g[int64_t(b) * KD + j] : 0.f;
        const float sv = capsule_sum(s * gb);
        if (valid) st[sbar_vec(t) * KD + j] = squash_vjp(s, gb, n2, sv);
      }
    }
  }
}

// sbar_{t-1} from the pass's partial vbar_{t-1}, one block per element
__global__ void bwd_finish_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ s_saved,
                                  float* __restrict__ state, int B, int K,
                                  int T, int tiles, int t) {
  const int b = blockIdx.x;
  const int KD = K * kD;
  for (int j0 = 0; j0 < KD; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < KD;
    float vbar = 0.f, s = 0.f;
    if (valid) {
      const float* src = partial + int64_t(b) * tiles * KD + j;
      for (int i = 0; i < tiles; ++i) vbar += src[int64_t(i) * KD];
      s = s_saved[(int64_t(t - 1) * B + b) * KD + j];
    }
    const float n2 = capsule_sum(s * s);
    const float sv = capsule_sum(s * vbar);
    if (valid)
      state[(int64_t(b) * (3 * T - 2) + sbar_vec(t - 1)) * KD + j] =
          squash_vjp(s, vbar, n2, sv);
  }
}

// kFinal false: a pass launch for t_stop >= 1, grid (node tiles, groups),
// writes partial vbar_{t_stop-1} per (element, tile).  kFinal true: the
// final launch, grid (node tiles), all groups per block, writes dx and
// the tile's dW.
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kMaxThreads)
    routing_bwd_sweep_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const float* __restrict__ state,
                             float* __restrict__ partial,
                             float* __restrict__ dx, float* __restrict__ dw,
                             int B, int N, int K, int n_iter, int t_stop,
                             int tile_nodes) {
  extern __shared__ __align__(16) float smem[];
  const int KD = K * kD;
  const int nvec = 3 * n_iter - 2;
  float* st = smem;                              // [nvec][kBG][KD]
  float* xs = st + nvec * kBG * KD;              // [tile][kBG][kC]
  float* lg = xs + tile_nodes * kBG * kC;        // [2][kBG][K] logits, probs
  float* pb = lg + 2 * kBG * K;                  // [2][kBG][K] pbar
  float* inner = pb + 2 * kBG * K;               // [2][kBG] sum_k probs pbar
  float* red = inner + 2 * kBG;                  // [kBG][K][kC]  (final)
  float* dws = red + kBG * K * kC;               // [tile][kC][K][kD] (final)

  const int tile = blockIdx.x, tiles = gridDim.x;
  const int n0 = tile * tile_nodes;
  const int nn = min(tile_nodes, N - n0);
  const int tid = threadIdx.x;
  const int k = tid / kLanes, h = tid % kLanes;
  const bool valid = k < K;
  const int my = k * kD + h * kPair;  // this thread's two outputs
  const int groups = (B + kBG - 1) / kBG;
  const int g0 = kFinal ? 0 : blockIdx.y, g1 = kFinal ? groups : g0 + 1;
  const float uniform = 1.f / K;  // softmax of zero logits
  int par = 0;                    // double buffer of the softmax rows

  if (kFinal)
    for (int i = tid; i < nn * kC * KD; i += blockDim.x) dws[i] = 0.f;

  for (int grp = g0; grp < g1; ++grp) {
    const int b0 = grp * kBG;
    __syncthreads();  // the previous group is done with st and xs
    // the group's state, 16-byte asynchronous copies (cp.async): a
    // thread has all its copies in flight at once, where a plain load
    // loop waits out the L2 latency once per iteration
    const int row4 = KD / 4;  // float4s per (vector, element) row
    for (int i = tid; i < nvec * kBG * row4; i += blockDim.x) {
      const int c4 = i % row4, row = i / row4;  // row = vec * kBG + b
      const int b = row % kBG, vec = row / kBG;
      float4* dst = reinterpret_cast<float4*>(st) + i;
      if (b0 + b < B)
        __pipeline_memcpy_async(
            dst,
            reinterpret_cast<const float4*>(
                state + (int64_t(b0 + b) * nvec + vec) * KD) + c4,
            sizeof(float4));
      else
        *dst = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __pipeline_commit();
    for (int i = tid; i < nn * kBG * kC; i += blockDim.x) {
      const int c = i % kC, b = (i / kC) % kBG, n = i / (kC * kBG);
      xs[i] = b0 + b < B
                  ? cyt::to_f(x[(int64_t(b0 + b) * N + n0 + n) * kC + c])
                  : 0.f;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    float acc[kBG][kPair];
#pragma unroll
    for (int b = 0; b < kBG; ++b) acc[b][0] = acc[b][1] = 0.f;

    for (int i = 0; i < nn; ++i) {
      // votes for node n0 + i: this thread's two outputs, kBG elements
      float2 wv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        wv[c] = valid ? load_pair(w + ((int64_t(n0 + i) * K + k) * kC + c) *
                                          kD + h * kPair)
                      : make_float2(0.f, 0.f);
      }
      float p[kBG][kPair];
      const float4* xn = reinterpret_cast<const float4*>(xs + i * kBG * kC);
#pragma unroll
      for (int b = 0; b < kBG; ++b) {
        const float4 xa = xn[2 * b], xb = xn[2 * b + 1];
        const float xv[kC] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float p0 = xv[0] * wv[0].x, p1 = xv[0] * wv[0].y;
#pragma unroll
        for (int c = 1; c < kC; ++c) {
          p0 = fmaf(xv[c], wv[c].x, p0);
          p1 = fmaf(xv[c], wv[c].y, p1);
        }
        p[b][0] = p0;
        p[b][1] = p1;
      }

      float lbar[kBG], dp[kBG][kPair];
#pragma unroll
      for (int b = 0; b < kBG; ++b) lbar[b] = dp[b][0] = dp[b][1] = 0.f;
      for (int t = n_iter - 1; t >= t_stop; --t) {
        const float* sb = st + sbar_vec(t) * kBG * KD + my;
        if (t == 0) {  // final launch only: probabilities 1/K, no Lbar
#pragma unroll
          for (int b = 0; b < kBG; ++b) {
            const float2 s2 = load_pair(sb + b * KD);
            dp[b][0] = fmaf(uniform, s2.x, dp[b][0]);
            dp[b][1] = fmaf(uniform, s2.y, dp[b][1]);
          }
          continue;
        }
        // logits sum_d P V_t and pbar = sum_d P sbar_t, summed over the
        // capsule's 8 lanes (every lane gets the sums)
        const float* vt = st + vsum_vec(t, n_iter) * kBG * KD + my;
        float l[kBG], q[kBG];
#pragma unroll
        for (int b = 0; b < kBG; ++b) {
          const float2 v2 = load_pair(vt + b * KD);
          const float2 s2 = load_pair(sb + b * KD);
          l[b] = fmaf(p[b][1], v2.y, p[b][0] * v2.x);
          q[b] = fmaf(p[b][1], s2.y, p[b][0] * s2.x);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
          for (int b = 0; b < kBG; ++b) {
            l[b] += __shfl_xor_sync(kFull, l[b], off);
            q[b] += __shfl_xor_sync(kFull, q[b], off);
          }
        }
        float* lgb = lg + par * kBG * K;
        float* pbb = pb + par * kBG * K;
        float* inb = inner + par * kBG;
        par ^= 1;
        if (valid) {
#pragma unroll
          for (int b = 0; b < kBG; ++b) {
            if (h == b) {
              lgb[b * K + k] = l[b];
              pbb[b * K + k] = q[b];
            }
          }
        }
        __syncthreads();
        // softmax over the K capsules (f32, max subtracted) and
        // sum_k probs pbar: 16 lanes per element
        for (int r = tid / 16; r < kBG; r += blockDim.x / 16) {
          float* row = lgb + r * K;
          const float* prow = pbb + r * K;
          const int qq = tid % 16;
          float m = __int_as_float(0xff800000);  // -inf
          for (int kk = qq; kk < K; kk += 16) m = fmaxf(m, row[kk]);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(kFull, m, off, 16));
          float sum = 0.f;
          for (int kk = qq; kk < K; kk += 16) {
            const float e = expf(row[kk] - m);
            row[kk] = e;
            sum += e;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(kFull, sum, off, 16);
          float dot = 0.f;
          for (int kk = qq; kk < K; kk += 16) {
            const float prob = row[kk] / sum;
            row[kk] = prob;
            dot = fmaf(prob, prow[kk], dot);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            dot += __shfl_xor_sync(kFull, dot, off, 16);
          if (qq == 0) inb[r] = dot;
        }
        __syncthreads();
        const float* vprev = st + v_vec(t - 1, n_iter) * kBG * KD + my;
#pragma unroll
        for (int b = 0; b < kBG; ++b) {
          const float prob = valid ? lgb[b * K + k] : 0.f;
          lbar[b] = fmaf(prob, q[b] - inb[b], lbar[b]);
          if (kFinal) {
            const float2 s2 = load_pair(sb + b * KD);
            const float2 v2 = load_pair(vprev + b * KD);
            dp[b][0] += fmaf(prob, s2.x, v2.x * lbar[b]);
            dp[b][1] += fmaf(prob, s2.y, v2.y * lbar[b]);
          }
        }
      }

      if constexpr (!kFinal) {
        // vbar_{t_stop-1}[k,d] = sum_n P Lbar: this tile's share
#pragma unroll
        for (int b = 0; b < kBG; ++b) {
          acc[b][0] = fmaf(p[b][0], lbar[b], acc[b][0]);
          acc[b][1] = fmaf(p[b][1], lbar[b], acc[b][1]);
        }
      } else {
        // dx[b, n, c] = sum_{k,d} W[n,k,c,d] dP[b,k,d]: over the
        // capsule's lanes by a butterfly (lane h keeps c = h), then over
        // the K capsules in shared memory in a fixed order
#pragma unroll
        for (int b = 0; b < kBG; ++b) {
          float pc[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c)
            pc[c] = fmaf(wv[c].y, dp[b][1], wv[c].x * dp[b][0]);
          butterfly_step<4, 4>(pc, h);
          butterfly_step<2, 2>(pc, h);
          butterfly_step<1, 1>(pc, h);
          if (valid) red[(b * K + k) * kC + h] = pc[0];
        }
        // dW[n,k,c,d] += sum_b x[b,n,c] dP[b,k,d], in this thread's
        // own slots
        if (valid) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float2* a = reinterpret_cast<float2*>(
                dws + ((i * kC + c) * K + k) * kD + h * kPair);
            float2 v = *a;
#pragma unroll
            for (int b = 0; b < kBG; ++b) {
              const float xv = xs[(i * kBG + b) * kC + c];
              v.x = fmaf(xv, dp[b][0], v.x);
              v.y = fmaf(xv, dp[b][1], v.y);
            }
            *a = v;
          }
        }
        __syncthreads();
        if (tid < kBG * kC) {
          const int b = tid / kC, c = tid % kC;
          float s = 0.f;
          for (int kk = 0; kk < K; ++kk) s += red[(b * K + kk) * kC + c];
          if (b0 + b < B) dx[(int64_t(b0 + b) * N + n0 + i) * kC + c] = s;
        }
        __syncthreads();  // red is rewritten by the next node
      }
    }

    if (!kFinal && valid) {
      for (int b = 0; b < kBG; ++b) {
        if (b0 + b >= B) break;
        float* dst = partial + ((int64_t(b0 + b) * tiles + tile) * K + k) *
                                   kD + h * kPair;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[b][0], acc[b][1]);
      }
    }
  }

  if (kFinal) {
    __syncthreads();
    // dW of the tile's nodes, (N, K, C, D) order, written once
    const int per_node = K * kC * kD;
    for (int idx = tid; idx < nn * per_node; idx += blockDim.x) {
      const int d = idx % kD, c = (idx / kD) % kC;
      const int kk = (idx / (kD * kC)) % K, i = idx / per_node;
      dw[int64_t(n0) * per_node + idx] = dws[((i * kC + c) * K + kk) * kD + d];
    }
  }
}

int pass_threads(int K) { return (K * kLanes + 31) / 32 * 32; }

size_t sweep_smem(int tile_nodes, int K, int n_iter, bool final_launch) {
  const size_t KD = size_t(K) * kD;
  size_t floats = (3 * n_iter - 2) * kBG * KD + size_t(tile_nodes) * kBG * kC +
                  4 * kBG * K + 2 * kBG;
  if (final_launch) floats += kBG * K * kC + size_t(tile_nodes) * kC * KD;
  return floats * sizeof(float);
}

// let both sweep kernels take up to the card's opt-in shared memory;
// returns it, or -1 on a CUDA error
template <typename T>
int allow_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncSetAttribute(routing_bwd_sweep_kernel<T, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess ||
      cudaFuncSetAttribute(routing_bwd_sweep_kernel<T, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess)
    return -1;
  return optin;
}

// The tile in [lo, hi] nodes that minimises waves x tile (K3's rule,
// routing.cu:pick_tile) for `kernel` with `groups` blocks per tile; on a
// tie the larger tile.  0 if none fits, -1 on a CUDA error.
template <typename Kernel>
int best_tile(Kernel kernel, int lo, int hi, int64_t groups, int N, int K,
              int n_iter, bool final_launch, int sms, int optin) {
  int best = 0;
  int64_t best_cost = -1;
  for (int t = hi; t >= lo; --t) {
    const size_t smem = sweep_smem(t, K, n_iter, final_launch);
    if (smem > size_t(optin)) continue;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, pass_threads(K), smem) != cudaSuccess)
      return -1;
    if (per_sm < 1) continue;
    const int64_t slots = int64_t(per_sm) * sms;
    const int64_t blocks = (N + t - 1) / t * groups;
    const int64_t cost = (blocks + slots - 1) / slots * t;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = t;
    }
  }
  return best;
}

template <typename T>
int pick_tiles(int B, int N, int K, int n_iter, int* pass_tile,
               int* grad_tile) {
  int dev = 0, sms = 0;
  const int optin = allow_smem<T>();
  if (optin < 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int64_t groups = (B + kBG - 1) / kBG;
  *pass_tile = best_tile(routing_bwd_sweep_kernel<T, false>, kPassTileMin,
                         kPassTileMax, groups, N, K, n_iter, false, sms,
                         optin);
  *grad_tile = best_tile(routing_bwd_sweep_kernel<T, true>, 1, kGradTileMax,
                         1, N, K, n_iter, true, sms, optin);
  if (*pass_tile < 0 || *grad_tile < 0)
    return static_cast<int>(cudaGetLastError());
  if (*pass_tile == 0 || *grad_tile == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int run(const void* x, const void* w, const float* s_saved, const float* g,
        float* state, float* partial, float* dx, float* dw, int B, int N,
        int K, int n_iter, int pass_tile, int grad_tile, cudaStream_t s) {
  const int optin = allow_smem<T>();
  if (optin < 0) return static_cast<int>(cudaGetLastError());
  const size_t pass_smem = sweep_smem(pass_tile, K, n_iter, false);
  const size_t grad_smem = sweep_smem(grad_tile, K, n_iter, true);
  if (pass_smem > size_t(optin) || grad_smem > size_t(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pass_threads(K);
  const int vec_threads = (K * kD + 31) / 32 * 32;
  const int pass_tiles = (N + pass_tile - 1) / pass_tile;
  const int groups = (B + kBG - 1) / kBG;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);

  bwd_prep_kernel<<<B, vec_threads, 0, s>>>(s_saved, g, state, B, K, n_iter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t = n_iter - 1; t >= 1; --t) {
    routing_bwd_sweep_kernel<T, false>
        <<<dim3(pass_tiles, groups), threads, pass_smem, s>>>(
            xt, wt, state, partial, nullptr, nullptr, B, N, K, n_iter, t,
            pass_tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_finish_kernel<<<B, vec_threads, 0, s>>>(partial, s_saved, state, B,
                                                K, n_iter, pass_tiles, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  routing_bwd_sweep_kernel<T, true>
      <<<(N + grad_tile - 1) / grad_tile, threads, grad_smem, s>>>(
          xt, wt, state, nullptr, dx, dw, B, N, K, n_iter, 0, grad_tile);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

bool shape_ok(int64_t B, int64_t N, int64_t K, int n_iter) {
  return B > 0 && N > 0 && K > 0 && K <= kMaxK && n_iter >= 1 &&
         n_iter <= kMaxIter && B * N * kC < (int64_t(1) << 31) &&
         N * K * kC * kD < (int64_t(1) << 31) &&
         (B + kBG - 1) / kBG < 65535;
}

}  // namespace

// K4's node tiles for (B, N, K, n_iter) in dtype on the current device:
// *pass_tile for the pass launches, *grad_tile for the final launch
// (see best_tile).  Returns 0, or a CUDA error code.
extern "C" int cyt_routing_bwd_tiles(int64_t B, int64_t N, int64_t K,
                                     int n_iter, int dtype, int* pass_tile,
                                     int* grad_tile) {
  if (!shape_ok(B, N, K, n_iter))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == cyt::kFloat32)
    return pick_tiles<float>(int(B), int(N), int(K), n_iter, pass_tile,
                             grad_tile);
  if (dtype == cyt::kBFloat16)
    return pick_tiles<__nv_bfloat16>(int(B), int(N), int(K), n_iter,
                                     pass_tile, grad_tile);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (B, N, C) and w: (N, K, C, D) contiguous in dtype (C = 8, D = 16,
// K <= 48, n_iter <= 5), as K3 read them; s_saved: (n_iter, B, K, D) f32
// from K3; g: (B, K, D) f32; state: (B, 3 n_iter - 2, K, D) f32 scratch;
// partial: (B, ceil(N / pass_tile), K, D) f32 scratch; dx: (B, N, C)
// f32; dw: (N, K, C, D) f32.  Launches 2 n_iter kernels on `stream`.
// Returns the first cudaGetLastError() that is not 0, or 0.
extern "C" int cyt_routing_bwd(const void* x, const void* w,
                               const void* s_saved, const void* g,
                               void* state, void* partial, void* dx,
                               void* dw, int64_t B, int64_t N, int64_t K,
                               int64_t C, int64_t D, int n_iter,
                               int pass_tile, int grad_tile, int dtype,
                               void* stream) {
  if (!shape_ok(B, N, K, n_iter) || C != kC || D != kD || pass_tile < 1 ||
      pass_tile > kPassTileMax || grad_tile < 1 || grad_tile > kGradTileMax ||
      (reinterpret_cast<uintptr_t>(w) & 7u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = int(B), n = int(N), k = int(K);
  const float* ss = static_cast<const float*>(s_saved);
  const float* gg = static_cast<const float*>(g);
  float* st = static_cast<float*>(state);
  float* p = static_cast<float*>(partial);
  float* ox = static_cast<float*>(dx);
  float* ow = static_cast<float*>(dw);
  if (dtype == cyt::kFloat32)
    return run<float>(x, w, ss, gg, st, p, ox, ow, b, n, k, n_iter,
                      pass_tile, grad_tile, s);
  if (dtype == cyt::kBFloat16)
    return run<__nv_bfloat16>(x, w, ss, gg, st, p, ox, ow, b, n, k, n_iter,
                              pass_tile, grad_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
