// K3: capsule votes fused with routing by agreement, for sm_90a.
//
// Replaces the TPU kernel ops/routing_pallas.py:_route
// (_routing_fwd_kernel, entry routed_capsules_pallas): caps (B, K, D)
// from x (B, N, C) and W (N, K, C, D), with
//   priors[b,n,k,d] = sum_c x[b,n,c] W[n,k,c,d]
//   for t < n_iter: probs = softmax_k(logits), s = sum_n probs * priors,
//                   v_t = squash(s), logits += sum_d priors * v_t
// and caps = v_{n_iter-1}.  The priors, (B, N, K, D) f32 = 228 MB at
// CapsuleNet's shape, never reach global memory.
//
// Bound on the H100: operations.  Each routing pass recomputes the votes
// (8 FMAs per vote component) from x and W; W (28.5 MB f32) is read from
// L2 by each batch group.  The work needed once is the votes (0.91
// GFLOP at B=64) and five node-sized passes (0.57 GFLOP), 1.48 GFLOP,
// against 31.4 MB moved.
//
// Design.  The TPU kernel keeps all of W and one element's priors in
// VMEM; an SM has 228 KB, so here the nodes are tiled and each routing
// iteration is two launches:
//  1. routing_pass_kernel, one block per (node tile, group of BG batch
//     elements); the tile size is picked per shape and card so the
//     blocks fill whole waves (pick_tile).  A thread owns one capsule k
//     and two of its D outputs for all BG elements: it loads its W pairs
//     for a node once and reuses them for the BG elements from
//     registers.  Per node it forms the votes, the logit sum_d priors *
//     V (V = v_0 + ... + v_{t-1}, the running sum of earlier outputs: in
//     exact arithmetic the logits are the agreements summed over
//     earlier iterations, so no logits are stored), reduces it over the
//     8 lanes of the capsule (a butterfly: 14 shuffles for the 16
//     elements), and takes the softmax over the K capsules per element
//     through shared memory, 16 lanes per element, all elements at once
//     (f32, max subtracted, all K capsules exactly).  It accumulates
//     s[k,d] over the tile's nodes in registers and writes one partial
//     per (element, tile).
//  2. routing_squash_kernel, one block per element, sums the partials
//     over the tiles in a fixed order (the result is deterministic) and
//     squashes: v = s * (|s|^2 / (1 + |s|^2) / sqrt(|s|^2 + 1e-12)),
//     as the TPU kernel computes it, with IEEE sqrt and division (no
//     fast math).  It adds v to V, or writes the caps on the last pass.
//     For training it also writes s_t, the state the backward (K4,
//     csrc/routing_bwd.cu) rebuilds the iterations from.
// The first pass skips the logits: they are zero, so every probability
// is 1/K.  bf16: x and W are read as bf16 and every sum runs in f32.

#include "common.cuh"

namespace {

constexpr int kC = 8;                // input capsule dim
constexpr int kD = 16;               // output capsule dim
constexpr int kPair = 2;             // outputs per thread
constexpr int kLanes = kD / kPair;   // lanes per capsule
constexpr int kBG = 16;              // batch elements per block
constexpr int kMaxK = 48;            // capsules: 384 threads at most
constexpr int kMaxThreads = kMaxK * kLanes;
constexpr int kTileMin = 8, kTileMax = 32;  // nodes per pass block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBG == 2 * kLanes, "the logit butterfly leaves 2 per lane");

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One step of a reduce-scatter over the lanes h ^ kOff: each lane keeps
// half of its kHalf * 2 partial sums, sends the other half to its
// partner and adds what the partner sent; after the steps kOff = 4, 2, 1
// lane h holds the full sums of elements 2h and 2h + 1 in l[0], l[1].
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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    routing_pass_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ vsum,
                        float* __restrict__ partial, int B, int N, int K,
                        int tile_nodes) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [tile_nodes][kBG][kC]
  float* lg = xs + tile_nodes * kBG * kC;   // [2][kBG][K] logits, probs
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int b0 = blockIdx.y * kBG;
  const int n0 = tile * tile_nodes;
  const int nn = min(tile_nodes, N - n0);
  const int tid = threadIdx.x;
  const int k = tid / kLanes, h = tid % kLanes;
  const bool valid = k < K;
  const int KD = K * kD;
  const bool first = vsum == nullptr;

  // the tile's x for the group's elements, as f32, zero past B
  for (int i = tid; i < nn * kBG * kC; i += blockDim.x) {
    const int c = i % kC, b = (i / kC) % kBG, n = i / (kC * kBG);
    xs[i] = b0 + b < B
                ? cyt::to_f(x[(int64_t(b0 + b) * N + n0 + n) * kC + c])
                : 0.f;
  }
  float V[kBG][kPair];
#pragma unroll
  for (int b = 0; b < kBG; ++b) {
    float2 v = make_float2(0.f, 0.f);
    if (!first && valid && b0 + b < B)
      v = load_pair(vsum + int64_t(b0 + b) * KD + k * kD + h * kPair);
    V[b][0] = v.x;
    V[b][1] = v.y;
  }
  float acc[kBG][kPair];
#pragma unroll
  for (int b = 0; b < kBG; ++b) acc[b][0] = acc[b][1] = 0.f;
  const float uniform = 1.f / K;  // softmax of zero logits
  __syncthreads();

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

    if (first) {
#pragma unroll
      for (int b = 0; b < kBG; ++b) {
        acc[b][0] = fmaf(uniform, p[b][0], acc[b][0]);
        acc[b][1] = fmaf(uniform, p[b][1], acc[b][1]);
      }
      continue;
    }
    // logits: agreement with the running sum of earlier outputs, summed
    // over the capsule's lanes by a butterfly that leaves lane h with
    // the logits of elements 2h and 2h + 1
    float* lgb = lg + (i & 1) * kBG * K;  // double buffer: no WAR race
    float l[kBG];
#pragma unroll
    for (int b = 0; b < kBG; ++b)
      l[b] = fmaf(p[b][1], V[b][1], p[b][0] * V[b][0]);
    butterfly_step<8, 4>(l, h);
    butterfly_step<4, 2>(l, h);
    butterfly_step<2, 1>(l, h);
    if (valid) {
      lgb[(2 * h) * K + k] = l[0];
      lgb[(2 * h + 1) * K + k] = l[1];
    }
    __syncthreads();
    // softmax over the K capsules: 16 lanes per element, all elements at
    // once (blockDim.x / 16 is even, so both halves of a warp take the
    // same number of rows and every shuffle has all 32 lanes)
    for (int r = tid / 16; r < kBG; r += blockDim.x / 16) {
      float* row = lgb + r * K;
      const int q = tid % 16;
      float m = __int_as_float(0xff800000);  // -inf
      for (int kk = q; kk < K; kk += 16) m = fmaxf(m, row[kk]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off, 16));
      float sum = 0.f;
      for (int kk = q; kk < K; kk += 16) {
        const float e = expf(row[kk] - m);
        row[kk] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off, 16);
      for (int kk = q; kk < K; kk += 16) row[kk] = row[kk] / sum;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kBG; ++b) {
      const float prob = valid ? lgb[b * K + k] : 0.f;
      acc[b][0] = fmaf(prob, p[b][0], acc[b][0]);
      acc[b][1] = fmaf(prob, p[b][1], acc[b][1]);
    }
  }

  if (!valid) return;
#pragma unroll
  for (int b = 0; b < kBG; ++b) {
    if (b0 + b >= B) break;
    float* dst = partial + ((int64_t(b0 + b) * tiles + tile) * K + k) * kD +
                 h * kPair;
    *reinterpret_cast<float2*>(dst) = make_float2(acc[b][0], acc[b][1]);
  }
}

// mode: 0 first pass (V = v), 1 middle pass (V += v), 2 last (caps = v)
// s_out: this iteration's (B, K, D) slice of s_saved, or null (serving)
__global__ void routing_squash_kernel(const float* __restrict__ partial,
                                      float* __restrict__ vsum,
                                      float* __restrict__ out,
                                      float* __restrict__ s_out, int K,
                                      int tiles, int mode) {
  const int b = blockIdx.x;
  const int KD = K * kD;
  // blockDim.x is a multiple of 32 and kD divides 32: a capsule's kD
  // outputs sit in one warp for the shuffle below
  for (int j0 = 0; j0 < KD; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < KD;
    float s = 0.f;
    if (valid) {
      const float* src = partial + int64_t(b) * tiles * KD + j;
      for (int t = 0; t < tiles; ++t) s += src[int64_t(t) * KD];
    }
    float sq = s * s;
#pragma unroll
    for (int off = 1; off < kD; off <<= 1)
      sq += __shfl_xor_sync(kFull, sq, off);
    const float v = s * (sq / (1.f + sq) / sqrtf(sq + 1e-12f));
    if (!valid) continue;
    const int64_t o = int64_t(b) * KD + j;
    if (s_out != nullptr) s_out[o] = s;
    if (mode == 2)
      out[o] = v;
    else if (mode == 0)
      vsum[o] = v;
    else
      vsum[o] += v;
  }
}

int pass_threads(int K) { return (K * kLanes + 31) / 32 * 32; }

size_t pass_smem(int tile_nodes, int K) {
  return sizeof(float) * (size_t(tile_nodes) * kBG * kC + 2 * kBG * K);
}

// Node-tile size for (B, N, K) on the current device.  The pass blocks
// run in waves of (resident blocks per SM) x (SMs), and a wave lasts as
// long as a block's tile, so take the tile in [kTileMin, kTileMax]
// nodes that minimises waves x tile; on a tie the larger tile (fewer
// partials to sum).  Returns the tile, or -1 on a CUDA error.
template <typename T>
int pick_tile(int B, int N, int K) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const int64_t groups = (B + kBG - 1) / kBG;
  int best = kTileMax;
  int64_t best_cost = -1;
  for (int t = kTileMax; t >= kTileMin; --t) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, routing_pass_kernel<T>, pass_threads(K),
            pass_smem(t, K)) != cudaSuccess)
      return -1;
    const int64_t slots = int64_t(per_sm > 1 ? per_sm : 1) * sms;
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
int run(const void* x, const void* w, float* partial, float* vsum,
        float* out, float* s_saved, int B, int N, int K, int n_iter,
        int tile_nodes, cudaStream_t s) {
  const int tiles = (N + tile_nodes - 1) / tile_nodes;
  const dim3 grid(tiles, (B + kBG - 1) / kBG);
  const int threads = pass_threads(K);
  const size_t smem = pass_smem(tile_nodes, K);
  const int sq_threads = min((K * kD + 31) / 32 * 32, 1024);
  for (int t = 0; t < n_iter; ++t) {
    routing_pass_kernel<T><<<grid, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        t == 0 ? nullptr : vsum, partial, B, N, K, tile_nodes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    routing_squash_kernel<<<B, sq_threads, 0, s>>>(
        partial, vsum, out,
        s_saved == nullptr ? nullptr : s_saved + int64_t(t) * B * K * kD, K,
        tiles, t == n_iter - 1 ? 2 : (t == 0 ? 0 : 1));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// The node-tile size cyt_routing should get for (B, N, K) in dtype on
// the current device (see pick_tile), or -1.
extern "C" int cyt_routing_tile(int64_t B, int64_t N, int64_t K,
                                int dtype) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxK) return -1;
  if (dtype == cyt::kFloat32) return pick_tile<float>(int(B), int(N), int(K));
  if (dtype == cyt::kBFloat16)
    return pick_tile<__nv_bfloat16>(int(B), int(N), int(K));
  return -1;
}

// x: (B, N, C) and w: (N, K, C, D) contiguous in dtype (C = 8, D = 16,
// K <= 48); partial: (B, ceil(N / tile_nodes), K, D) f32 scratch; vsum:
// (B, K, D) f32 scratch; out: (B, K, D) f32; s_saved: null, or
// (n_iter, B, K, D) f32 that receives each iteration's node sums s_t.
// Launches 2 * n_iter kernels on `stream`.  Returns the first
// cudaGetLastError() that is not 0, or 0.
extern "C" int cyt_routing(const void* x, const void* w, void* partial,
                           void* vsum, void* out, void* s_saved, int64_t B,
                           int64_t N, int64_t K, int64_t C, int64_t D,
                           int n_iter, int tile_nodes, int dtype,
                           void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxK || C != kC || D != kD ||
      n_iter < 1 || tile_nodes < 1 || tile_nodes > kTileMax ||
      B * N * C >= (int64_t(1) << 31) || N * K * C * D >= (int64_t(1) << 31) ||
      B >= 65535 * kBG || !cyt::aligned16(partial) || !cyt::aligned16(vsum) ||
      (reinterpret_cast<uintptr_t>(w) & 7u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = int(B), n = int(N), k = int(K);
  float* p = static_cast<float*>(partial);
  float* v = static_cast<float*>(vsum);
  float* o = static_cast<float*>(out);
  float* ss = static_cast<float*>(s_saved);
  if (dtype == cyt::kFloat32)
    return run<float>(x, w, p, v, o, ss, b, n, k, n_iter, tile_nodes, s);
  if (dtype == cyt::kBFloat16)
    return run<__nv_bfloat16>(x, w, p, v, o, ss, b, n, k, n_iter, tile_nodes,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}
