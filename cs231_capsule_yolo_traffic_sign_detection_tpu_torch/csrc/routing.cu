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
// (8 FMAs per vote component) from x and W.  The work needed once is the
// votes (0.91 GFLOP at B=64) and five node-sized passes (0.57 GFLOP),
// 1.48 GFLOP, against 31.4 MB moved (chip_smoke.py:routing_bound).
//
// Design.  The TPU kernel keeps all of W and one element's priors in
// VMEM; an SM has 228 KB, so the nodes are tiled.  A call is ONE
// cooperative launch of persistent blocks, all resident (one per SM at
// CapsuleNet's shape): per iteration, the blocks work through the (node
// tile, group of kBG = 16 elements) items of the pass, a grid barrier,
// each element's squash, a grid barrier.  (The design it replaces
// issued 2 n_iter launches: a pass kernel and a squash kernel per
// iteration.)
//  - An item's W reaches shared memory by TMA bulk copies, kNB = 2 nodes
//    per copy (44 KB f32), double-buffered on two mbarriers, so the next
//    nodes' W lands while these compute; before, every thread loaded its
//    W from L2 and waited for it, node by node.  W is read from L2 once
//    per element group, 4 x 28.5 MB f32 per pass at B=64: the first pass
//    (votes only) runs at that L2 traffic's pace.
//  - f32 (pass_item<float>): a thread owns one capsule k and two of its
//    D outputs for the group's 16 elements and forms the votes by FMAs.
//    bf16 (pass_item<__nv_bfloat16>): the votes run on the tensor cores,
//    two mma.m16n8k8 per node and capsule with the 16 elements as M;
//    products of bf16 values are exact in f32 and the sums are f32, so
//    the bf16 band holds unchanged.
//  - Per pair of nodes, the logit sum_d priors * V (V = v_0 + ... +
//    v_{t-1}, the running sum of earlier outputs: in exact arithmetic
//    the logits are the agreements summed over earlier iterations, so no
//    logits are stored) is reduced over the capsule's lanes by shuffles,
//    and the softmax over the K capsules of both nodes' 32 rows goes
//    through shared memory between one barrier pair (was one pair per
//    node), 8 lanes per row with the row in registers (f32, max
//    subtracted, IEEE expf and division).  s[k,d] accumulates over the
//    tile's nodes in registers; one partial per (element, tile).
//  - The squash sums the partials over the tiles in a fixed order (the
//    result is deterministic) and squashes: v = s * (|s|^2 / (1 + |s|^2)
//    / sqrt(|s|^2 + 1e-12)), as the TPU kernel does, with IEEE sqrt and
//    division.  It adds v to V, or writes the caps on the last pass.  For
//    training it also writes s_t, from which the backward (K4,
//    csrc/routing_bwd.cu) rebuilds V_t bit for bit.
// The first pass skips the logits: they are zero, so every probability
// is 1/K.  ptxas (sm_90a): 168 registers in both types, f32 with 4 bytes
// of spill; one block of 11 warps per SM at K = 43.

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8;                // input capsule dim
constexpr int kD = 16;               // output capsule dim
constexpr int kPair = 2;             // outputs per thread
constexpr int kLanes = kD / kPair;   // lanes per capsule
constexpr int kBG = 16;              // batch elements per block
constexpr int kMaxK = 48;            // capsules: 384 threads at most
constexpr int kMaxThreads = kMaxK * kLanes;
constexpr int kTileMin = 8, kTileMax = 32;  // nodes per pass block
constexpr int kNB = 2;               // nodes per barrier pair and W copy
constexpr unsigned kFull = 0xffffffffu;
static_assert(kNB * kBG % 4 == 0, "softmax rows: 4 per warp alike");

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// shared memory of a pass block, in floats after the two mbarriers; W's
// buffers hold kNB nodes each in the storage type
struct PassLayout {
  int w, xs, vs, lg, floats;
  template <typename T>
  __host__ __device__ static PassLayout make(int tile_nodes, int K) {
    PassLayout L;
    const int wfloats = (2 * kNB * K * kC * kD * int(sizeof(T)) + 3) / 4;
    L.w = 0;                                  // [2][kNB][K][kC][kD] T
    L.xs = L.w + wfloats;                     // [tile][kBG][kC]
    L.vs = L.xs + tile_nodes * kBG * kC;      // [kBG][K][kD] V
    L.lg = L.vs + kBG * K * kD;               // [2][kNB][kBG][K] logits
    L.floats = L.lg + 2 * kNB * kBG * K;
    return L;
  }
  size_t bytes() const { return 16 + size_t(floats) * sizeof(float); }
};

// One work item of a routing pass, f32: node tile `tile` for the
// elements of group `grp` (kBG of them), into partial (B, tiles, K, D).
// vsum null: the first pass.  `fills` counts the block's W copies so far
// (copy f uses buffer f & 1, phase f / 2 of its barrier).
template <typename T>
__device__ __forceinline__ void pass_item(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ vsum, float* __restrict__ partial, int B,
    int N, int K, int tile_nodes, int tiles, int tile, int grp,
    unsigned char* smem_raw, int& fills) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + 16);
  const PassLayout L = PassLayout::make<T>(tile_nodes, K);
  const T* wbuf = reinterpret_cast<const T*>(smem + L.w);
  float* xs = smem + L.xs;
  const float* vs = smem + L.vs;
  const int b0 = grp * kBG;
  const int n0 = tile * tile_nodes;
  const int nn = min(tile_nodes, N - n0);
  const int tid = threadIdx.x;
  const int k = tid / kLanes, h = tid % kLanes;
  const bool valid = k < K;
  const int KD = K * kD;
  const int node_w = K * kC * kD;  // W values per node
  const bool first = vsum == nullptr;
  const int pairs = (nn + kNB - 1) / kNB;

  // thread 0: W of node group q (kNB nodes, contiguous in w) into buffer
  // q & 1 by one bulk copy (TMA), completion on that buffer's barrier
  auto issue = [&](int q) {
    const int nq = min(kNB, nn - q * kNB), f = (fills + q) & 1;
    const uint32_t bytes = uint32_t(nq) * node_w * sizeof(T);
    cyt::mbar_arrive_expect(&bars[f], bytes);
    cyt::bulk_copy(const_cast<T*>(wbuf) + f * kNB * node_w,
                   w + int64_t(n0 + q * kNB) * node_w, bytes, &bars[f]);
  };
  // the tile's x for the group's elements as f32, zero past B, and V
  for (int i = tid; i < nn * kBG * kC; i += blockDim.x) {
    const int c = i % kC, b = (i / kC) % kBG, n = i / (kC * kBG);
    xs[i] = b0 + b < B
                ? cyt::to_f(x[(int64_t(b0 + b) * N + n0 + n) * kC + c])
                : 0.f;
  }
  if (!first)
    for (int i = tid; i < kBG * KD; i += blockDim.x)
      smem[L.vs + i] =
          b0 + i / KD < B ? __ldcg(vsum + int64_t(b0) * KD + i) : 0.f;
  float acc[kBG][kPair];
#pragma unroll
  for (int b = 0; b < kBG; ++b) acc[b][0] = acc[b][1] = 0.f;
  const float uniform = 1.f / K;  // softmax of zero logits
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (pairs > 1) issue(1);
  }

  for (int q = 0; q < pairs; ++q) {
    const int f = fills + q;
    cyt::mbar_wait(&bars[f & 1], (f >> 1) & 1);
    const T* wq = wbuf + (f & 1) * kNB * node_w;
    // votes for the group's kNB nodes: this thread's two outputs
    float p[kNB][kBG][kPair];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int n = q * kNB + i;  // node in the tile; past nn: zero votes
      float2 wv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wv[c] = valid && n < nn
                    ? load_pair(wq + (i * K + k) * kC * kD + c * kD + h * kPair)
                    : make_float2(0.f, 0.f);
      const float4* xn =
          reinterpret_cast<const float4*>(xs + min(n, nn - 1) * kBG * kC);
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
        p[i][b][0] = p0;
        p[i][b][1] = p1;
      }
    }

    if (first) {
      __syncthreads();  // every thread has read buffer q & 1
      if (tid == 0 && q + 2 < pairs) issue(q + 2);
#pragma unroll
      for (int i = 0; i < kNB; ++i)
#pragma unroll
        for (int b = 0; b < kBG; ++b) {
          acc[b][0] = fmaf(uniform, p[i][b][0], acc[b][0]);
          acc[b][1] = fmaf(uniform, p[i][b][1], acc[b][1]);
        }
      continue;
    }
    // logits: agreement with the running sum of earlier outputs, summed
    // over the capsule's lanes by a reduce-scatter that leaves lane h
    // with rows 4h ... 4h + 3 (row = node kBG + element)
    float* lgb = smem + L.lg + (q & 1) * kNB * kBG * K;  // no WAR race
    float l[kNB * kBG];
#pragma unroll
    for (int b = 0; b < kBG; ++b) {
      const float2 v = *reinterpret_cast<const float2*>(
          vs + b * KD + (valid ? k * kD + h * kPair : 0));
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        l[i * kBG + b] = fmaf(p[i][b][1], v.y, p[i][b][0] * v.x);
    }
    cyt::reduce_scatter8<kNB * kBG>(l, h);
    if (valid) {
#pragma unroll
      for (int j = 0; j < kNB * kBG / 8; ++j)
        lgb[(h * (kNB * kBG / 8) + j) * K + k] = l[j];
    }
    __syncthreads();  // rows written; every thread has read buffer q & 1
    if (tid == 0 && q + 2 < pairs) issue(q + 2);
    cyt::softmax_rows(lgb, kNB * kBG, K);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int b = 0; b < kBG; ++b) {
        const float prob = valid ? lgb[(i * kBG + b) * K + k] : 0.f;
        acc[b][0] = fmaf(prob, p[i][b][0], acc[b][0]);
        acc[b][1] = fmaf(prob, p[i][b][1], acc[b][1]);
      }
  }

  fills += pairs;
  if (!valid) return;
#pragma unroll
  for (int b = 0; b < kBG; ++b) {
    if (b0 + b >= B) break;
    float* dst = partial + ((int64_t(b0 + b) * tiles + tile) * K + k) * kD +
                 h * kPair;
    *reinterpret_cast<float2*>(dst) = make_float2(acc[b][0], acc[b][1]);
  }
}

// bf16: the same pass with the votes on the tensor cores.  Warp w owns
// capsules 4w ... 4w + 3 for the group's 16 elements; per node and
// capsule, two mma.m16n8k8 (M = the 16 elements, N = 8 of the D outputs,
// K = the 8 input dims) give the votes, lane l holding elements
// e = l / 4 and e + 8, outputs 8 hd + 2 (l % 4) and +1 (hd = 0, 1): the
// layout of every per-lane array below ([capsule][hd][4]).  W's rows
// reach the B operand by ldmatrix.trans from the TMA-staged buffer, x's
// by 32-bit loads of the bf16 tile.  Logits, softmax and the sums stay
// f32, as in the f32 pass.
template <>
__device__ __forceinline__ void pass_item<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ vsum, float* __restrict__ partial, int B,
    int N, int K, int tile_nodes, int tiles, int tile, int grp,
    unsigned char* smem_raw, int& fills) {
  using T = __nv_bfloat16;
  constexpr int kCaps = 4;  // capsules per warp
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + 16);
  const PassLayout L = PassLayout::make<T>(tile_nodes, K);
  const T* wbuf = reinterpret_cast<const T*>(smem + L.w);
  T* xs = reinterpret_cast<T*>(smem + L.xs);  // [tile][kBG][kC] bf16
  const float* vs = smem + L.vs;
  const int b0 = grp * kBG;
  const int n0 = tile * tile_nodes;
  const int nn = min(tile_nodes, N - n0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int KD = K * kD;
  const int node_w = K * kC * kD;
  const bool first = vsum == nullptr;
  const int pairs = (nn + kNB - 1) / kNB;

  auto issue = [&](int q) {
    const int nq = min(kNB, nn - q * kNB), f = (fills + q) & 1;
    const uint32_t bytes = uint32_t(nq) * node_w * sizeof(T);
    cyt::mbar_arrive_expect(&bars[f], bytes);
    cyt::bulk_copy(const_cast<T*>(wbuf) + f * kNB * node_w,
                   w + int64_t(n0 + q * kNB) * node_w, bytes, &bars[f]);
  };
  for (int i = tid; i < nn * kBG * kC; i += blockDim.x) {
    const int c = i % kC, b = (i / kC) % kBG, n = i / (kC * kBG);
    xs[i] = b0 + b < B ? x[(int64_t(b0 + b) * N + n0 + n) * kC + c]
                       : __float2bfloat16(0.f);
  }
  if (!first)
    for (int i = tid; i < kBG * KD; i += blockDim.x)
      smem[L.vs + i] =
          b0 + i / KD < B ? __ldcg(vsum + int64_t(b0) * KD + i) : 0.f;
  // this lane's capsules (clamped for the addresses; masked by `valid`)
  int kc[kCaps];
  bool valid[kCaps];
#pragma unroll
  for (int j = 0; j < kCaps; ++j) {
    valid[j] = warp * kCaps + j < K;
    kc[j] = min(warp * kCaps + j, K - 1);
  }
  float acc[kCaps][2][4];
#pragma unroll
  for (int j = 0; j < kCaps; ++j)
#pragma unroll
    for (int hd = 0; hd < 2; ++hd)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][hd][r] = 0.f;
  const float uniform = 1.f / K;
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (pairs > 1) issue(1);
  }

  for (int q = 0; q < pairs; ++q) {
    const int f = fills + q;
    cyt::mbar_wait(&bars[f & 1], (f >> 1) & 1);
    const T* wq = wbuf + (f & 1) * kNB * node_w;
    float p[kNB][kCaps][2][4];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int n = min(q * kNB + i, nn - 1);  // past nn: masked below
      const T* xn = xs + n * kBG * kC;
      const uint32_t a0 =
          *reinterpret_cast<const uint32_t*>(xn + g * kC + 2 * t);
      const uint32_t a1 =
          *reinterpret_cast<const uint32_t*>(xn + (g + 8) * kC + 2 * t);
#pragma unroll
      for (int half = 0; half < kCaps / 2; ++half) {
        // matrix m = lane / 8: capsule 2 half + m / 2, outputs 8 (m % 2)
        const int m = lane / 8;
        const T* row = wq + ((i * K + kc[2 * half + m / 2]) * kC + lane % 8) *
                                kD + 8 * (m % 2);
        uint32_t bw[4];
        cyt::ldmatrix_x4_trans(bw, row);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
          cyt::mma_bf16_m16n8k8(p[i][2 * half + mm / 2][mm % 2], a0, a1,
                                bw[mm]);
      }
      if (q * kNB + i >= nn) {
#pragma unroll
        for (int j = 0; j < kCaps; ++j)
#pragma unroll
          for (int hd = 0; hd < 2; ++hd)
#pragma unroll
            for (int r = 0; r < 4; ++r) p[i][j][hd][r] = 0.f;
      }
    }

    if (first) {
      __syncthreads();  // every thread has read buffer q & 1
      if (tid == 0 && q + 2 < pairs) issue(q + 2);
#pragma unroll
      for (int i = 0; i < kNB; ++i)
#pragma unroll
        for (int j = 0; j < kCaps; ++j)
#pragma unroll
          for (int hd = 0; hd < 2; ++hd)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[j][hd][r] = fmaf(uniform, p[i][j][hd][r], acc[j][hd][r]);
      continue;
    }
    // logits of (node, element, capsule): this lane's 4 of the 16
    // outputs, then over the 4 lanes t of the row by a reduce-scatter
    // that leaves lane t with capsule t's logits of elements g and g + 8
    float* lgb = smem + L.lg + (q & 1) * kNB * kBG * K;
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      float lv[kCaps * 2];
#pragma unroll
      for (int j = 0; j < kCaps; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float l = 0.f;
#pragma unroll
          for (int hd = 0; hd < 2; ++hd) {
            const float2 v = *reinterpret_cast<const float2*>(
                vs + (g + 8 * e) * KD + kc[j] * kD + 8 * hd + 2 * t);
            l = fmaf(p[i][j][hd][2 * e], v.x, l);
            l = fmaf(p[i][j][hd][2 * e + 1], v.y, l);
          }
          lv[j * 2 + e] = l;
        }
      {
        const bool upper = t & 2;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float send = upper ? lv[u] : lv[u + 4];
          const float keep = upper ? lv[u + 4] : lv[u];
          lv[u] = keep + __shfl_xor_sync(kFull, send, 2);
        }
      }
      {
        const bool upper = t & 1;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float send = upper ? lv[u] : lv[u + 2];
          const float keep = upper ? lv[u + 2] : lv[u];
          lv[u] = keep + __shfl_xor_sync(kFull, send, 1);
        }
      }
      // lane t now holds capsule t's logits of elements g, g + 8
      if (warp * kCaps + t < K) {
        lgb[(i * kBG + g) * K + warp * kCaps + t] = lv[0];
        lgb[(i * kBG + g + 8) * K + warp * kCaps + t] = lv[1];
      }
    }
    __syncthreads();  // rows written; every thread has read buffer q & 1
    if (tid == 0 && q + 2 < pairs) issue(q + 2);
    cyt::softmax_rows(lgb, kNB * kBG, K);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int j = 0; j < kCaps; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float prob =
              valid[j] ? lgb[(i * kBG + g + 8 * e) * K + kc[j]] : 0.f;
#pragma unroll
          for (int hd = 0; hd < 2; ++hd)
#pragma unroll
            for (int r = 2 * e; r < 2 * e + 2; ++r)
              acc[j][hd][r] = fmaf(prob, p[i][j][hd][r], acc[j][hd][r]);
        }
  }

  fills += pairs;
#pragma unroll
  for (int j = 0; j < kCaps; ++j) {
    if (!valid[j]) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = g + 8 * e;
      if (b0 + b >= B) continue;
#pragma unroll
      for (int hd = 0; hd < 2; ++hd)
        *reinterpret_cast<float2*>(
            partial + ((int64_t(b0 + b) * tiles + tile) * K + kc[j]) * kD +
            8 * hd + 2 * t) = make_float2(acc[j][hd][2 * e],
                                          acc[j][hd][2 * e + 1]);
    }
  }
}

// The node sums of element b: the tiles' partials summed in a fixed
// order (the result is deterministic), squashed as the TPU kernel does,
// v = s * (|s|^2 / (1 + |s|^2) / sqrt(|s|^2 + 1e-12)), with IEEE sqrt and
// division.  mode: 0 first pass (V = v), 1 middle pass (V += v), 2 last
// (caps = v); s_out: this iteration's (B, K, D) slice of s_saved, or null.
__device__ __forceinline__ void squash_element(const float* partial,
                                               float* vsum, float* out,
                                               float* s_out, int K,
                                               int tiles, int mode, int b) {
  const int KD = K * kD;
  // blockDim.x is a multiple of 32 and kD divides 32: a capsule's kD
  // outputs sit in one warp for the shuffle below
  for (int j0 = 0; j0 < KD; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool valid = j < KD;
    float s = 0.f;
    if (valid) {
      const float* src = partial + int64_t(b) * tiles * KD + j;
      for (int t = 0; t < tiles; ++t) s += __ldcg(src + int64_t(t) * KD);
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
      vsum[o] = __ldcg(vsum + o) + v;
  }
}

// The whole call, one cooperative launch of persistent blocks: per
// iteration, the (node tile, element group) items of the pass, a grid
// barrier, the squash of each element, a grid barrier.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    routing_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ partial, float* __restrict__ vsum,
                   float* __restrict__ out, float* __restrict__ s_saved,
                   int B, int N, int K, int n_iter, int tile_nodes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tiles = (N + tile_nodes - 1) / tile_nodes;
  const int items = tiles * ((B + kBG - 1) / kBG);
  if (threadIdx.x == 0) {
    cyt::mbar_init(&bars[0], 1);
    cyt::mbar_init(&bars[1], 1);
    cyt::mbar_init_fence();
  }
  __syncthreads();
  int fills = 0;  // W copies so far, the same in every thread
  for (int t = 0; t < n_iter; ++t) {
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      pass_item<T>(x, w, t == 0 ? nullptr : vsum, partial, B, N, K,
                   tile_nodes, tiles, item % tiles, item / tiles, smem_raw,
                   fills);
    grid.sync();
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      squash_element(partial, vsum, out,
                     s_saved == nullptr ? nullptr
                                        : s_saved + int64_t(t) * B * K * kD,
                     K, tiles, t == n_iter - 1 ? 2 : (t == 0 ? 0 : 1), b);
    if (t + 1 < n_iter) grid.sync();
  }
}

int pass_threads(int K) { return (K * kLanes + 31) / 32 * 32; }

template <typename T>
size_t pass_smem(int tile_nodes, int K) {
  return PassLayout::make<T>(tile_nodes, K).bytes();
}

// Blocks of routing_kernel<T> resident per SM at (tile_nodes, K); 0 if
// none fits, -1 on a CUDA error.
template <typename T>
int blocks_per_sm(int tile_nodes, int K) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, routing_kernel<T>, pass_threads(K),
          pass_smem<T>(tile_nodes, K)) != cudaSuccess)
    return -1;
  return per_sm;
}

// The launch of a call: out[0] the node tile in [kTileMin, kTileMax]
// and out[1] the blocks, all resident at once.  The items run in rounds
// of the resident blocks and a round lasts as long as an item's tile, so
// the tile minimises rounds x tile; on a tie the larger tile (fewer
// partials to sum).  Lets the kernel take the card's opt-in shared
// memory, once, so that a launch sets nothing.
template <typename T>
cudaError_t make_plan(int B, int N, int K, int* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(routing_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return err;
  const int64_t groups = (B + kBG - 1) / kBG;
  int64_t best_cost = -1;
  for (int t = kTileMax; t >= kTileMin; --t) {
    const int per_sm = blocks_per_sm<T>(t, K);
    if (per_sm < 0) return cudaGetLastError();
    if (per_sm == 0) continue;
    const int64_t slots = int64_t(per_sm) * sms;
    const int64_t items = (N + t - 1) / t * groups;
    const int64_t cost = (items + slots - 1) / slots * t;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      out[0] = t;
      out[1] = int(items < slots ? items : slots);
    }
  }
  return best_cost < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename T>
int run(const void* x, const void* w, float* partial, float* vsum,
        float* out, float* s_saved, int B, int N, int K, int n_iter,
        int tile_nodes, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  void* args[] = {&xt, &wt, &partial, &vsum, &out, &s_saved,
                  &B,  &N,  &K,       &n_iter, &tile_nodes};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(routing_kernel<T>), dim3(blocks),
      dim3(pass_threads(K)), args, pass_smem<T>(tile_nodes, K), s));
}

}  // namespace

// K3's launch for (B, N, K) in dtype on the current device: out[0] the
// node tile, out[1] the blocks (see make_plan).  Returns 0, or a CUDA
// error code.
extern "C" int cyt_routing_plan(int64_t B, int64_t N, int64_t K, int dtype,
                                int* out) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == cyt::kFloat32)
    err = make_plan<float>(int(B), int(N), int(K), out);
  else if (dtype == cyt::kBFloat16)
    err = make_plan<__nv_bfloat16>(int(B), int(N), int(K), out);
  return static_cast<int>(err);
}

// x: (B, N, C) and w: (N, K, C, D) contiguous in dtype (C = 8, D = 16,
// K <= 48), w 16-byte aligned; partial: (B, ceil(N / tile_nodes), K, D)
// f32 scratch; vsum: (B, K, D) f32 scratch; out: (B, K, D) f32; s_saved:
// null, or (n_iter, B, K, D) f32 that receives each iteration's node
// sums s_t; tile_nodes and blocks from cyt_routing_plan.  One
// cooperative launch on `stream`; returns its error, or 0.
extern "C" int cyt_routing(const void* x, const void* w, void* partial,
                           void* vsum, void* out, void* s_saved, int64_t B,
                           int64_t N, int64_t K, int64_t C, int64_t D,
                           int n_iter, int tile_nodes, int blocks, int dtype,
                           void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > kMaxK || C != kC || D != kD ||
      n_iter < 1 || tile_nodes < kTileMin || tile_nodes > kTileMax ||
      blocks < 1 || B * N * C >= (int64_t(1) << 31) ||
      N * K * C * D >= (int64_t(1) << 31) || !cyt::aligned16(partial) ||
      !cyt::aligned16(vsum) || !cyt::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = int(B), n = int(N), k = int(K);
  float* p = static_cast<float*>(partial);
  float* v = static_cast<float*>(vsum);
  float* o = static_cast<float*>(out);
  float* ss = static_cast<float*>(s_saved);
  if (dtype == cyt::kFloat32)
    return run<float>(x, w, p, v, o, ss, b, n, k, n_iter, tile_nodes, blocks,
                      s);
  if (dtype == cyt::kBFloat16)
    return run<__nv_bfloat16>(x, w, p, v, o, ss, b, n, k, n_iter, tile_nodes,
                              blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
