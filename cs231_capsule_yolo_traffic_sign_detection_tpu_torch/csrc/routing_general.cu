// K3g: capsule votes fused with routing by agreement at any capsule
// shape, for sm_90a.
//
// Replaces the TPU kernel ops/routing_pallas.py:_route
// (_routing_fwd_kernel, entry routed_capsules_pallas) at every shape
// outside the tuned K3 (csrc/routing.cu: in_C 8, D 16, K <= 48): f32,
// in_C <= 16, K <= 64, D <= 64, any N and B.  That covers the routings of
// DarkCapsuleNet2 (N 784, K 49, C 8, D 48) and DarkCapsuleNet3 (N 512,
// K 43, C 8, D 21 over g^2 B cells).  It computes, as K3,
//   priors[b,n,k,d] = sum_c x[b,n,c] W[n,k,c,d]
//   for t < n_iter: probs = softmax_k(logits), s_t = sum_n probs priors,
//                   v_t = squash(s_t), logits += sum_d priors v_t
// and caps = v_{n_iter-1}; the priors never reach global memory.
//
// Bound on the H100: operations.  Each routing pass recomputes the votes.
// The work needed once is the votes (2 B N K C D FLOP) and 2 n_iter - 1
// node-sized passes (2 B N K D each): at DarkCapsuleNet3's shape (B 1568)
// 18.9 GFLOP against 46 MB moved, 0.28 ms at 67 TFLOP/s; at
// DarkCapsuleNet2's (B 32) 1.5 GFLOP against 60 MB
// (chip_smoke.py:routing_bound).
//
// Design.  The first design (one thread an output, votes by FMAs with W
// read from L2 one in_C at a time, blocks of 4-8 elements, a barrier pair
// a node) ran 34x and 48x over that bound.  Now, per iteration:
//  1. rg_tile_kernel (routing_general.cuh), one block (or a cluster of
//     S blocks splitting the capsules) per (node tile, group of 16
//     elements): the votes on the tensor cores (3xTF32 mma.sync, the
//     group as M) kept in registers across the softmax's barrier pair,
//     the node sum s += probs priors by f32 FMAs, W by TMA bulk copies
//     two chunks ahead on mbarriers; one partial s per (element, tile).
//     The first pass has no logits: every probability is 1/K, no
//     barrier pair.  At DarkCapsuleNet3's shape one block of 11 warps
//     takes all 43 capsules (4 a warp, 12 n-tiles); at DarkCapsuleNet2's
//     (B 32: two groups) a cluster of two blocks splits the 49 capsules,
//     so that 33 node tiles put 132 blocks on the card;
//  2. rg_squash_kernel, one block per element: the partials summed over
//     the tiles in a fixed order, |s|^2 of each capsule summed in order
//     d = 0 .. D-1, v = s * (|s|^2 / (1 + |s|^2) / sqrt(|s|^2 + 1e-12)).
//     It adds v to V (V = v on the first pass), or writes the caps on the
//     last; for training it also writes s_t, from which K4g
//     (routing_general_bwd.cu) rebuilds V_t bit for bit.
// W is read from L2 once per element group and pass.  No atomics: two
// calls give the same bits.  The squash stays its own launch (6 a call):
// grid barriers (the tuned K3's) need a cooperative launch of blocks all
// resident at once, where a pass here launches clusters and several
// waves of blocks; the squashes take about 0.03 ms of a 5 ms call.

#include "routing_general.cuh"

namespace {

using namespace cyt::rg;

// The node sums of element b: the tiles' partials summed in a fixed
// order, squashed.  mode: 0 first pass (V = v), 1 middle pass (V += v),
// 2 last (caps = v); s_out: this iteration's (B, K, D) slice of s_saved,
// or null.
__global__ void rg_squash_kernel(const float* __restrict__ partial,
                                 float* __restrict__ vsum,
                                 float* __restrict__ out,
                                 float* __restrict__ s_out, int K, int D,
                                 int tiles, int mode) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int KD = K * D;
  float* ss = smem;        // [K][D]
  float* n2s = ss + KD;    // [K]
  for (int j = threadIdx.x; j < KD; j += blockDim.x) {
    const float* src = partial + int64_t(b) * tiles * KD + j;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += src[int64_t(t) * KD];
    ss[j] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    n2s[k] = capsule_n2(ss + k * D, D);
  __syncthreads();
  for (int j = threadIdx.x; j < KD; j += blockDim.x) {
    const float s = ss[j];
    const float v = s * squash_scale(n2s[j / D]);
    const int64_t o = int64_t(b) * KD + j;
    if (s_out != nullptr) s_out[o] = s;
    if (mode == 2)
      out[o] = v;
    else if (mode == 0)
      vsum[o] = v;
    else
      vsum[o] = vsum[o] + v;
  }
}

// the plan's ints, in order (see cyt_routing_general_plan)
void plan_ints(const TileArgs& a, int* out) {
  const int v[] = {a.tile, a.tiles, a.S, a.NB, a.warps, a.cw, a.nt, a.bulk};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

}  // namespace

// K3g's launch plan for (B, N, K, C, D) on the current device, for a W
// at address w_addr (TMA needs 16-byte alignment), in out[8]: the node
// tile, the tiles, blocks a cluster, nodes a chunk, warps a block,
// capsules a warp, n-tiles a capsule, W by bulk copies (1) or not (0).
// Returns 0, or a CUDA error code.
extern "C" int cyt_routing_general_plan(int64_t B, int64_t N, int64_t K,
                                        int64_t C, int64_t D, int64_t w_addr,
                                        int* out) {
  if (!shape_ok(B, N, K, C, D)) return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a = {};
  const int err = plan_tile(a, int(B), int(N), int(K), int(C), int(D),
                                   1, w_addr);
  if (err == 0) plan_ints(a, out);
  return err;
}

// x: (B, N, C) and w: (N, K, C, D) contiguous f32 (C <= 16, K <= 64,
// D <= 64); partial: (B, tiles, K, D) f32 scratch; vsum: (B, K, D) f32
// scratch; out: (B, K, D) f32; s_saved: (n_iter, B, K, D) f32 or null;
// plan: the 8 ints of cyt_routing_general_plan for this w.  Launches
// 2 n_iter kernels on `stream`.  Returns the first error that is not 0,
// or 0.
extern "C" int cyt_routing_general(const void* x, const void* w,
                                   void* partial, void* vsum, void* out,
                                   void* s_saved, int64_t B, int64_t N,
                                   int64_t K, int64_t C, int64_t D,
                                   int n_iter, const int* plan,
                                   void* stream) {
  if (!shape_ok(B, N, K, C, D) || n_iter < 1 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a = {};
  int err = plan_tile(a, int(B), int(N), int(K), int(C), int(D), 1,
                             reinterpret_cast<int64_t>(w));
  int mine[8];
  if (err != 0) return err;
  plan_ints(a, mine);
  for (int i = 0; i < 8; ++i)
    if (mine[i] != plan[i]) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = int(B), k = int(K), d = int(D);
  const int groups = (b + kRows - 1) / kRows;
  float* p = static_cast<float*>(partial);
  float* v = static_cast<float*>(vsum);
  float* o = static_cast<float*>(out);
  float* ss = static_cast<float*>(s_saved);
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.vec0 = v;
  a.vec1 = nullptr;
  a.vec_stride = int64_t(k) * d;
  a.partial = p;
  const int sq_threads = min((k * d + 31) / 32 * 32, 1024);
  const size_t sq_smem = sizeof(float) * size_t(k * d + k);
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  for (int t = 0; t < n_iter; ++t) {
    TileArgs at = a;
    if (t == 0) {  // the first pass: no logits, chunks of 2 nodes
      at.nv = 0;
      at.NB = 2;
      tile_layout(at);
      if (tile_bytes(at) > size_t(optin)) at.NB = 1;
    }
    tile_layout(at);
    cudaError_t e = run_tile<false>(at, groups, s);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rg_squash_kernel<<<b, sq_threads, sq_smem, s>>>(
        p, v, o, ss == nullptr ? nullptr : ss + int64_t(t) * b * k * d, k, d,
        a.tiles, t == n_iter - 1 ? 2 : (t == 0 ? 0 : 1));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
