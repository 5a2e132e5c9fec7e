// K5: CapsuleNet's primary capsules for sm_90a, in serving:
//   out[b, c * 81 + p, j] = squash_j(conv(x, W)[b, 16 j + c, p] + b[16 j + c])
// from conv1's relu'd map x (B, 256, 24, 24) in the channels-last layout
// cuDNN leaves it in, and the eight 8x8 stride-2 convs of 16 channels
// stacked as W (128, 256, 8, 8): the 1296 squashed 8-vectors per crop
// that the routing (K3) reads, node c * 81 + p in the reference's
// order.
//
// K5 replaces no TPU kernel: the JAX package leaves this conv to XLA.
// It was added because, in serving, cuDNN ran the conv on the f32 CUDA
// cores (an FFMA implicit GEMM, ~1.45 ms at B 64, ~9% of the bound
// below) and more kernels reshaped, copied and squashed its output.
//
// Bound on the H100: operations.  As a GEMM the conv is M = B x 81 rows
// (crop b, output position p), N = 128 and K = 256 x 64 = 16,384: 339.7
// MFLOP a crop.  The products run on the TF32 tensor cores as a split-
// precision ("3xTF32") product that keeps the f32 band, K2's scheme
// (csrc/input_stage.cu): each operand a is split into hi = tf32(a) and
// lo = tf32(a - hi), and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the dropped a_lo b_lo and the rounding of lo are each about 2^-22 of
// |a b|; one-pass TF32 is not inside rtol 1e-5).  Three products of
// 339.7 MFLOP a crop at TF32's 495 TFLOP/s: 0.132 ms at B 64, 1.054 ms
// at B 512.  The bytes (x read once, W once, the capsules written once:
// 0.61 MB a crop and 8.4 MB) take a tenth of that, but the im2col reads
// every input pixel ~9 times, from L2.
//
// Design:
// - A block computes a 128-row tile of M against all N = 128 columns,
//   so each node's 8-vector (columns 16 j + c, j = 0..7) ends in one
//   block and the squash is the block's epilogue.  Its two warpgroups
//   take 64 rows each as wgmma m64n128k8 (tf32, f32 accumulation), A
//   from registers and B from shared memory: per k-step of 8, the three
//   products into one accumulator, the two small ones first.  (An
//   mma.sync m16n8k8 version of the same tiling, 8 warps of 64 x 32,
//   took 0.47 and 2.86 ms at B 64 and 512.)
// - K runs as (input-channel chunk of 32, tap (r, s) of the 8x8 window,
//   channel in the chunk): a k-chunk of 32 is one tap's 32 channels, 128
//   contiguous bytes of x per row (channels-last), so the A tile is
//   gathered straight from x by 16-byte cp.async (im2col in the
//   addresses; no im2col buffer reaches device memory) and the rows
//   past M are zero-filled.  The chunk is the outer loop, so a block's
//   64 taps reread one chunk's slice of its ~1.6 crops (118 KB) while it
//   is in L2.  The weights are laid out once per weight version
//   (`ops/primary_caps.py:prepare_weights`) as [chunk][tap][n][32], one
//   contiguous 16 KB B tile per k-chunk.
// - A 4-stage ring (48 KB a stage: the A tile, the B tile split in place
//   into hi and a lo tile beside it), two k-chunks in flight: each
//   thread splits the B bytes it copied itself, so one barrier a
//   k-chunk makes the tiles whole; the products of k-chunk it run while
//   k-chunk it + 1 is split (wgmma.wait_group 1), and the stage of
//   k-chunk it - 2, whose products are done, takes the next copy.  Both
//   tiles are stored 128 bytes a row with the 16-byte column XOR-
//   swizzled by the row: the 128-byte swizzle of wgmma's descriptor for
//   B, and conflict-free ldmatrix.x4 for A (a 32-bit value is a pair of
//   16-bit ones: a matrix row is 4 f32), split in registers after its
//   load.
// - The tensor cores' sums cover two k-chunks (64 of K) and are then
//   added to the block's sums by IEEE f32 adds: accumulated over all of
//   K on the tensor cores the capsules came out up to 1.1e-4 off the
//   plain version; so they are 4-7e-7 off an f64 conv, where cuDNN's f32
//   conv is 3-6e-6 off.
// - Few tiles: B 64 gives 41 tiles for 132 SMs (one block each), so K
//   is split over the 8 input-channel chunks by `plan`: the split that
//   minimises waves x chunks a block, from B and the card's resident
//   blocks (3 at B 64: 123 blocks; 2 at B 512: 648 blocks in 5 waves
//   instead of 324 in 3 with the last half empty).  Each block of a
//   split tile writes its raw partial sums to a workspace, and the last
//   of them to arrive (an atomic count per tile) adds the partials in
//   split order and runs the epilogue: two calls on the same input give
//   the same bits.
// - Epilogue: the sums plus the bias go through shared memory (128 x
//   129 floats, reusing the ring), a thread takes a (row, c) pair,
//   squashes its 8 values as ops/capsule.py:squash does (IEEE sqrt and
//   division, SQUASH_EPS 1e-12) and writes the 32-byte capsule; a
//   warp's 32 rows of one c are 32 consecutive nodes.
// On an H100 SXM at 700 W: 0.330 ms at B 64 (40% of the bound), 1.95 ms
// at B 512 (54%); 227 registers, no spills.

#include "common.cuh"

namespace {

constexpr int kIn = 24;                 // input rows and columns
constexpr int kCin = 256;               // input channels
constexpr int kKer = 8;                 // window rows and columns
constexpr int kOut = 9;                 // output rows and columns
constexpr int kPos = kOut * kOut;       // 81
constexpr int kTaps = kKer * kKer;      // 64
constexpr int kN = 128;                 // output channels: 8 dims x 16
constexpr int kDims = 8;                // j: a capsule's dims
constexpr int kChan = 16;               // c: channels of one conv
constexpr int kNodes = kChan * kPos;    // 1296
constexpr int kBK = 32;                 // input channels of a k-chunk
constexpr int kChunks = kCin / kBK;     // 8
constexpr int kBM = 128;                // rows of a tile
constexpr int kThreads = 256;           // two warpgroups
constexpr int kStages = 4;
constexpr int kTileFloats = kBM * kBK;  // 16 KB: the A, B hi and B lo tiles
constexpr int kStageFloats = 3 * kTileFloats;
// the ring, and 1 KB to align it to the swizzle's 1024-byte pattern
constexpr int kSmemBytes = kStages * kStageFloats * 4 + 1024;
constexpr int kEPitch = kN + 1;         // epilogue row pitch, floats
constexpr int kAcc = 64;                // accumulators a thread
constexpr int kPromote = 2;             // k-chunks a tensor-core sum takes
constexpr float kSquashEps = 1e-12f;    // ops/capsule.py:SQUASH_EPS

static_assert(kN == kBM, "the A and B tiles share the loader's rows");
static_assert(kBM * kEPitch * 4 <= kStages * kStageFloats * 4,
              "the epilogue fits the ring");

// cvt.rna.tf32.f32 as two integer operations (csrc/input_stage.cu)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 2^-22 of |v|: hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi,
                                      uint32_t& lo) {
  const float f = __uint_as_float(v);
  hi = tf32(f);
  lo = tf32(f - __uint_as_float(hi));
}

// Four 8 x 4 f32 matrices (8 rows of 16 bytes each) from shared memory:
// lanes 8 m .. 8 m + 7 give matrix m's row addresses; r[m] receives word
// l % 4 of row l / 4 of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from src to shared dst, or zeros when !in
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// d = A B (scale_d 0) or d += A B on a warpgroup: m64 n128 k8, TF32
// operands, f32 accumulation.  A from registers, as mma.sync m16n8k8's
// A for the warp's 16 rows (a0: row l / 4, a1: row + 8, column l % 4;
// a2, a3: column + 4); B (128 x 8, K-major) from shared memory by
// descriptor; d[4 i + e] at row l / 4 + 8 (e >> 1), column 8 i + 2 (l %
// 4) + (e & 1) of the warp's rows.  Asynchronous: d and a are not
// touched until a wait_group has seen it done.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most n of this warpgroup's wgmma groups are pending
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(n) : "memory");
}

// The compiler sees a wgmma as done when it is issued: these empty uses
// keep its accumulators and A fragments in their registers until after
// the wait that saw it done.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma's descriptor of a K-major tile of 128-byte rows at shared address
// addr: 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Block (tile, split): rows 128 tile .. of M against all 128 columns,
// over input-channel chunks [split x 8 / splits, (split + 1) x 8 /
// splits).  With splits > 1, ws holds (splits, tiles, kAcc, kThreads)
// partial sums and then one arrival count per tile, zeroed before the
// launch.
__global__ void __launch_bounds__(kThreads, 1)
primary_caps_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ ws, int M, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_last;
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, part = blockIdx.y, tiles = gridDim.x;
  const int m0 = tile * kBM;
  const int cc0 = part * kChunks / splits;
  const int n_it = ((part + 1) * kChunks / splits - cc0) * kTaps;

  // the loader: 16-byte column q of rows (tid >> 3) + 32 i of both tiles
  const int q = tid & 7;
  const float* a_src[4];
  bool a_in[4];
  int s_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (tid >> 3) + 32 * i, m = m0 + row;
    a_in[i] = m < M;
    const int mm = a_in[i] ? m : 0;
    const int b = mm / kPos, p = mm - b * kPos;
    const int oy = p / kOut, ox = p - oy * kOut;
    a_src[i] = x + ((int64_t(b) * kIn + 2 * oy) * kIn + 2 * ox) * kCin +
               4 * q;
    s_off[i] = row * kBK + 4 * (q ^ (row & 7));
  }
  const float* b_src = wp + (tid >> 3) * kBK + 4 * q;

  auto load = [&](int stage, int it) {
    const int cc = cc0 + it / kTaps, tap = it % kTaps;
    const int64_t a_off = ((tap / kKer) * kIn + tap % kKer) * kCin +
                          cc * kBK;
    const float* bt = b_src + int64_t(cc * kTaps + tap) * kN * kBK;
    float* sa = smem + stage * kStageFloats;
    float* sb = sa + kTileFloats;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      copy16(sa + s_off[i], a_in[i] ? a_src[i] + a_off : x, a_in[i]);
      copy16(sb + s_off[i], bt + 32 * i * kBK, true);
    }
    commit();
  };

  // the ring: k-chunks it + 1 and it + 2 in flight while k-chunk it is
  // split and multiplied and k-chunk it - 1's products may still run
#pragma unroll
  for (int st = 0; st < kStages - 2; ++st) {
    if (st < n_it)
      load(st, st);
    else
      commit();
  }

  // warpgroup wg takes rows 64 wg ..; warp w of it rows 16 w ..
  const int wg = warp >> 2, wq = warp & 3;
  const int l7 = lane & 7;
  const int a_half = lane >> 4;
  const uint32_t a_row = (wg * 64 + wq * 16 + l7 + 8 * ((lane >> 3) & 1)) *
                         kBK * 4;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // acc: the tensor cores' sums over the last kPromote k-chunks; sum:
  // the block's, added to by IEEE f32 adds
  float acc[kAcc], sum[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc[i] = 0.f;
    sum[i] = 0.f;
  }
  int fresh = 1;  // the next wgmma starts acc afresh
  // A fragments (hi, lo) of 4 k-steps, for even and odd k-chunks
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];

  auto step = [&](int it, uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                  uint32_t (&oh)[4][4], uint32_t (&ol)[4][4]) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 3) : "memory");
    float* st = smem + (it % kStages) * kStageFloats;
    // split the B chunks this thread copied: hi in place, lo beside
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* bh = reinterpret_cast<float4*>(st + kTileFloats + s_off[i]);
      float4* bl =
          reinterpret_cast<float4*>(st + 2 * kTileFloats + s_off[i]);
      const float4 v = *bh;
      uint32_t h[4], l[4];
      split(__float_as_uint(v.x), h[0], l[0]);
      split(__float_as_uint(v.y), h[1], l[1]);
      split(__float_as_uint(v.z), h[2], l[2]);
      split(__float_as_uint(v.w), h[3], l[3]);
      *bh = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
      *bl = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // k-chunk it is in place for every warp; every warp is done waiting
    // for k-chunk it - 2's products, whose stage the next load takes
    __syncthreads();
    const int nxt = it + kStages - 2;
    if (nxt < n_it)
      load(nxt % kStages, nxt);
    else
      commit();

    const uint32_t sa = ring + (it % kStages) * kStageFloats * 4;
    const uint32_t sbh = sa + kTileFloats * 4, sbl = sbh + kTileFloats * 4;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t r[4];
      ldmatrix_x4(r, sa + a_row + (((2 * ks + a_half) ^ l7) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) split(r[e], ah[ks][e], al[ks][e]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      wgmma_tf32(acc, al[ks], desc_of(sbh + 32 * ks), ks || !fresh);
      wgmma_tf32(acc, ah[ks], desc_of(sbl + 32 * ks), 1);
      wgmma_tf32(acc, ah[ks], desc_of(sbh + 32 * ks), 1);
    }
    wgmma_commit();
    if (it % kPromote == kPromote - 1 || it == n_it - 1) {
      wgmma_wait<0>();
      hold(acc);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum[i] += acc[i];
      fresh = 1;
    } else {
      wgmma_wait<1>();
      fresh = 0;
    }
    // k-chunk it - 1's products are done: their A fragments may go
    hold(oh);
    hold(ol);
  };

  for (int it = 0; it < n_it; it += 2) {  // n_it is a multiple of 64
    step(it, ah0, al0, ah1, al1);
    step(it + 1, ah1, al1, ah0, al0);
  }
  hold(ah1);
  hold(al1);
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  if (splits > 1) {
    // every block of the tile leaves its partial sums; the last to
    // arrive adds them in split order
    float* mine = ws + (int64_t(part) * tiles + tile) * kAcc * kThreads + tid;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) __stcg(mine + i * kThreads, sum[i]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* count = reinterpret_cast<int*>(
          ws + int64_t(splits) * tiles * kAcc * kThreads);
      s_last = atomicAdd(count + tile, 1) == splits - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      float total = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float v =
            s == part ? sum[i]
                      : __ldcg(ws + ((int64_t(s) * tiles + tile) * kAcc + i) *
                                        kThreads + tid);
        total = s == 0 ? v : total + v;
      }
      sum[i] = total;
    }
  }

  // epilogue: the tile plus the bias, row-major in shared memory
  __syncthreads();  // every warp is done with the ring
  float* e = smem;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const int col = nb * 8 + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* at = e + (wg * 64 + wq * 16 + g + 8 * h) * kEPitch + col;
      at[0] = sum[nb * 4 + 2 * h] + b0;
      at[1] = sum[nb * 4 + 2 * h + 1] + b1;
    }
  }
  __syncthreads();

  // squash: warp w takes channels c = w and w + 8, 32 rows at a time
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int c = warp + 8 * ch;
#pragma unroll
    for (int pass = 0; pass < kBM / 32; ++pass) {
      const int row = pass * 32 + lane, m = m0 + row;
      if (m >= M) continue;
      float v[kDims], n2 = 0.f;
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        v[j] = e[row * kEPitch + j * kChan + c];
        n2 += v[j] * v[j];
      }
      const float scale = n2 / (1.f + n2);
      const float inv = 1.f / sqrtf(n2 + kSquashEps);
      const int b = m / kPos, p = m - b * kPos;
      float4* dst = reinterpret_cast<float4*>(
          out + (int64_t(b) * kNodes + c * kPos + p) * kDims);
      dst[0] = make_float4(scale * v[0] * inv, scale * v[1] * inv,
                           scale * v[2] * inv, scale * v[3] * inv);
      dst[1] = make_float4(scale * v[4] * inv, scale * v[5] * inv,
                           scale * v[6] * inv, scale * v[7] * inv);
    }
  }
}

// Resident blocks on the current device (the kernel's shared memory
// opted in, once), or a negative CUDA error.
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -int(err);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(primary_caps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, primary_caps_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -int(err);
  if (per_sm < 1) return -int(cudaErrorInvalidConfiguration);
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

// K5's launch for B crops on the current device: out[0] the row tiles,
// out[1] the K split (the one that minimises waves of resident blocks
// x input-channel chunks a block; the smaller on a tie), out[2] the
// workspace's floats (0 without a split).  Returns 0 or a CUDA error.
extern "C" int cyt_primary_caps_plan(int64_t B, int64_t* out) {
  if (B <= 0 || B * kIn * kIn * kCin >= (int64_t(1) << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = resident_blocks();
  if (slots < 0) return -slots;
  const int64_t tiles = (B * kPos + kBM - 1) / kBM;
  int64_t best = 1, best_cost = -1;
  for (int s = 1; s <= kChunks; ++s) {
    const int64_t waves = (tiles * s + slots - 1) / slots;
    const int64_t cost = waves * ((kChunks + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  out[0] = tiles;
  out[1] = best;
  out[2] = best > 1 ? best * tiles * kAcc * kThreads + tiles : 0;
  return 0;
}

// x: (B, 24, 24, 256) f32 (conv1's map, channels-last), 16-byte aligned;
// wp: (8, 64, 128, 32) f32, the weights as prepare_weights lays them
// out, 16-byte aligned; bias: (128) f32; out: (B, 1296, 8) f32, 16-byte
// aligned; ws: the plan's workspace floats (unused without a split);
// splits in 1..8.  Zeroes the workspace's arrival counts, then one
// launch on `stream`; returns its error, or 0.
extern "C" int cyt_primary_caps(const void* x, const void* wp,
                                const void* bias, void* out, void* ws,
                                int64_t B, int splits, void* stream) {
  if (B <= 0 || splits < 1 || splits > kChunks ||
      B * kIn * kIn * kCin >= (int64_t(1) << 40) || !cyt::aligned16(x) ||
      !cyt::aligned16(wp) || !cyt::aligned16(out) ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = resident_blocks();
  if (slots < 0) return -slots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (B * kPos + kBM - 1) / kBM;
  float* w = static_cast<float*>(ws);
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        w + int64_t(splits) * tiles * kAcc * kThreads, 0,
        tiles * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  primary_caps_kernel<<<dim3(unsigned(tiles), splits), kThreads, kSmemBytes,
                        s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp),
      static_cast<const float*>(bias), static_cast<float*>(out), w,
      int(B * kPos), splits);
  return static_cast<int>(cudaGetLastError());
}
