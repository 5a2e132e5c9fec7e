// K2: DarkNet's fused input stage for sm_90a:
//   out = leaky(max over each 2x2 window of (conv3x3(x, w) + b))
// with conv1's BN already folded into w (3,3,3,32 HWIO) and b (32).
//
// Replaces the TPU kernel ops/input_stage.py:input_stage_pallas
// (_input_stage_kernel).  The TPU formulation rearranged the image by
// space-to-depth and ran one K=108 contraction per pooled pixel against
// a phase-stacked kernel (3,3,12,128) so the 128-lane matrix unit was
// busy; 81 of every 108 taps in that kernel are zeros.  Here the same
// function is computed directly: the 3x3x3 conv at each of the four
// positions of the pool window (27 taps x 32 channels each), the max
// over the four, the bias, the leaky slope.  Neither a space-to-depth
// image nor the four pre-pool maps ever reach device memory; only the
// pooled [B, H/2, W/2, 32] tensor is written.  Two kernels, one per
// input type.
//
// f32 (input_stage_kernel<float>), bound on the H100: operations.  At
// batch 32 and 448 px the work is 11.1 GFLOP (32 * 448^2 * 32 * 27 * 2)
// against 0.28 GB of traffic (f32 input read plus pooled output write):
// 0.166 ms on the f32 CUDA cores (67 TFLOP/s) against 0.085 ms at 3.35
// TB/s.  TF32 tensor cores stay off: the f32 path keeps f32 products.
//
// Design: a block of 256 threads owns a tile of 2 pooled rows x 32
// pooled columns x all 32 channels.  It stages the tile's input halo
// (6 x 66 pixels x 3 channels, zero outside the image: the conv's
// padding) and the 864 weights in shared memory.  Warp w takes pooled
// row w / 4 and output channels 8 * (w % 4) .. +7; its lane is the
// pooled column.  Each thread keeps its 4x4x3 input patch in registers
// and 4 phases x 8 channels of f32 accumulators; all lanes of a warp
// read the same weights, so shared-memory weight loads are broadcasts.
// Accumulation is f32; the output is stored as 16-byte packs.
//
// bf16 (input_stage_mma_kernel), bound on the H100: bytes.  The same
// batch moves 38.5 MB of bf16 frames in and 102.8 MB of pooled bf16
// out: 0.042 ms at 3.35 TB/s, while the products, padded to K = 32,
// are 13.2 GFLOP: 0.013 ms on the bf16 tensor cores.  On the CUDA cores
// (the f32 kernel with bf16 loads, 0.436 ms) it was issue-bound 10x
// over that bound, so the conv runs as a GEMM on mma.sync m16n8k16
// (bf16 operands, f32 accumulation, as the TPU kernel's
// preferred_element_type=f32; wgmma would want A in a shared-memory
// layout that an im2col gather does not give):
// - M is full-resolution pixels, 16 per mma: row 8 di + 2 w + dj holds
//   phase (di, dj) of pooled pixel w of 4.  N is the 32 channels (4
//   n-tiles of 8).  K is the 27 taps in pairs: row u of the 3x3 window
//   is 9 contiguous bf16 values in NHWC (3 pixels x 3 channels), taken
//   as 5 pairs, the fifth's second value and K 30, 31 masked to zero.
//   Each lane keeps its B fragments (bf16 weights in that order, built
//   once per block in shared memory from the f32 w) in 16 registers.
// - im2col in registers: a lane's K columns are fixed by lane % 4, so
//   its 4 pair offsets into the shared-memory halo are computed once;
//   each A register is then one 32-bit shared load.  A pair starts at
//   an odd 16-bit offset on odd pixel columns, so the halo is kept
//   twice, the second copy 2 bytes earlier, and a lane reads the copy
//   that aligns its column (padding channels 3 -> 4 instead would need
//   K = 36 > 32).  The halo's row pitch (576 bytes) spreads the loads
//   over the banks.
// - Pool in registers: a lane holds both row phases of its pixel's
//   column phase, so max(c0, c2) takes the row phase and one shuffle
//   with lane ^ 4 the column phase; each lane of the pair keeps 2 of the
//   4 n-tiles.  The bias is added after the max (adding a constant
//   commutes with max under monotone rounding), then the slope, then
//   one rounding to bf16.
// - Loads and stores: when W2 % 8 == 0 and x is 16-byte aligned (448
//   px), a halo row is loaded as 16-byte vectors from 8 pixels left of
//   the halo; otherwise as 16-bit scalars.  A warp's 32 pooled pixels
//   (2 KB, contiguous in NHWC) go through a shared-memory stage,
//   swizzled against bank conflicts, and out as coalesced 16-byte
//   stores.
// - Tiling: a warp owns 1 pooled row x 32 pooled columns (8 m-tiles), a
//   block 8 warps and 4 such row tiles one after another, the next
//   tile's halo loaded into registers during a tile's products (the
//   loads and the products of one tile otherwise do not overlap); the
//   ragged edge is masked.

#include "common.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kCout = 32;
constexpr int kTaps = 3 * 3 * kCin;   // 27
constexpr int kTileRows = 2;          // pooled rows per block
constexpr int kTileCols = 32;         // pooled columns per block (= lanes)
constexpr int kGroups = 4;            // channel groups of 8
constexpr int kHaloRows = 2 * kTileRows + 2;
constexpr int kHaloCols = 2 * kTileCols + 2;
constexpr int kThreads = 32 * kTileRows * kGroups;  // 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
input_stage_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int H2, int W2, float slope) {
  __shared__ float s_x[kHaloRows][kHaloCols][kCin];
  __shared__ __align__(16) float s_w[kTaps * kCout];
  __shared__ float s_b[kCout];

  const int Ho = H2 / 2, Wo = W2 / 2;
  const int p0 = blockIdx.y * kTileRows, q0 = blockIdx.x * kTileCols;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  for (int i = tid; i < kTaps * kCout; i += kThreads) s_w[i] = w[i];
  if (tid < kCout) s_b[tid] = bias[tid];

  // halo: full-res rows 2*p0-1 .. 2*p0+2*kTileRows, cols 2*q0-1 ..;
  // each halo row is one contiguous run of kHaloCols*kCin values
  const T* xb = x + int64_t(b) * H2 * W2 * kCin;
  const int r0 = 2 * p0 - 1, c0 = 2 * q0 - 1;
  for (int i = tid; i < kHaloRows * kHaloCols * kCin; i += kThreads) {
    const int r = i / (kHaloCols * kCin);
    const int rem = i - r * (kHaloCols * kCin);
    const int col = rem / kCin, ch = rem - col * kCin;
    const int gr = r0 + r, gc = c0 + col;
    float v = 0.f;
    if (gr >= 0 && gr < H2 && gc >= 0 && gc < W2)
      v = cyt::to_f(xb[(int64_t(gr) * W2 + gc) * kCin + ch]);
    s_x[r][col][ch] = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = warp % kGroups, tr = warp / kGroups;
  const int p = p0 + tr, q = q0 + lane;
  if (p >= Ho || q >= Wo) return;

  float xin[4][4][kCin];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < kCin; ++c)
        xin[i][j][c] = s_x[2 * tr + i][2 * lane + j][c];

  float acc[4][8];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[ph][k] = 0.f;

  const float4* w4 = reinterpret_cast<const float4*>(s_w);
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int c = 0; c < kCin; ++c) {
        const int t = (u * 3 + v) * kCin + c;  // HWIO tap index
        const float4 wa = w4[t * (kCout / 4) + 2 * g];
        const float4 wb = w4[t * (kCout / 4) + 2 * g + 1];
        const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const float xv = xin[di + u][dj + v][c];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[di * 2 + dj][k] = fmaf(xv, wk[k], acc[di * 2 + dj][k]);
          }
      }

  // max over the pool window, then the bias (adding a constant commutes
  // with max under monotone rounding), then leaky
  cyt::Pack<T, 8> r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float m = acc[0][k];
    m = acc[1][k] > m ? acc[1][k] : m;
    m = acc[2][k] > m ? acc[2][k] : m;
    m = acc[3][k] > m ? acc[3][k] : m;
    r.v[k] = cyt::from_f<T>(cyt::leaky(m + s_b[8 * g + k], slope));
  }
  T* o = out + ((int64_t(b) * Ho + p) * Wo + q) * kCout + 8 * g;
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<cyt::Pack<T, 8>*>(o) = r;
  } else {
    auto* o4 = reinterpret_cast<cyt::Pack<T, 4>*>(o);
    cyt::Pack<T, 4> lo, hi;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo.v[k] = r.v[k];
      hi.v[k] = r.v[4 + k];
    }
    o4[0] = lo;
    o4[1] = hi;
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kMmaWarps = 8;                 // pooled rows per block
constexpr int kMmaCols = 32;                 // pooled columns per block
constexpr int kMmaThreads = 32 * kMmaWarps;  // 256
constexpr int kMTiles = kMmaCols / 4;        // m16 tiles per warp
constexpr int kTilesPerBlock = 4;            // row tiles, one by one
constexpr int kMmaRows = 2 * kMmaWarps + 2;  // halo rows: 18
// a halo row in shared memory holds full-resolution columns 2 q0 - 8 ..
// 2 q0 + 71 (80 pixels, 480 bytes: 30 aligned 16-byte vectors); the
// halo proper starts at column 2 q0 - 1, shared column kLeft
constexpr int kSegVecs = (2 * kMmaCols + 16) * kCin * 2 / 16;
constexpr int kLeft = 7;
// bytes per halo row: = 64 mod 128 spreads the A loads over the banks
constexpr int kPitch = 576;
constexpr int kHaloBytes = kMmaRows * kPitch;  // a multiple of 128
constexpr int kPixBytes = kCout * 2;           // one pooled pixel, bf16
// K order: row u of the 3x3 window is 9 contiguous bf16 values (3
// pixels x 3 channels); each row takes 5 pairs of K columns, the last
// pair's second column and K 30, 31 are zero
constexpr int kPairsPerRow = 5;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B on the tensor cores: A 16 x 16 bf16 (a0: row l / 4, a1: row
// l / 4 + 8, columns 2 (l % 4) and +1; a2, a3: the same rows, columns
// + 8), B 16 x 8 bf16 (b0: rows 2 (l % 4) and +1, b1: rows + 8; column
// l / 4), d 16 x 8 f32 (d0, d1: row l / 4, d2, d3: row l / 4 + 8;
// columns 2 (l % 4) and +1).
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w (HWIO, f32) at K column k of the pair order, output channel n
__device__ __forceinline__ float weight(const float* w, int k, int n) {
  const int u = k / (2 * kPairsPerRow), j = k % (2 * kPairsPerRow);
  return u < 3 && j < 9 ? w[(9 * u + j) * kCout + n] : 0.f;
}

// The halo of one row tile in registers, loaded as 16-byte vectors
// (W2 % 8 == 0, x 16-byte aligned): vector j of halo row r covers bytes
// 16 j .. 16 j + 15 from full-res column 2 q0 - 8; `next` is the first
// word of vector j + 1, which copy 1 needs.  With W2 % 8 == 0 the row
// pitch, the segment's start and the image's edges all fall on
// multiples of 48 bytes, so a vector is wholly in or out of the image.
constexpr int kHaloVecs = kMmaRows * kSegVecs;
constexpr int kVecIters = (kHaloVecs + kMmaThreads - 1) / kMmaThreads;

struct Halo {
  uint4 v[kVecIters];
  uint32_t next[kVecIters];
};

__device__ __forceinline__ void halo_load(Halo& h,
                                          const unsigned char* xb, int p0,
                                          int q0, int H2, int64_t row_bytes) {
  const int seg0 = (2 * q0 - 8) * kCin * 2;
#pragma unroll
  for (int it = 0; it < kVecIters; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kSegVecs, j = i - r * kSegVecs;
    const int gr = 2 * p0 - 1 + r, off = seg0 + 16 * j;
    const unsigned char* row = xb + gr * row_bytes;
    const bool in_row = i < kHaloVecs && gr >= 0 && gr < H2;
    h.v[it] = make_uint4(0u, 0u, 0u, 0u);
    h.next[it] = 0;
    if (in_row && off >= 0 && off + 16 <= row_bytes)
      h.v[it] = __ldg(reinterpret_cast<const uint4*>(row + off));
    if (in_row && j + 1 < kSegVecs && off + 16 >= 0 &&
        off + 32 <= row_bytes)
      h.next[it] = __ldg(reinterpret_cast<const uint32_t*>(row + off + 16));
  }
}

// copy 0 as loaded, copy 1 the same bytes 2 earlier
__device__ __forceinline__ void halo_store(const Halo& h, unsigned char* s_x) {
#pragma unroll
  for (int it = 0; it < kVecIters; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    if (i >= kHaloVecs) break;
    const int r = i / kSegVecs, j = i - r * kSegVecs;
    const uint4 v = h.v[it];
    *reinterpret_cast<uint4*>(s_x + r * kPitch + 16 * j) = v;
    *reinterpret_cast<uint4*>(s_x + kHaloBytes + r * kPitch + 16 * j) =
        make_uint4(__funnelshift_r(v.x, v.y, 16),
                   __funnelshift_r(v.y, v.z, 16),
                   __funnelshift_r(v.z, v.w, 16),
                   __funnelshift_r(v.w, h.next[it], 16));
  }
}

// any shape: the halo proper (columns 2 q0 - 1 .. 2 q0 + 64) as 16-bit
// loads, into both copies
__device__ __forceinline__ void halo_fill_scalar(unsigned char* s_x,
                                                 const uint16_t* xs, int p0,
                                                 int q0, int H2, int W2) {
  constexpr int kVals = (2 * kMmaCols + 2) * kCin;
  for (int i = threadIdx.x; i < kMmaRows * kVals; i += kMmaThreads) {
    const int r = i / kVals, rem = i - r * kVals;
    const int col = rem / kCin, ch = rem - col * kCin;
    const int gr = 2 * p0 - 1 + r, gc = 2 * q0 - 1 + col;
    uint16_t v = 0;
    if (gr >= 0 && gr < H2 && gc >= 0 && gc < W2)
      v = xs[(int64_t(gr) * W2 + gc) * kCin + ch];
    const int at = r * kPitch + ((col + kLeft) * kCin + ch) * 2;
    *reinterpret_cast<uint16_t*>(s_x + at) = v;
    *reinterpret_cast<uint16_t*>(s_x + kHaloBytes + at - 2) = v;
  }
}

// Block (x, y, b): pooled columns 32 x .. 32 x + 31 of image b, row tiles
// kTilesPerBlock y .. (8 pooled rows each), one after the other; with
// 16-byte loads the next tile's halo is in flight during a tile's
// products.  3 blocks (24 warps) an SM: faster than the 2 that 96
// registers, ptxas's choice without the bound, leave room for.
__global__ void __launch_bounds__(kMmaThreads, 3)
input_stage_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H2, int W2,
                       float slope, bool vec) {
  // the halo twice: copy 0 as the image lays it out, copy 1 (from byte
  // kHaloBytes) the same bytes 2 earlier, so that every pair of bf16
  // values at an even pixel column is one aligned 32-bit word of copy 0
  // and at an odd one of copy 1
  __shared__ __align__(16) unsigned char s_x[2 * kHaloBytes];
  __shared__ __align__(16) unsigned char s_o[kMmaWarps][kMmaCols *
                                                         kPixBytes];
  // every lane's B fragments, 16 words, as 4 groups of 4: word 4 q + e
  // of lane l at s_w[q][l][e]
  __shared__ __align__(16) uint32_t s_w[4][32][4];
  __shared__ float s_b[kCout];

  const int Ho = H2 / 2, Wo = W2 / 2;
  const int q0 = blockIdx.x * kMmaCols, b = blockIdx.z;
  const int tile0 = blockIdx.y * kTilesPerBlock;
  const int n_tiles = min(kTilesPerBlock,
                          (Ho + kMmaWarps - 1) / kMmaWarps - tile0);
  const int tid = threadIdx.x;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x) +
                            int64_t(b) * H2 * W2 * kCin * 2;
  const int64_t row_bytes = int64_t(W2) * kCin * 2;

  Halo h;
  if (vec) halo_load(h, xb, tile0 * kMmaWarps, q0, H2, row_bytes);
  // B fragment word f of lane l: k-step f / 8, n-tile f / 2 % 4, half
  // f % 2 (b0 or b1); column n = 8 nt + l / 4, rows k, k + 1
  for (int i = tid; i < 4 * 32 * 4; i += kMmaThreads) {
    const int q = i / 128, l = i / 4 % 32, f = 4 * q + i % 4;
    const int k = 16 * (f / 8) + 2 * (l % 4) + 8 * (f % 2);
    const int n = 8 * (f / 2 % 4) + l / 4;
    s_w[q][l][i % 4] = pack_bf16(weight(w, k, n), weight(w, k + 1, n));
  }
  if (tid < kCout) s_b[tid] = bias[tid];
  if (vec)
    halo_store(h, s_x);
  else
    halo_fill_scalar(s_x, reinterpret_cast<const uint16_t*>(xb),
                     tile0 * kMmaWarps, q0, H2, W2);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // M row 8 di + 2 wp + dj holds phase (di, dj) of the tile's pooled
  // pixel wp: this lane has rows g and g + 8, pixel g >> 1, column
  // phase dj = g & 1 and both row phases; its partner lane ^ 4 has the
  // other column phase
  const int dj = g & 1;

  // B fragments: k-step s, n-tile nt, b0 and b1
  uint32_t bw[2][4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(s_w[q][lane]);
    bw[q / 2][2 * (q % 2)][0] = v.x;
    bw[q / 2][2 * (q % 2)][1] = v.y;
    bw[q / 2][2 * (q % 2) + 1][0] = v.z;
    bw[q / 2][2 * (q % 2) + 1][1] = v.w;
  }
  // after the pool exchange a lane keeps n-tiles 2 dj and 2 dj + 1,
  // channels 2 t and 2 t + 1 of each
  float bj[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bj[j][e] = s_b[8 * (2 * dj + j) + 2 * t + e];

  // the lane's 4 pairs of K columns, pair m = 8 s + 4 h + t for k-step
  // s and half h: window row m / 5, values 2 (m % 5) and +1 of it; the
  // word's byte offset in s_x (copy 0 at column phase 1, else copy 1)
  // at m-tile 0, row phase 0
  const int col0 = 2 * (g >> 1) + dj + kLeft;  // shared column, tap v 0
  const int copy = dj ? 0 : kHaloBytes - 2;
  int tap[4];
  uint32_t keep[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 8 * (i >> 1) + 4 * (i & 1) + t;
    const int u = m < 3 * kPairsPerRow ? m / kPairsPerRow : 0;
    tap[i] = copy + (2 * warp + u) * kPitch + col0 * kCin * 2 +
             4 * (m % kPairsPerRow);
    keep[i] = m >= 3 * kPairsPerRow ? 0u
              : m % kPairsPerRow == kPairsPerRow - 1 ? 0xffffu : 0xffffffffu;
  }
  unsigned char* stage = s_o[warp];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int p0 = (tile0 + tile) * kMmaWarps, p = p0 + warp;
    const bool more = tile + 1 < n_tiles;
    if (vec && more) halo_load(h, xb, p0 + kMmaWarps, q0, H2, row_bytes);

    if (p < Ho) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // A: rows g (di 0) and g + 8 (di 1), one full-res row apart
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int di = 0; di < 2; ++di) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                s_x + tap[i] + mt * 8 * kCin * 2 + di * kPitch);
            // pairs 0..3 (i = 0) are whole taps on every lane
            a[i >> 1][2 * (i & 1) + di] = i == 0 ? v : v & keep[i];
          }

        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          mma_bf16_m16n8k16(acc[nt], a[0], bw[0][nt][0], bw[0][nt][1]);
          mma_bf16_m16n8k16(acc[nt], a[1], bw[1][nt][0], bw[1][nt][1]);
        }

        // row phase within the lane, column phase with lane ^ 4; the
        // lane keeps n-tiles 2 dj + j and sends its partner the others
        const int pix = 4 * mt + (g >> 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lo = fmaxf(acc[j][e], acc[j][2 + e]);
            const float hi = fmaxf(acc[j + 2][e], acc[j + 2][2 + e]);
            const float mine = dj ? hi : lo, send = dj ? lo : hi;
            const float m =
                fmaxf(mine, __shfl_xor_sync(0xffffffffu, send, 4));
            r[e] = cyt::leaky(m + bj[j][e], slope);
          }
          // 16-byte chunk 2 dj + j of the pixel, swizzled by bit 1 of
          // the pixel: the 32 lanes' words fall in 32 banks
          const int chunk = (2 * dj + j) ^ ((pix >> 1) & 1);
          *reinterpret_cast<uint32_t*>(stage + pix * kPixBytes +
                                       chunk * 16 + 4 * t) =
              pack_bf16(r[0], r[1]);
        }
      }
      __syncwarp();

      // the warp's 32 pooled pixels, contiguous in NHWC: 128 chunks of
      // 16 bytes
      __nv_bfloat16* orow = out + (int64_t(b) * Ho + p) * Wo * kCout;
#pragma unroll
      for (int i = lane; i < kMmaCols * 4; i += 32) {
        const int pix = i >> 2, c = i & 3;
        if (q0 + pix >= Wo) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + pix * kPixBytes + (c ^ ((pix >> 1) & 1)) * 16);
        *reinterpret_cast<uint4*>(orow + (q0 + pix) * kCout + 8 * c) = v;
      }
    }
    if (!more) break;
    __syncthreads();  // every warp is done with this tile's halo and stage
    if (vec)
      halo_store(h, s_x);
    else
      halo_fill_scalar(s_x, reinterpret_cast<const uint16_t*>(xb),
                       p0 + kMmaWarps, q0, H2, W2);
    __syncthreads();
  }
}

void launch_f32(const void* x, const float* w, const float* b, void* out,
                int B, int H2, int W2, float slope, cudaStream_t stream) {
  const int Ho = H2 / 2, Wo = W2 / 2;
  dim3 grid((Wo + kTileCols - 1) / kTileCols,
            (Ho + kTileRows - 1) / kTileRows, B);
  input_stage_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), w, b, static_cast<float*>(out), H2, W2,
      slope);
}

void launch_bf16(const void* x, const float* w, const float* b, void* out,
                 int B, int H2, int W2, float slope, cudaStream_t stream) {
  const int Ho = H2 / 2, Wo = W2 / 2;
  const int row_tiles = (Ho + kMmaWarps - 1) / kMmaWarps;
  dim3 grid((Wo + kMmaCols - 1) / kMmaCols,
            (row_tiles + kTilesPerBlock - 1) / kTilesPerBlock, B);
  input_stage_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, b,
      static_cast<__nv_bfloat16*>(out), H2, W2, slope,
      W2 % 8 == 0 && cyt::aligned16(x));
}

}  // namespace

// x: [B, H2, W2, 3] contiguous, H2 and W2 even; w: [3, 3, 3, 32] f32
// (HWIO); b: [32] f32; out: [B, H2/2, W2/2, 32] in x's type, 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cyt_input_stage(const void* x, const void* w, const void* b,
                               void* out, int64_t B, int64_t H2, int64_t W2,
                               float slope, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H2 <= 0 || W2 <= 0 || H2 % 2 || W2 % 2 ||
      H2 * W2 * kCout >= (int64_t(1) << 31) || !cyt::aligned16(out) ||
      !cyt::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == cyt::kFloat32)
    launch_f32(x, wf, bf, out, int(B), int(H2), int(W2), slope, s);
  else if (dtype == cyt::kBFloat16)
    launch_bf16(x, wf, bf, out, int(B), int(H2), int(W2), slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
