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
// f32 (input_stage_tf32x3_kernel), bound on the H100: bytes.  At batch
// 32 and 448 px it moves 77.1 MB of f32 frames in and 205.5 MB of pooled
// f32 out: 0.0844 ms at 3.35 TB/s.  The conv is 11.1 GFLOP (32 * 448^2 *
// 32 * 27 * 2): 0.166 ms on the f32 CUDA cores (67 TFLOP/s), where the
// first kernel, scalar FMAs, took 0.42 ms.  So the products run on the
// TF32 tensor cores as a split-precision ("3xTF32") product that keeps
// the f32 band: each operand a is split into hi = tf32(a) (rounded to
// nearest, ties away, as cvt.rna) and lo = tf32(a - hi) (a - hi is
// exact in f32), and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small products first, into
// one f32 accumulator.  The term dropped, a_lo b_lo, and the rounding of
// lo are each about 2^-22 of |a b|: inside the band of rtol and atol
// 1e-5 against the plain version (one-pass TF32, about 2^-11, is not).
// Raw 0-255 pixels, as the serving path feeds them, are exact in TF32,
// so x_lo = 0 there and only the weights' split rounds.  The three
// products are 3 x 11.1 GFLOP: 0.067 ms at TF32's 495 TFLOP/s, under
// the bytes bound.  (cuDNN and cuBLAS keep TF32 off: device.py.)  On an
// H100 SXM at 700 W the kernel takes 0.21 ms (chip_smoke.py phase 6),
// at the pace of its 48 mma.sync a 16 pixels (36 of k 8, 12 of k 4),
// not of its bytes.
//
// Design, on the bf16 kernel's skeleton (below):
// - M is 16 full-resolution pixels per mma.sync m16n8k8 (tf32 operands,
//   f32 accumulation), row 8 di + 2 w + dj phase (di, dj) of pooled
//   pixel w of 4, so the pool stays in registers as in the bf16 kernel.
//   N is the 32 channels (4 n-tiles of 8).  K is the 27 taps in HWIO
//   order (row u of the window: 9 contiguous f32 values in NHWC) as three
//   k-steps of 8 and one m16n8k4 step for taps 24..26 and a zero 28th
//   column: 28 columns, not 32.
// - im2col in registers: in f32 every tap is one aligned 32-bit word, so
//   the bf16 kernel's second, shifted halo copy is not needed; a lane's
//   7 K columns (t + 4 i) are 7 word offsets into the halo, computed
//   once.  Each A value is one shared load, then the split: two integer
//   operations for hi, a subtract, two more for lo.  Only the two
//   k-steps that cross a window row meet 2-way bank conflicts.
// - Registers: the B fragments, hi and lo, are 56 words a lane, loaded
//   and split once a block from w.  With 16 accumulators and one k-step
//   of A at a time the kernel fits in 128 registers (127, no spills,
//   with the m-tile loop unrolled twice): 2 blocks (16 warps) an SM.
//   Capped at 80 registers for 3 blocks it spills and runs slower.
// - Shared memory: the halo of a row tile, 18 rows x 72 pixels (864
//   bytes a row), twice: 31 KB of double buffer, filled by cp.async (16-
//   byte vectors when W2 % 4 == 0 and x is 16-byte aligned, 4-byte
//   words otherwise; zeros outside the image by the copy's source size),
//   the next row tile's halo in flight during a tile's products.  No
//   output stage: after the pool a lane holds 2 adjacent channels in
//   each of 2 groups of 8, so each 8-byte store of a warp fills 8 whole
//   32-byte sectors; the stage that the bf16 kernel needs to fill its
//   sectors would cost 32 KB and two barriers a tile here.
// - Tiling as the bf16 kernel's: a warp owns 1 pooled row x 32 pooled
//   columns (8 m-tiles), a block 8 warps and 4 row tiles one after
//   another; the ragged edge is masked.
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

// ---------------------------------------------------------------- f32

// a halo row in shared memory: full-resolution columns 2 q0 - 4 ..
// 2 q0 + 67 (72 pixels, 216 words: 54 aligned 16-byte vectors); the
// halo proper starts at column 2 q0 - 1, pixel kF32Left of the row
constexpr int kF32Words = (2 * kMmaCols + 8) * kCin;  // 216
constexpr int kF32Vecs = kF32Words / 4;               // 54
constexpr int kF32Left = 3;
constexpr int kF32Halo = kMmaRows * kF32Words;        // words a buffer
constexpr int kF32Taps = 27;

// cvt.rna.tf32.f32 as two integer operations: add half a TF32 ulp to
// the magnitude's bits, clear the 13 bits that TF32 drops (the kernel
// ran faster so than with the cvt instruction, whose lowering is longer)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 2^-22 of |v|: hi = tf32(v), lo = tf32(v - hi)
// (v - hi is exact in f32)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += A B on the tensor cores, TF32 operands, f32 accumulation.
// m16n8k8: A 16 x 8 (a0: row l / 4, a1: row l / 4 + 8, column l % 4;
// a2, a3: the same rows, column + 4), B 8 x 8 (b0: row l % 4, b1: row
// + 4; column l / 4); m16n8k4: a0, a1 and b0 alone.  d as in
// mma_bf16_m16n8k16.
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_m16n8k4(float (&d)[4],
                                                 const uint32_t (&a)[2],
                                                 uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// cp.async of `bytes` (4 or 16) from src to dst, or zeros when !in
template <int bytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Start copying the halo of the row tile at pooled row p0 into buf (one
// cp.async group); zeros outside the image: the conv's padding.  With
// W2 % 4 == 0 the row pitch, the segment's start and the image's edges
// all fall on multiples of 48 bytes, so a 16-byte vector is wholly in or
// out of the image.
__device__ __forceinline__ void halo_copy_f32(float* buf, const float* xb,
                                              int p0, int q0, int H2,
                                              int W2, bool vec) {
  const int64_t row_words = int64_t(W2) * kCin;
  if (vec) {
    const int seg0 = (2 * q0 - 1 - kF32Left) * kCin;
    for (int i = threadIdx.x; i < kMmaRows * kF32Vecs; i += kMmaThreads) {
      const int r = i / kF32Vecs, j = i - r * kF32Vecs;
      const int gr = 2 * p0 - 1 + r, off = seg0 + 4 * j;
      const bool in = gr >= 0 && gr < H2 && off >= 0 && off + 4 <= row_words;
      copy_async<16>(buf + r * kF32Words + 4 * j,
                     in ? xb + gr * row_words + off : xb, in);
    }
  } else {
    // the halo proper, columns 2 q0 - 1 .. 2 q0 + 64, word by word
    constexpr int kVals = (2 * kMmaCols + 2) * kCin;  // 198
    const int w0 = (2 * q0 - 1) * kCin;
    for (int i = threadIdx.x; i < kMmaRows * kVals; i += kMmaThreads) {
      const int r = i / kVals, rem = i - r * kVals;
      const int gr = 2 * p0 - 1 + r, gw = w0 + rem;
      const bool in = gr >= 0 && gr < H2 && gw >= 0 && gw < row_words;
      copy_async<4>(buf + r * kF32Words + kF32Left * kCin + rem,
                    in ? xb + gr * row_words + gw : xb, in);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Block (x, y, b): pooled columns 32 x .. 32 x + 31 of image b, row tiles
// kTilesPerBlock y .. (8 pooled rows each), one after the other, the
// next tile's halo in flight during a tile's products.
__global__ void __launch_bounds__(kMmaThreads, 2)
input_stage_tf32x3_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int H2, int W2,
                          float slope, bool vec) {
  __shared__ __align__(16) float s_x[2][kF32Halo];

  const int Ho = H2 / 2, Wo = W2 / 2;
  const int q0 = blockIdx.x * kMmaCols, b = blockIdx.z;
  const int tile0 = blockIdx.y * kTilesPerBlock;
  const int n_tiles = min(kTilesPerBlock,
                          (Ho + kMmaWarps - 1) / kMmaWarps - tile0);
  const float* xb = x + int64_t(b) * H2 * W2 * kCin;

  // tiles 0 and 1 in flight (an empty group when there is no tile 1)
  halo_copy_f32(s_x[0], xb, tile0 * kMmaWarps, q0, H2, W2, vec);
  if (n_tiles > 1)
    halo_copy_f32(s_x[1], xb, (tile0 + 1) * kMmaWarps, q0, H2, W2, vec);
  else
    asm volatile("cp.async.commit_group;" ::: "memory");

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // M row 8 di + 2 wp + dj holds phase (di, dj) of the tile's pooled
  // pixel wp: this lane has rows g and g + 8, pixel g >> 1, column
  // phase dj = g & 1 and both row phases; its partner lane ^ 4 has the
  // other column phase
  const int dj = g & 1;

  // B fragments, split: K column k is HWIO tap k (w is [27, 32] row-
  // major; K 27 is zero), column n = 8 nt + g; k-steps s of 8 (b0: k =
  // 8 s + t, b1: k + 4) and the m16n8k4 step (k = 24 + t)
  uint32_t bh[3][4][2], bl[3][4][2], bh4[4], bl4[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* wn = w + 8 * nt + g;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split(__ldg(wn + (8 * s + 4 * e + t) * kCout), bh[s][nt][e],
              bl[s][nt][e]);
    split(t < 3 ? __ldg(wn + (24 + t) * kCout) : 0.f, bh4[nt], bl4[nt]);
  }
  // after the pool exchange a lane keeps n-tiles 2 dj and 2 dj + 1,
  // channels 2 t and 2 t + 1 of each
  float bj[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bj[j][e] = __ldg(bias + 8 * (2 * dj + j) + 2 * t + e);

  // the lane's K columns k = t + 4 i: window row u = k / 9, value k % 9
  // of it; word offsets in a halo buffer at m-tile 0, row phase 0 (K 27,
  // lane t = 3's last, reads tap 0's word and is zeroed)
  int tap[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int k = t + 4 * i < kF32Taps ? t + 4 * i : 0;
    tap[i] = (2 * warp + k / 9) * kF32Words + (g + kF32Left) * kCin + k % 9;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int p = (tile0 + tile) * kMmaWarps + warp;
    // this tile's group has landed (the next one may still be in flight)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const float* hx = s_x[tile & 1];

    if (p < Ho) {
      float* orow = out + (int64_t(b) * Ho + p) * Wo * kCout;
#pragma unroll 2
      for (int mt = 0; mt < kMTiles; ++mt) {
        const float* am = hx + mt * 8 * kCin;  // 8 columns an m-tile
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

        // A: rows g (di 0) and g + 8 (di 1), one full-res row apart
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(am[tap[2 * s + (e >> 1)] + (e & 1) * kF32Words], ah[e],
                  al[e]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32_m16n8k8(acc[nt], al, bh[s][nt]);
            mma_tf32_m16n8k8(acc[nt], ah, bl[s][nt]);
            mma_tf32_m16n8k8(acc[nt], ah, bh[s][nt]);
          }
        }
        {
          uint32_t ah[2], al[2];
#pragma unroll
          for (int di = 0; di < 2; ++di)
            split(t < 3 ? am[tap[6] + di * kF32Words] : 0.f, ah[di], al[di]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32_m16n8k4(acc[nt], al, bh4[nt]);
            mma_tf32_m16n8k4(acc[nt], ah, bl4[nt]);
            mma_tf32_m16n8k4(acc[nt], ah, bh4[nt]);
          }
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
          if (q0 + pix < Wo)
            *reinterpret_cast<float2*>(orow + (q0 + pix) * kCout +
                                       8 * (2 * dj + j) + 2 * t) =
                make_float2(r[0], r[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
    // tile + 2 into it (an empty group past the last tile)
    if (tile + 2 < n_tiles)
      halo_copy_f32(s_x[tile & 1], xb, (tile0 + tile + 2) * kMmaWarps, q0,
                    H2, W2, vec);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

void launch_f32(const void* x, const float* w, const float* b, void* out,
                int B, int H2, int W2, float slope, cudaStream_t stream) {
  const int Ho = H2 / 2, Wo = W2 / 2;
  const int row_tiles = (Ho + kMmaWarps - 1) / kMmaWarps;
  dim3 grid((Wo + kMmaCols - 1) / kMmaCols,
            (row_tiles + kTilesPerBlock - 1) / kTilesPerBlock, B);
  input_stage_tf32x3_kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const float*>(x), w, b, static_cast<float*>(out), H2, W2,
      slope, W2 % 4 == 0 && cyt::aligned16(x));
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
