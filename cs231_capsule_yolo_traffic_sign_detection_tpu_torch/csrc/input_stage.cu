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
// pooled [B, H/2, W/2, 32] tensor is written.
//
// Bound on the H100: operations.  Per 128 images at 448 px the work is
// 44 GFLOP (128 * 448^2 * 32 * 27 * 2) against 1.13 GB of traffic (f32
// input read plus pooled output write): 0.66 ms on the f32 CUDA cores
// (67 TFLOP/s) against 0.34 ms at 3.35 TB/s.  Tensor cores (mma/wgmma
// over a 27->32 product padded to their tile) are later work.
//
// Design: a block of 256 threads owns a tile of 2 pooled rows x 32
// pooled columns x all 32 channels.  It stages the tile's input halo
// (6 x 66 pixels x 3 channels, zero outside the image: the conv's
// padding) and the 864 weights in shared memory.  Warp w takes pooled
// row w / 4 and output channels 8 * (w % 4) .. +7; its lane is the
// pooled column.  Each thread keeps its 4x4x3 input patch in registers
// and 4 phases x 8 channels of f32 accumulators; all lanes of a warp
// read the same weights, so shared-memory weight loads are broadcasts.
// Inputs may be f32 or bf16 (the f32 weights hold whatever rounding the
// caller chose); accumulation is f32; the output is rounded once to the
// input's type and stored as 16-byte packs.

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

template <typename T>
void launch(const void* x, const float* w, const float* b, void* out,
            int B, int H2, int W2, float slope, cudaStream_t stream) {
  const int Ho = H2 / 2, Wo = W2 / 2;
  dim3 grid((Wo + kTileCols - 1) / kTileCols,
            (Ho + kTileRows - 1) / kTileRows, B);
  input_stage_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), H2, W2, slope);
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
    launch<float>(x, wf, bf, out, int(B), int(H2), int(W2), slope, s);
  else if (dtype == cyt::kBFloat16)
    launch<__nv_bfloat16>(x, wf, bf, out, int(B), int(H2), int(W2), slope, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
