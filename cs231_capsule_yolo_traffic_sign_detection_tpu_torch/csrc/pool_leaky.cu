// K1: fused 2x2 max-pool + LeakyReLU over NHWC, for sm_90a.
//
// Replaces the TPU kernel ops/pool_pallas.py:maxpool2_leaky
// (_pool_leaky_kernel): out = leaky(max over each 2x2 window), which
// equals max_pool(leaky(x)) because leaky is monotone.  One read of the
// conv output, one write of the pooled tensor.
//
// Bound on the H100: memory.  Each output element costs 3 comparisons
// and at most one multiply for 5 values moved, far below the card's
// ~20 operations per byte, so the least time is (read B*H*W*C + write a
// quarter of that) over 3.35 TB/s.  No tensor cores.
//
// Design: one thread per output pixel and VEC channels.  C is the
// innermost axis, so neighbouring threads read neighbouring 16-byte
// packs (4 f32 or 8 bf16) of each window row: every load is coalesced
// and each input byte is read once.  blockIdx.y walks the (image,
// pooled row) pairs so a thread does one 32-bit division.  Comparisons
// run in f32 with torch's NaN rule (a NaN in the window wins), the
// leaky slope is torch's (x > 0 ? x : x * slope), and the result is
// rounded once to the storage type: the f32 output is bit-exact with
// leaky_relu(max_pool2d(x)).  A scalar variant (VEC = 1) takes
// channel counts or pointers that do not allow 16-byte packs.

#include "common.cuh"

namespace {

using cyt::Pack;

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

template <typename T, int VEC>
__global__ void pool_leaky_kernel(const T* __restrict__ x,
                                  T* __restrict__ out, int rows, int H,
                                  int W, int C, float slope) {
  const int Ho = H / 2, Wo = W / 2, Cv = C / VEC;
  const unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= static_cast<unsigned>(Wo * Cv)) return;
  const int wo = j / Cv;
  const int c = (j - wo * Cv) * VEC;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / Ho, ho = row - b * Ho;
    const int64_t top = ((int64_t(b) * H + 2 * ho) * W + 2 * wo) * C + c;
    const int64_t bot = top + int64_t(W) * C;
    using P = Pack<T, VEC>;
    const P a0 = *reinterpret_cast<const P*>(x + top);
    const P a1 = *reinterpret_cast<const P*>(x + top + C);
    const P a2 = *reinterpret_cast<const P*>(x + bot);
    const P a3 = *reinterpret_cast<const P*>(x + bot + C);
    P r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float m = cyt::to_f(a0.v[k]);
      m = max_nan(m, cyt::to_f(a1.v[k]));
      m = max_nan(m, cyt::to_f(a2.v[k]));
      m = max_nan(m, cyt::to_f(a3.v[k]));
      r.v[k] = cyt::from_f<T>(cyt::leaky(m, slope));
    }
    const int64_t o = ((int64_t(b) * Ho + ho) * Wo + wo) * C + c;
    *reinterpret_cast<P*>(out + o) = r;
  }
}

template <typename T, int VEC>
void launch(const void* x, void* out, int B, int H, int W, int C,
            float slope, cudaStream_t stream) {
  const int threads = 256;
  const int rows = B * (H / 2);
  const int per_row = (W / 2) * (C / VEC);
  dim3 grid((per_row + threads - 1) / threads, rows < 65535 ? rows : 65535);
  pool_leaky_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, H, W, C, slope);
}

}  // namespace

// x: [B, H, W, C] contiguous, H and W even; out: [B, H/2, W/2, C].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cyt_pool_leaky(const void* x, void* out, int64_t B,
                              int64_t H, int64_t W, int64_t C, float slope,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 ||
      B * H * W * C >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool packs = cyt::aligned16(x) && cyt::aligned16(out);
  const int b = int(B), h = int(H), w = int(W), c = int(C);
  if (dtype == cyt::kFloat32) {
    if (packs && c % 4 == 0)
      launch<float, 4>(x, out, b, h, w, c, slope, s);
    else
      launch<float, 1>(x, out, b, h, w, c, slope, s);
  } else if (dtype == cyt::kBFloat16) {
    if (packs && c % 8 == 0)
      launch<__nv_bfloat16, 8>(x, out, b, h, w, c, slope, s);
    else
      launch<__nv_bfloat16, 1>(x, out, b, h, w, c, slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
