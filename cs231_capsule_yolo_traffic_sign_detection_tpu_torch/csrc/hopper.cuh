// Building blocks shared by the routing kernels (K3, K4) on Hopper
// (sm_90): mbarriers in shared memory, bulk copies from global memory
// (TMA without a tensor map), alone or multicast to every CTA of a
// thread-block cluster, ldmatrix and bf16 mma.sync, warp reduce-scatters
// and the softmax over the capsules.  The PTX is inline, in the forms
// CUTLASS's cute/arch headers issue.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cyt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy and to
// the other CTAs of the cluster (a cluster sync follows)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` more of transaction on the
// barrier's current phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    // a copy that never lands (a fault) ends the kernel with an error
    // after some 10 s instead of hanging the card
    if (clock64() - start > (10LL << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global memory to the same shared-memory offset in every CTA of
// `cta_mask`; each destination CTA's barrier at `bar`'s offset counts
// the bytes it receives
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(cta_mask)
      : "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global memory to this CTA's shared memory; the barrier counts them
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four 8x8 matrices of 16-bit values from shared memory, transposed:
// lanes 8m ... 8m + 7 give the addresses of matrix m's 8 rows (16 bytes
// each); r[m] receives lane l's share of matrix m, the elements (2 (l %
// 4), l / 4) and (2 (l % 4) + 1, l / 4) as (row, column): the B operand
// of mma.m16n8k8 for a matrix stored k-major.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d = A B + 0 on the tensor cores, bf16 operands, f32 products and sums:
// A 16 x 8 (a0: row l / 4, a1: row l / 4 + 8, columns 2 (l % 4) and +1),
// B 8 x 8 (b0 from ldmatrix_x4_trans), d 16 x 8 (d0, d1: row l / 4,
// d2, d3: row l / 4 + 8; columns 2 (l % 4) and +1).  Products of bf16
// values are exact in f32.
__device__ __forceinline__ void mma_bf16_m16n8k8(float (&d)[4], uint32_t a0,
                                                 uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

// One step of a reduce-scatter over the lanes h ^ kOff of an aligned
// group of 8: each lane keeps half of its 2 kHalf partial sums, sends
// the other half to its partner and adds what the partner sent.
template <int kHalf, int kOff>
__device__ __forceinline__ void butterfly_step(float* l, int h) {
  const bool upper = h & kOff;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? l[j] : l[j + kHalf];
    const float keep = upper ? l[j + kHalf] : l[j];
    l[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// Sum kN values (a multiple of 8) over the 8 lanes h = lane % 8: lane h
// ends with the full sums of entries h kN/8 ... h kN/8 + kN/8 - 1 in
// l[0 .. kN/8).  7 kN / 8 shuffles.
template <int kN>
__device__ __forceinline__ void reduce_scatter8(float* l, int h) {
  static_assert(kN % 8 == 0, "8 lanes share the entries");
  butterfly_step<kN / 2, 4>(l, h);
  butterfly_step<kN / 4, 2>(l, h);
  butterfly_step<kN / 8, 1>(l, h);
}

// In place over `rows` rows of K <= 48 values in shared memory: the
// softmax over K (f32, max subtracted, IEEE expf and division), 8 lanes
// per row and all rows at once, each lane's 6 values held in registers.
// With `pbar` (rows of K values beside them), also dot[r] = sum_k
// probs pbar.  blockDim.x is a multiple of 32 and `rows` of 4, so the 4
// octets of a warp take the same number of rows and every shuffle has
// all lanes.
__device__ __forceinline__ void softmax_rows(float* lg, int rows, int K,
                                             const float* pbar = nullptr,
                                             float* dot = nullptr) {
  constexpr int kPer = 6;  // values per lane: 8 x 6 = 48 capsules
  for (int r = threadIdx.x / 8; r < rows; r += blockDim.x / 8) {
    float* row = lg + r * K;
    const int q = threadIdx.x % 8;
    float v[kPer];
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = q + 8 * j < K ? row[q + 8 * j] : m;
      m = fmaxf(m, v[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, 8));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = q + 8 * j < K ? expf(v[j] - m) : 0.f;
      sum += v[j];
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off, 8);
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (q + 8 * j >= K) continue;
      const float prob = v[j] / sum;
      row[q + 8 * j] = prob;
      if (pbar != nullptr) d = fmaf(prob, pbar[r * K + q + 8 * j], d);
    }
    if (pbar != nullptr) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off, 8);
      if (q == 0) dot[r] = d;
    }
  }
}

}  // namespace cyt
