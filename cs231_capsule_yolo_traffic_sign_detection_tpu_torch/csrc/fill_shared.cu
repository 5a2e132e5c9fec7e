// A test aid, not a kernel of any path: fills the shared memory of every
// SM with one value.  Shared memory keeps what the last kernel left in
// it, so a kernel that reads a slot it never wrote gives a result that
// depends on what ran before it.  Filled with NaN just before a kernel,
// such a read shows up as a wrong result every time (chip_smoke.py
// phases 7 and 10, tests/test_torch_port_cuda.py).

#include "common.cuh"

namespace {

__global__ void fill_shared_kernel(float value, int floats) {
  extern __shared__ float smem[];
  volatile float* s = smem;  // stores that nothing here reads back
  for (int i = threadIdx.x; i < floats; i += blockDim.x) s[i] = value;
}

}  // namespace

// Fills the card's opt-in shared memory per block, on every SM, with
// `value`, on `stream`.  Returns the launch's error, or 0.
extern "C" int cyt_fill_shared(float value, void* stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fill_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block fits an SM; a few rounds of them reach every SM whatever
  // order the scheduler takes
  fill_shared_kernel<<<4 * sms, 1024, optin,
                       static_cast<cudaStream_t>(stream)>>>(
      value, optin / int(sizeof(float)));
  return static_cast<int>(cudaGetLastError());
}
