// Shared-memory probe for Hopper (sm_90a) — K9.
//
// Replaces the TPU kernel paddle_tpu/ops/vmem_probe.py::_fits (pallas_call
// at :47), which the reference's probe_usable_vmem_mib (:63) bisects to
// find the largest VMEM scratch Mosaic compiles and runs: a TPU runtime
// exposes no VMEM attribute. A CUDA device does expose its budget (the
// shared memory a block may opt in to), so the Hopper form needs no
// bisection: ops/smem_probe.py reads the attribute and makes one launch of
// this kernel at that size, then one at a 1 KB step above, which must be
// refused. The kernel opts in to `nbytes` of dynamic shared memory, writes
// its first and last 16-byte rows and reads them back into `out`, so the
// allocation cannot be elided and a launch that did not run shows.
//
// What bounds it: launch latency (32 bytes out); it runs once per device.

#include <cuda_runtime.h>

namespace {

__global__ void smem_probe_kernel(float4* __restrict__ out, int rows) {
  extern __shared__ float4 sm[];
  if (threadIdx.x == 0) {
    sm[0] = make_float4(1.f, 2.f, 3.f, (float)rows);
    sm[rows - 1] = make_float4(5.f, 6.f, 7.f, (float)rows);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = sm[0];
    out[1] = sm[rows - 1];
  }
}

}  // namespace

// The device's opt-in shared memory per block, in bytes (-1 on error).
extern "C" int smem_optin_bytes(int device) {
  int v = -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return v;
}

// One launch with `nbytes` (a multiple of 16) of dynamic shared memory,
// writing out[0] = (1, 2, 3, rows) and out[1] = (5, 6, 7, rows), rows =
// nbytes / 16. Returns the opt-in's or the launch's CUDA error (0: the
// launch was accepted; a refused one never runs) and clears it, so a later
// launch's error check does not see it.
extern "C" int smem_probe(void* out, int nbytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  smem_probe_kernel<<<1, 32, nbytes, (cudaStream_t)stream>>>((float4*)out,
                                                            nbytes / 16);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}
