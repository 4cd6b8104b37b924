// Hidden dropout for Hopper (sm_90a): y = keep(i) ? x / keep : 0 over a
// contiguous tensor, in its dtype (fp32 or bf16).
//
// Replaces no TPU kernel: the JAX package computes this dropout in XLA
// (paddle_tpu/nn/functional.py:105-115, jax.random.bernoulli and a
// where), outside any Pallas kernel. The port gives it a kernel of its own
// because its plain version is about a hundred eager int64 passes over the
// tensor per call (the threefry rounds), and GPT-2's training step calls it
// 49 times forward and 49 times backward on (8, 1024, 1024) activations.
//
// The mask is the reference's bit for bit (csrc/threefry.cuh): element i
// is kept iff (bits(i) >> 9) < thr. A kept element is x / div, divided in
// fp32 with IEEE rounding and rounded to the output dtype to nearest: the
// reference's `x / keep` with keep taken in x's dtype (a bf16 keep for a
// bf16 x), which XLA's CPU backend computes the same way; div = 1 gives
// the downscale_in_infer mode's training form (no scaling). The backward
// is this kernel again on the gradient, with the same key.
//
// What bounds it on the H100: the integer instructions of the hash (about
// 70 an element, csrc/threefry.cuh) against the SMs' issue rate (128
// thread-instructions a clock an SM), well above the bytes (x read once,
// y written once: 4 bytes an element in bf16). Each thread takes 16 bytes (8 bf16 or 4 fp32 elements) with one
// vector load and one vector store, and hashes them; a grid-stride loop
// over blocks of 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T drop_one(T x, uint64_t i, const tf::Drop& d,
                                      float div) {
  return tf::keep(d, i) ? from_f<T>(__fdiv_rn(to_f(x), div)) : from_f<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               tf::Drop d, float div) {
  constexpr int V = 16 / sizeof(T);   // elements of one 16-byte access
  const long long stride = (long long)gridDim.x * THREADS * V;
  for (long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
       i0 < n; i0 += stride) {
    if (i0 + V <= n) {
      alignas(16) T t[V];
      *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
      for (int v = 0; v < V; ++v)
        t[v] = drop_one(t[v], (uint64_t)(i0 + v), d, div);
      *reinterpret_cast<uint4*>(y + i0) = *reinterpret_cast<const uint4*>(t);
    } else {
      for (long long i = i0; i < n; ++i)
        y[i] = drop_one(x[i], (uint64_t)i, d, div);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, tf::Drop d, float div,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  long long blocks = (n + (long long)THREADS * V - 1) / ((long long)THREADS * V);
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<(int)blocks, THREADS, 0, st>>>(
      (const T*)x, (T*)y, n, d, div);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16. x and y contiguous and 16-byte aligned.
extern "C" int dropout_fwd(const void* x, void* y, long long n, int dtype,
                           unsigned k1, unsigned k2, unsigned thr, float div,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const tf::Drop d{k1, k2, thr, 1.f};
  if (n <= 0) return 0;
  if (dtype == 0) return launch<float>(x, y, n, d, div, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, d, div, st);
  return (int)cudaErrorInvalidValue;
}
