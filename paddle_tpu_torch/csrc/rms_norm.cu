// RMSNorm of rows for Hopper (sm_90a) — K8.
//
// Replaces the TPU kernel paddle_tpu/ops/rms_norm.py::_rms_norm_pallas
// (pallas_call at :66): y = bf16/fp32(x * rsqrt(mean(x^2) + eps)), then
// times the optional weight in x's type, for every row of a (n, d) input in
// bf16 or fp32. The sum of squares is fp32. The rounding is the plain
// version's (ops/rms_norm.py: normalise in fp32, cast to x's type, multiply
// by the weight in that type).
//
// What bounds it on the H100: bytes. It reads each input byte once and
// writes each output byte once (the weight is d elements, read from L1/L2)
// and does a few operations per element, far below the ~295 FLOP/byte
// ridge. The design: one warp per row, 16-byte loads (8 bf16 or 4 fp32 a
// lane, neighbouring lanes on neighbouring addresses), four loads in flight
// a lane, the sum of squares reduced by shuffles; a second pass over the row
// (from L1/L2, the row was just read), four loads in flight again, scales
// and stores with 16-byte stores. Eight rows a block. Like the TPU kernel
// it is off the default path: ops.rms_norm() stays the plain version, and
// this is timed beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int UNROLL = 4;  // 16-byte loads in flight a lane

__device__ __forceinline__ void to_f(const uint4& u, const bf16*, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_f(const uint4& u, const float*, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// round to T and back: the plain version's cast to x's dtype
__device__ __forceinline__ float rnd(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float rnd(float v, const float*) { return v; }

__device__ __forceinline__ uint4 from_f(const float* f, const bf16*) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 from_f(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <class T, bool HAS_W>
__global__ void __launch_bounds__(WARPS * 32)
rms_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, long n, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const int nv = d / V;
  const T* tag = nullptr;

  float ss = 0.f;
  for (int i0 = lane; i0 < nv; i0 += 32 * UNROLL) {
    uint4 u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * 32;
      u[k] = i < nv ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      float f[V];
      to_f(u[k], tag, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffff, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int i0 = lane; i0 < nv; i0 += 32 * UNROLL) {
    uint4 u[UNROLL], wu[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * 32;
      if (i < nv) {
        u[k] = __ldg(xr + i);
        if (HAS_W) wu[k] = __ldg(wr + i);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * 32;
      if (i >= nv) break;
      float f[V], wf[V];
      to_f(u[k], tag, f);
      if (HAS_W) to_f(wu[k], tag, wf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = rnd(f[j] * r, tag);
        if (HAS_W) f[j] = rnd(f[j] * wf[j], tag);
      }
      yr[i] = from_f(f, tag);
    }
  }
}

template <class T>
cudaError_t launch(const void* x, const void* w, void* y, long n, int d,
                   float eps, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  if (w != nullptr)
    rms_norm_rows_kernel<T, true><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)x, (const T*)w, (T*)y, n, d, eps);
  else
    rms_norm_rows_kernel<T, false><<<blocks, WARPS * 32, 0, st>>>(
        (const T*)x, nullptr, (T*)y, n, d, eps);
  return cudaGetLastError();
}

}  // namespace

// K8 — y (n, d) = RMSNorm of the n rows of x (n, d), times w (d,) when w is
// not null. fp32 = 1 for fp32 rows, 0 for bf16. x, w and y 16-byte aligned,
// d a multiple of 8 (bf16) or 4 (fp32). Returns the launch's CUDA error.
extern "C" int rms_norm_rows(const void* x, const void* w, void* y, long n,
                             int d, int fp32, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(fp32 ? launch<float>(x, w, y, n, d, eps, st)
                    : launch<bf16>(x, w, y, n, d, eps, st));
}
