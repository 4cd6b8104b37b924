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
// writes each output byte once (the weight is d elements, read through L1)
// and does a few operations per element, far below the ~295 FLOP/byte
// ridge. Two kernels, one warp per row and 16-byte accesses (8 bf16 or 4
// fp32 a lane, neighbouring lanes on neighbouring addresses) in both; the
// wrapper picks by width:
//  * one pass (rows up to ONE_PASS_LOADS · 32 · 16 bytes: d <= 4096 bf16,
//    2048 fp32): each lane loads its whole share of the row into registers
//    (N 16-byte loads, all in flight, N the next power of two of the row's
//    loads per lane), the sum of squares is reduced by shuffles, and the
//    lane scales and stores from the same registers. The row's bytes come
//    from device memory once and from nowhere a second time. Sixteen rows
//    a block (the fastest of 2, 4, 8 and 16 in a development sweep on the
//    H100).
//  * two passes (wider rows): the sum of squares with four loads in flight
//    a lane, then a second pass over the row (from L1/L2, the row was just
//    read) that scales and stores. Eight rows a block.
// Like the TPU kernel it is off the default path: ops.rms_norm() stays the
// plain version, and this is timed beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;           // two passes: rows per block
constexpr int UNROLL = 4;          // two passes: 16-byte loads in flight a lane
constexpr int WARPS1 = 16;         // one pass: rows per block
constexpr int ONE_PASS_LOADS = 16; // one pass: most 16-byte loads a lane

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

// two passes: any width
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

// one pass: the row in registers, N 16-byte loads a lane (load i of the
// row is lane i % 32's load i / 32)
template <class T, bool HAS_W, int N>
__global__ void __launch_bounds__(WARPS1 * 32)
rms_norm_rows_1pass(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, long n, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS1 + (threadIdx.x >> 5);
  if (row >= n) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const int nv = d / V;
  const T* tag = nullptr;

  uint4 u[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    u[k] = i < nv ? __ldcs(xr + i) : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float f[V];
    to_f(u[k], tag, f);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffff, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    if (i < nv) {
      float f[V], wf[V];
      to_f(u[k], tag, f);
      if (HAS_W) to_f(__ldg(wr + i), tag, wf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = rnd(f[j] * r, tag);
        if (HAS_W) f[j] = rnd(f[j] * wf[j], tag);
      }
      __stcs(yr + i, from_f(f, tag));
    }
  }
}

template <class T, bool HAS_W>
cudaError_t launch_rows(const T* x, const T* w, T* y, long n, int d,
                        float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (d / V + 31) / 32;   // 16-byte loads a lane
  const unsigned b1 = (unsigned)((n + WARPS1 - 1) / WARPS1);
  if (per_lane <= 1)
    rms_norm_rows_1pass<T, HAS_W, 1><<<b1, WARPS1 * 32, 0, st>>>(x, w, y, n, d, eps);
  else if (per_lane <= 2)
    rms_norm_rows_1pass<T, HAS_W, 2><<<b1, WARPS1 * 32, 0, st>>>(x, w, y, n, d, eps);
  else if (per_lane <= 4)
    rms_norm_rows_1pass<T, HAS_W, 4><<<b1, WARPS1 * 32, 0, st>>>(x, w, y, n, d, eps);
  else if (per_lane <= 8)
    rms_norm_rows_1pass<T, HAS_W, 8><<<b1, WARPS1 * 32, 0, st>>>(x, w, y, n, d, eps);
  else if (per_lane <= ONE_PASS_LOADS)
    rms_norm_rows_1pass<T, HAS_W, ONE_PASS_LOADS>
        <<<b1, WARPS1 * 32, 0, st>>>(x, w, y, n, d, eps);
  else
    rms_norm_rows_kernel<T, HAS_W>
        <<<(unsigned)((n + WARPS - 1) / WARPS), WARPS * 32, 0, st>>>(
            x, w, y, n, d, eps);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch(const void* x, const void* w, void* y, long n, int d,
                   float eps, cudaStream_t st) {
  if (w != nullptr)
    return launch_rows<T, true>((const T*)x, (const T*)w, (T*)y, n, d, eps,
                                st);
  return launch_rows<T, false>((const T*)x, nullptr, (T*)y, n, d, eps, st);
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
