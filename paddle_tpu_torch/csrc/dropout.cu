// Hidden dropout for Hopper (sm_90a): y = keep(i) ? x / keep : 0 over a
// contiguous tensor, in its dtype (fp32 or bf16); and kernel W, the keep
// words of the attention's dropout.
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
//
// Kernel W (keep_words_kernel) replaces no TPU kernel either: the
// reference's Pallas kernels draw their own mask in the kernel
// (_dropout_keep, paddle_tpu/ops/flash_attention.py:426), and the port
// keeps the CPU path's mask, jax.random.bernoulli(key, keep, (b, h, sq,
// sk)) (:139). It hashes that mask once an attention call into packed
// words, (b, h, sq, W) uint32 with W = ceil(sk / 128)·4 (16-byte rows, as
// ops/flash_attention.py `mask_words` packs a bool mask): bit i of word w
// of row (bi, hi, q) is the keep bit of key 32w + i, whose flat index is
// ((bi·h + hi)·sq + q)·sk + k. K1 (csrc/flash_attention.cu) and K4
// (csrc/flash_attention_bwd.cu) stage those words by TMA beside their
// tiles and read bits where they hashed before; K3 still hashes. Only the
// keys the structured limits leave a row (kv_len, the causal limit with
// its offset, the window's lower edge) are hashed; every other bit is 0.
// `everything` hashes every key below sk of every row: the general mode
// (a dense mask, segment ids or ALiBi), where a row a bool mask hides at
// every key takes the uniform softmax over all sk keys, each dropped.
// Bound: the integer instructions of one hash a visible pair, as kernel D.
// Design: a warp owns 32 consecutive words of one row. Its lanes hash the
// 32 keys of one word at a time (a lane a key) and a ballot gives the
// word, which lane i keeps for word i; one coalesced store of the 32 words
// ends the chunk. A word wholly outside the row's limits is skipped by the
// whole warp and stored as 0, so a causal row's work is its visible keys
// rounded up to words; lanes that each hashed a whole word of one row
// would all wait for the row's longest. No shared memory.

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

// W: the keep words of rows (bi, hi, q) as above. Warp `wid` (grid-stride)
// takes 32-word chunk wid % nch of row wid / nch; the row's keys [lo, hi)
__global__ void __launch_bounds__(THREADS)
keep_words_kernel(uint32_t* __restrict__ out, const int* __restrict__ kv_lens,
                  int b, int h, int sq, int sk, int ww, int causal, int q_off,
                  int window, int everything, tf::Drop d) {
  const int lane = threadIdx.x & 31;
  const int nch = (ww + 31) / 32;
  const long long warps = (long long)b * h * sq * nch;
  const long long step = (long long)gridDim.x * (THREADS / 32);
  for (long long wid = (long long)blockIdx.x * (THREADS / 32) +
                       (threadIdx.x >> 5);
       wid < warps; wid += step) {
    const long long row = wid / nch;          // ((bi·h + hi)·sq + q)
    const int w0 = (int)(wid % nch) * 32;
    const int q = (int)(row % sq), bi = (int)(row / sq / h);
    int lo = 0, hi = sk;
    if (!everything) {
      if (kv_lens != nullptr) hi = min(hi, max(0, kv_lens[bi]));
      if (causal) hi = min(hi, q_off + q + 1);
      if (window > 0) lo = max(0, q_off + q - window + 1);
    }
    // the chunk's words that hold a key of [lo, hi)
    const int wa = max(w0, lo >> 5);
    const int wb = hi > lo ? min(min(w0 + 32, ww), (hi + 31) >> 5) : wa;
    const uint64_t base = (uint64_t)row * sk + lane;
    uint32_t mine = 0;
#pragma unroll 4
    for (int w = wa; w < wb; ++w) {
      const int key = w * 32 + lane;
      const bool kp = tf::keep(d, base + (uint64_t)w * 32) & (key >= lo) &
                      (key < hi);
      const uint32_t bits = __ballot_sync(0xffffffffu, kp);
      if (lane == w - w0) mine = bits;
    }
    if (w0 + lane < ww) out[row * ww + w0 + lane] = mine;
  }
}

}  // namespace

// W: out (b, h, sq, ww) uint32, ww = ceil(sk / 128)·4; kv_lens (b,) int32 or
// null; window 0: none; everything: every key below sk of every row.
extern "C" int attention_keep_words(void* out, const void* kv_lens, int b,
                                    int h, int sq, int sk, int ww,
                                    int causal, int q_off, int window,
                                    int everything, unsigned k1, unsigned k2,
                                    unsigned thr, void* stream) {
  if (ww != (sk + 127) / 128 * 4 || b <= 0 || h <= 0 || sq <= 0 || sk <= 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const tf::Drop d{k1, k2, thr, 1.f};
  // a warp a 32-word chunk; blocks of 8 warps, up to 16 an SM at a time
  const long long warps = (long long)b * h * sq * ((ww + 31) / 32);
  long long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;
  keep_words_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const int*)kv_lens, b, h, sq, sk, ww, causal, q_off,
      window, everything, d);
  return (int)cudaGetLastError();
}

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
