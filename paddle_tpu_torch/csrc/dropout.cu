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
// ((bi·h + hi)·sq + q)·sk + k. K1 (csrc/flash_attention.cu), K3 and K4
// (csrc/flash_attention_bwd.cu) stage those words by TMA beside their
// tiles and read bits where they hashed before. Only the keys the
// structured limits leave a row (kv_len, the causal limit with its offset,
// the window's lower edge) are hashed; every other bit is 0. `everything`
// hashes every key below sk of every row: the general mode (a dense mask,
// segment ids or ALiBi), where a row a bool mask hides at every key takes
// the uniform softmax over all sk keys, each dropped.
// Bound: the integer instructions of one hash a visible pair, as kernel D;
// the rotates and xors alone on the INT32 pipe (csrc/threefry.cuh).
// Design:
//  * Balance. A warp takes a pair of rows of one (batch, head), q and
//    sq − 1 − q (the middle row alone when sq is odd), one pair a warp and
//    no grid-stride loop, so the block scheduler balances the blocks. A
//    causal row q hashes about (q_off + q + 1) / 32 words, so a pair's
//    words are the same to one word in every warp of the triangle; the
//    general mode and the rows a window has filled have the same words
//    anyway.
//    (A warp a 32-word chunk in a grid-stride loop over 132 × 16 blocks
//    gave some warps 2.7× the words of others.)
//  * The hash. The lanes hash the 32 keys of one word (a lane a key), a
//    ballot gives the word, and the lanes put it in the warp's 32 words of
//    shared memory; the warp stores a row's 32-word chunk from there in
//    one coalesced store, a word outside the row's limits as 0 unhashed,
//    the edge words' keys past the limits cleared from the word. Each lane
//    hashes four words' keys at once, their rounds interleaved
//    (tf::rounds<4>, then 2 and 1 for a row's last words), and each
//    round's add is an IMAD by the argument `one` (1), which ptxas cannot
//    fold, so the FMA pipe runs those adds beside the INT32 pipe's rotates
//    and xors. A row's counters are 32-bit: its flat range's high word is
//    hoisted unless the range crosses 2^32, and the keep test is bits <=
//    thr·2^9 − 1 (no shift).

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

// W: the ballots of N consecutive words from w of a row into buf[w − c0 …]
// (buf: the warp's 32 words), their keys hashed at once. The lane's key of
// word w is 32w + lane, its counter (hi, lo) = (bhi, blo + 32w + lane), hi +
// 1 past 2^32 (CROSS: the row's flat range crosses it); kept iff y1 ^ y2 <=
// lim. Every lane stores each ballot (one word, one address): no branch
// between the ballots
template <int N, bool CROSS>
__device__ __forceinline__ void keep_step(uint32_t* buf, int w, int c0,
                                          uint32_t bhi, uint32_t blo,
                                          uint32_t k1, uint32_t k2,
                                          uint32_t lim, uint32_t one,
                                          int lane) {
  uint32_t x1[N], x2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t lo = (uint32_t)(w + n) * 32u + blo + (uint32_t)lane;
    x1[n] = bhi + k1 + (CROSS && lo < blo ? 1u : 0u);
    x2[n] = lo + k2;
  }
  tf::rounds<N>(x1, x2, k1, k2, one);
#pragma unroll
  for (int n = 0; n < N; ++n)
    buf[w + n - c0] = __ballot_sync(0xffffffffu, (x1[n] ^ x2[n]) <= lim);
}

// W: the ballots of words [w0, w1) of a row, four at a time, the rest two
// and one
template <bool CROSS>
__device__ __forceinline__ void keep_ballots(uint32_t* buf, int w0, int w1,
                                             int c0, uint32_t bhi,
                                             uint32_t blo, uint32_t k1,
                                             uint32_t k2, uint32_t lim,
                                             uint32_t one, int lane) {
  int w = w0;
  for (; w + 4 <= w1; w += 4)
    keep_step<4, CROSS>(buf, w, c0, bhi, blo, k1, k2, lim, one, lane);
  if (w + 2 <= w1) {
    keep_step<2, CROSS>(buf, w, c0, bhi, blo, k1, k2, lim, one, lane);
    w += 2;
  }
  if (w < w1)
    keep_step<1, CROSS>(buf, w, c0, bhi, blo, k1, k2, lim, one, lane);
}

// W: the keep words of rows (bi, hi, q) as above. Block (x, y) takes
// (batch, head) x = bi·h + hi and its row pairs 8y … 8y + 7, a pair p a
// warp: rows p and sq − 1 − p; each row's keys [lo, hi) are hashed, every
// word of the row is stored. Every value a branch or a loop bound reads is
// the warp's (the warp index and kv_len broadcast by a shuffle), so ptxas
// sees the ballots converged
__global__ void __launch_bounds__(THREADS)
keep_words_kernel(uint32_t* __restrict__ out, const int* __restrict__ kv_lens,
                  int h, int sq, int sk, int ww, int causal, int q_off,
                  int window, int everything, uint32_t k1, uint32_t k2,
                  uint32_t thr, uint32_t one) {
  __shared__ uint32_t words[THREADS];      // 32 a warp
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  uint32_t* buf = words + warp * 32;
  const int p = (int)blockIdx.y * (THREADS / 32) + warp;
  if (p >= (sq + 1) / 2) return;
  const long long bh = blockIdx.x;
  const int bi = (int)blockIdx.x / h;
  // kept iff (bits >> 9) < thr, i.e. bits <= thr·2^9 − 1 (thr = 2^23: every
  // bits; thr = 0 keeps nothing: no key is hashed)
  const uint32_t lim = thr * 512u - 1u;
  int kvl = sk;
  if (!everything && kv_lens != nullptr) kvl = min(sk, max(0, kv_lens[bi]));
  kvl = __shfl_sync(0xffffffffu, kvl, 0);
  for (int r = 0; r < 2; ++r) {
    const int q = r ? sq - 1 - p : p;
    if (r && q == p) break;              // the middle row of an odd sq
    int lo = 0, hi = thr ? kvl : 0;
    if (!everything) {
      if (causal) hi = min(hi, q_off + q + 1);
      if (window > 0) lo = max(0, q_off + q - window + 1);
    }
    // the words that hold a key of [lo, hi)
    const int wa = lo >> 5, wb = hi > lo ? (hi + 31) >> 5 : wa;
    const long long row = bh * sq + q;   // ((bi·h + hi)·sq + q)
    const uint64_t base = (uint64_t)row * sk;
    const uint32_t bhi = (uint32_t)(base >> 32), blo = (uint32_t)base;
    const bool cross = (uint32_t)((base + sk - 1) >> 32) != bhi;
    uint32_t* o = out + row * ww;
    for (int c0 = 0; c0 < ww; c0 += 32) {
      const int w0 = max(c0, wa), w1 = min(c0 + 32, wb);
      if (cross)
        keep_ballots<true>(buf, w0, w1, c0, bhi, blo, k1, k2, lim, one,
                           lane);
      else
        keep_ballots<false>(buf, w0, w1, c0, bhi, blo, k1, k2, lim, one,
                            lane);
      __syncwarp();
      const int w = c0 + lane;
      uint32_t mine = w >= w0 && w < w1 ? buf[lane] : 0u;
      // the edge words' keys outside [lo, hi)
      mine &= w == wa ? ~0u << (lo & 31) : ~0u;
      mine &= w == wb - 1 && (hi & 31) ? (1u << (hi & 31)) - 1u : ~0u;
      if (w < ww) o[w] = mine;
      __syncwarp();                      // buf is read before the next chunk
    }
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
      window < 0 || thr > (1u << 23))
    return (int)cudaErrorInvalidValue;
  // a warp a pair of rows, blocks of 8 warps: a (batch, head) a column of
  // blocks, every pair its own warp
  const long long bh = (long long)b * h;
  const int ys = ((sq + 1) / 2 + THREADS / 32 - 1) / (THREADS / 32);
  if (bh > 0x7fffffffLL || ys > 65535) return (int)cudaErrorInvalidValue;
  keep_words_kernel<<<dim3((unsigned)bh, ys), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (uint32_t*)out, (const int*)kv_lens, h, sq, sk, ww, causal, q_off,
      window, everything, k1, k2, thr, 1u);
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
