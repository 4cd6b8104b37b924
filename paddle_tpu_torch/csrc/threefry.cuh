// threefry2x32 and the dropout keep test, written once for the kernels that
// hash a mask, both in csrc/dropout.cu: the hidden dropout (kernel D), and
// kernel W, which packs the attention's keep mask into the words that K1,
// K3 and K4 read (no attention kernel hashes).
//
// The port draws every dropout mask as the JAX package's CPU path draws it,
// jax.random.bernoulli(key, keep, shape) (paddle_tpu/nn/functional.py:112,
// paddle_tpu/ops/flash_attention.py:138): the 32 bits of the element at
// flat row-major index i are y1 ^ y2 of threefry2x32(key, (i >> 32,
// i & 0xffffffff)) (jax_threefry_partitionable), and the element is kept
// iff uniform = (bits >> 9) · 2^-23 < float32(keep), that is iff
// (bits >> 9) < thr with thr = ceil(float32(keep) · 2^23), computed on the
// host (ops/dropout.py `keep_threshold`). The same function runs in
// torch integer ops in core/rng.py, so a mask on the card is checked bit
// for bit against the plain version, and through it against JAX. A mask
// depends on the element's index alone, never on a kernel's tiling: kernel
// W's words (hashed once a call, saved for the backward) hold the bits the
// plain versions draw.
//
// Cost: 20 rounds of add, rotate (one funnel shift) and xor, ten key
// injections, the two input adds and the final xor: 73 integer operations
// as written, 69 instructions at the fewest (four x1 injections fold into
// the next round's three-input add), plus the keep test's shift and
// compare. The rotates and xors (about 40) run on the INT32 pipe alone; an
// add runs there too (IADD3) unless it is written as a multiply-add
// (IMAD), which the FMA pipe runs: `rounds` takes the rounds' multiplier.

#pragma once

#include <stdint.h>

namespace tf {

// A dropout draw as a kernel takes it: the key's two words, the keep
// threshold on the top 23 bits, and the scale of a kept element (1/keep
// for the attention's probabilities).
struct Drop {
  uint32_t k1, k2, thr;
  float inv;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32's 20 rounds and 10 key injections on N independent counters
// at once, round by round, so that their dependency chains overlap; x1[n],
// x2[n] enter as the counter words with the key's first injection, (hi +
// k1, lo + k2), and leave as (y1, y2). A round's add is x2 · one + x1: with
// a value ptxas cannot see (kernel W passes a kernel argument that is 1)
// it is an IMAD on the FMA pipe, which leaves the INT32 pipe the rotates
// and the xors; with 1u it is a plain add. The injections are plain adds.
template <int N>
__device__ __forceinline__ void rounds(uint32_t (&x1)[N], uint32_t (&x2)[N],
                                       uint32_t k1, uint32_t k2,
                                       uint32_t one) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  auto round = [&](int r) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      x1[n] = x2[n] * one + x1[n];
      x2[n] = rotl(x2[n], r) ^ x1[n];
    }
  };
  auto inject = [&](uint32_t a, uint32_t c) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      x1[n] += a;
      x2[n] += c;
    }
  };
  auto even = [&] { round(13); round(15); round(26); round(6); };
  auto odd = [&] { round(17); round(29); round(16); round(24); };
  even(); inject(k2, k3 + 1u);
  odd();  inject(k3, k1 + 2u);
  even(); inject(k1, k2 + 3u);
  odd();  inject(k2, k3 + 4u);
  even(); inject(k3, k1 + 5u);
}

// bits of element i: y1 ^ y2 of threefry2x32((k1, k2), (hi(i), lo(i)))
__device__ __forceinline__ uint32_t bits(uint32_t k1, uint32_t k2,
                                         uint64_t i) {
  uint32_t x1[1] = {(uint32_t)(i >> 32) + k1};
  uint32_t x2[1] = {(uint32_t)i + k2};
  rounds<1>(x1, x2, k1, k2, 1u);
  return x1[0] ^ x2[0];
}

// element i is kept
__device__ __forceinline__ bool keep(const Drop& d, uint64_t i) {
  return (bits(d.k1, d.k2, i) >> 9) < d.thr;
}

}  // namespace tf
