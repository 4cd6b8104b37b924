// threefry2x32 and the dropout keep test, written once for every kernel
// that hashes a mask: csrc/dropout.cu (the hidden dropout, and kernel W,
// which packs the attention's keep mask into the words K1 and K4 read) and
// K3's dropout modes in csrc/flash_attention_bwd.cu.
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
// depends on the element's index alone, never on a kernel's tiling: K3
// regenerates the forward's mask whatever its loop order, and kernel W's
// words (hashed once a call, saved for the backward) hold the same bits.
//
// Cost: 20 rounds of add, rotate (one funnel shift) and xor, ten key
// injections, the two input adds and the final xor: 73 integer operations
// as written, 69 instructions at the fewest (four x1 injections fold into
// the next round's three-input add), plus the keep test's shift and
// compare.

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

// bits of element i: y1 ^ y2 of threefry2x32((k1, k2), (hi(i), lo(i)))
__device__ __forceinline__ uint32_t bits(uint32_t k1, uint32_t k2,
                                         uint64_t i) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t x1 = (uint32_t)(i >> 32) + k1;
  uint32_t x2 = (uint32_t)i + k2;
#define TF_ROUND(r) \
  x1 += x2;         \
  x2 = rotl(x2, r) ^ x1;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x1 += k2; x2 += k3 + 1u;
  TF_ODD  x1 += k3; x2 += k1 + 2u;
  TF_EVEN x1 += k1; x2 += k2 + 3u;
  TF_ODD  x1 += k2; x2 += k3 + 4u;
  TF_EVEN x1 += k3; x2 += k1 + 5u;
#undef TF_EVEN
#undef TF_ODD
#undef TF_ROUND
  return x1 ^ x2;
}

// element i is kept
__device__ __forceinline__ bool keep(const Drop& d, uint64_t i) {
  return (bits(d.k1, d.k2, i) >> 9) < d.thr;
}

}  // namespace tf
