// The dense attention mask of the flash-attention kernels' mask modes (K1
// in csrc/flash_attention.cu, K3 and K4 in csrc/flash_attention_bwd.cu):
// the reference streams the same mask tiles through _fwd_kernels,
// _bwd_dq_kernel and _bwd_dkv_kernel (paddle_tpu/ops/flash_attention.py,
// _block_mask :405-431).
//
// The contract is the reference's _xla_attention (:99-141), as the port's
// plain twins compute it (ops/flash_attention.py): with s the scaled score,
//   * a key at or past sk does not exist: -inf, no weight at all;
//   * a key the structured masks hide (past kv_len, past the causal
//     diagonal): NEG (-1e30), plus the entry of a float mask;
//   * a bool False: NEG;
//   * a float mask: s + mask, in fp32.
// The kernels run the mask mode's softmax in the natural domain (m, the row
// max, and t - m taken before the product with log2 e), because a float
// mask can put a whole row at -1e10 and a bool mask at -1e30: there
// `fmaf(s, scale·log2 e, -m·log2 e)` would leave the rounding of m·log2 e
// (thousands) in every exponent. For the same reason the mask modes keep a
// row's statistics as a pair, (m, log l) (ops/flash_attention.py, "the
// mask mode's lse"): an fp32 sum m + log l drops log l beside -1e10, and
// with it the 1/l of every probability the backward recomputes.
//
// A row that a bool mask hides at every key sees every key at NEG: the
// softmax is uniform over all sk keys and the row gives the mean of v (the
// reference's Pallas kernel gives 0 there, :600-601). Such a row ("dead":
// some key visible to the structured masks, none to the dense one) needs
// every key, so the block that holds it walks every key tile; the bounds
// (ops/flash_attention.py `mask_bounds`) say so. A float row at -inf
// everywhere gives NaN, as the twin and the reference's CPU path do.

#pragma once

#include <math.h>
#include <stdint.h>

namespace am {

constexpr float NEG = -1e30f;                  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// element (b, h, q, k) of the mask lies at p + b·sb + h·sh + q·sq + k·sk
// (elements; 0 on a broadcast dim), one byte a bool or an fp32;
// `bounds` holds each block's [lo, hi) tile range
struct Mask {
  const void* p;
  long long sb, sh, sq, sk;
  int f32;
  const int* bounds;
};

// The masked score t of key kc for a row whose mask entries start at
// element `row` (row < 0: a row past sq, -inf everywhere), and whether t
// depends on s (g: a gradient reaches s only there); st: the structured
// masks hide the key
__device__ __forceinline__ float score(const Mask& mk, long long row, int kc,
                                       int sk, float s, float scale, bool st,
                                       bool& g) {
  g = false;
  if (row < 0 || kc >= sk) return -INFINITY;
  const long long at = row + (long long)kc * mk.sk;
  if (mk.f32) {
    const float v = __ldg(reinterpret_cast<const float*>(mk.p) + at);
    if (st) return NEG + v;
    g = true;
    return fmaf(s, scale, v);
  }
  const bool keep = __ldg(reinterpret_cast<const uint8_t*>(mk.p) + at) != 0;
  g = keep && !st;
  return g ? s * scale : NEG;
}

// 2^((t - m)·log2 e - lg2): the probability of score t in a row whose
// statistics are (m, lg2 = log2 l); lg2 = +inf gives 0
__device__ __forceinline__ float prob(float t, float m, float lg2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fmaf(t - m, LOG2E, -lg2)));
  return y;
}

// a row's (m, log l) as the backward kernels use them: m, and log2 l, or
// +inf where the row has no key (l = 0: every probability 0) or lies past sq
__device__ __forceinline__ void row_stats(const float* stats, int r, int sq,
                                          float& m, float& lg2) {
  if (r >= sq) {
    m = 0.f;
    lg2 = INFINITY;
    return;
  }
  const float2 st = *reinterpret_cast<const float2*>(stats + 2 * (long long)r);
  m = st.x;
  lg2 = st.y == -INFINITY ? INFINITY : st.y * LOG2E;
}

}  // namespace am
