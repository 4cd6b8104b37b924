// The general mode of the flash-attention kernels (K1 in
// csrc/flash_attention.cu, K3 and K4 in csrc/flash_attention_bwd.cu): the
// dense attention mask, the segment ids and ALiBi, beside the causal mask,
// kv_lens and the sliding window, in any combination; the reference applies
// them all in one place, _block_mask (paddle_tpu/ops/flash_attention.py
// :390-424), in _fwd_kernels, _bwd_dq_kernel and _bwd_dkv_kernel.
//
// The contract is the reference's _xla_attention (:99-141), as the port's
// plain twins compute it (ops/flash_attention.py): with s the scaled score
// plus the ALiBi bias slope_h·(k - q - q_off) (the reference's :114-118),
//   * a key at or past sk does not exist: -inf, no weight at all;
//   * a key the structured masks hide (past kv_len, past the causal
//     diagonal, at or below the window's lower edge, of another segment):
//     with a dense mask NEG (-1e30), plus the entry of a float mask;
//     without one -inf (its weight is 0 either way unless the row is dead);
//   * a bool False: NEG;
//   * a float mask: s + mask, in fp32.
// The kernels run this mode's softmax in the natural domain (m, the row
// max, and t - m taken before the product with log2 e), because a float
// mask can put a whole row at -1e10 and a bool mask at -1e30: there
// `fmaf(s, scale·log2 e, -m·log2 e)` would leave the rounding of m·log2 e
// (thousands) in every exponent. For the same reason this mode keeps a
// row's statistics as a pair, (m, log l) (ops/flash_attention.py, "the
// mask mode's lse"): an fp32 sum m + log l drops log l beside -1e10, and
// with it the 1/l of every probability the backward recomputes.
//
// A row that a bool mask hides at every key the structured masks leave it
// sees every key at NEG: the softmax is uniform over all sk keys and the
// row gives the mean of v (the reference's Pallas kernel gives 0 there,
// :600-601). Such a row ("dead") needs every key, later ones and those
// below its window included, so the block that holds it walks every key
// tile; the bounds (ops/flash_attention.py `mask_bounds`) say so, and the
// kernels of this mode take their tiles from the bounds alone. A row that
// no key reaches through the structured masks gives 0; a float row at -inf
// everywhere gives NaN, as the twin and the reference's CPU path do.
//
// The modifiers are runtime fields of one argument (Mod), not template
// flags: the reference composes them in any combination, and this mode
// already pays a global load an element for the mask, beside which a
// branch on a few fields costs little. One template flag splits the mode
// in two: a dense mask alone (beside the causal mask and kv_lens: the
// padded batches of ERNIE and the like) runs mask_score and the kernels'
// lean loop; the window, segment ids or ALiBi (EXTRA) take score, hidden
// and the per-row tracking of which rows some key reaches.

#pragma once

#include <math.h>
#include <stdint.h>

namespace am {

constexpr float NEG = -1e30f;                  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// The general mode's argument. Element (b, h, q, k) of the dense mask (p,
// or null without one) lies at p + b·sb + h·sh + q·sq + k·sk (elements; 0
// on a broadcast dim), one byte a bool or an fp32; `bounds` holds each
// block's [lo, hi) tile range; window > 0: the causal sliding window; seg_q
// (b, sq) and seg_k (b, sk) int32, or null: the segment ids; slopes (h,)
// fp32, or null: ALiBi
struct Mod {
  const void* p;
  long long sb, sh, sq, sk;
  int f32;
  const int* bounds;
  int window;
  const int* seg_q;
  const int* seg_k;
  const float* slopes;
};

// The structured masks hide key kc from the query at position qp = q_off +
// row (kv_len, the causal diagonal, the window's lower edge); `seg`: the
// segment ids of the two differ
__device__ __forceinline__ bool hidden(const Mod& md, int kc, int kvlen,
                                       int causal, int qp, bool seg) {
  return kc >= kvlen || (causal && kc > qp) ||
         (md.window > 0 && kc <= qp - md.window) || seg;
}

// A dense mask alone: the masked score t of key kc for a row whose mask
// entries start at element `row` (row < 0: a row past sq, -inf
// everywhere), and whether t depends on s (g); st: kv_len or the causal
// diagonal hides the key
__device__ __forceinline__ float mask_score(const Mod& md, long long row,
                                            int kc, int sk, float s,
                                            float scale, bool st, bool& g) {
  g = false;
  if (row < 0 || kc >= sk) return -INFINITY;
  const long long at = row + (long long)kc * md.sk;
  if (md.f32) {
    const float v = __ldg(reinterpret_cast<const float*>(md.p) + at);
    if (st) return NEG + v;
    g = true;
    return fmaf(s, scale, v);
  }
  const bool keep = __ldg(reinterpret_cast<const uint8_t*>(md.p) + at) != 0;
  g = keep && !st;
  return g ? s * scale : NEG;
}

// EXTRA: the score t of key kc for a row whose mask entries start at element
// `row` (row < 0: a row past sq, -inf everywhere), s the raw score and
// bias the row's ALiBi term for the key, and whether t depends on s (g: a
// gradient reaches s only there); st: the structured masks hide the key
__device__ __forceinline__ float score(const Mod& md, long long row, int kc,
                                       int sk, float s, float scale,
                                       float bias, bool st, bool& g) {
  g = false;
  if (row < 0 || kc >= sk) return -INFINITY;
  if (md.p == nullptr) {
    g = !st;
    return st ? -INFINITY : fmaf(s, scale, bias);
  }
  const long long at = row + (long long)kc * md.sk;
  if (md.f32) {
    const float v = __ldg(reinterpret_cast<const float*>(md.p) + at);
    if (st) return NEG + v;
    g = true;
    return fmaf(s, scale, bias + v);
  }
  const bool keep = __ldg(reinterpret_cast<const uint8_t*>(md.p) + at) != 0;
  g = keep && !st;
  return g ? fmaf(s, scale, bias) : NEG;
}

// the segment id of element i of ids (null: none, 0)
__device__ __forceinline__ int seg_id(const int* ids, long long i) {
  return ids != nullptr ? __ldg(ids + i) : 0;
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
