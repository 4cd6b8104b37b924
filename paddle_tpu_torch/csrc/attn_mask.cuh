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
// :600-601). Such a row ("dead") is a closed form when there is no
// dropout: out = the mean of v over all sk keys, the pair (NEG, log sk),
// dq = 0, nothing to dk, dO/sk to every key's dv. So K1 and K4 take dead
// rows off their walks (K1's epilogue writes the mean, `red`; K4's adds
// dsum/sk to dv, its producer zeroes the rows' P through log2 l = +inf).
// Its dq is 0 under dropout too (no score of it depends on s), so K3 takes
// it off its walk always: the consumer zeroes its P through log2 l = +inf,
// and a block of dead rows walks nothing. A float mask's dead row, or (K1,
// K4) one under dropout, is no closed form: its block walks every key
// tile, later ones and those below its window included. A row that no key
// reaches through the structured masks gives 0; a float row at -inf
// everywhere gives NaN, as the twin and the reference's CPU path do.
//
// K1, K3 and K4 walk lists of tiles (ops/flash_attention.py `mask_bounds`,
// `_tile_classes`): a block's non-EMPTY tiles in order, each with its
// class. EMPTY tiles (no entry can change a counted row) are never loaded.
// A FULL tile's entries are all bool True (at the keys the structured
// masks leave), or all the fp32 value c the entry carries: its scores take
// no mask load (entry_score with keep = true or v = c). A MIXED bool tile
// reads its entries as bits from shared memory, where the producer staged
// the tile's packed words (`words`, 4 uint32 a row of 128 keys) by TMA
// beside the tile's K (K1; K3 the words of the 128-key group holding its
// 64-key tile) or Q (K4); a MIXED fp32 tile reads the mask in place. The
// structured test (kv_len, the diagonal, the window, segment ids) runs per
// element only on a tile that one of them cuts for the group's rows; a
// FULL tile does not turn MIXED for that.
//
// The modifiers are runtime fields of one argument (Mod), not template
// flags: the reference composes them in any combination, and a branch on
// a few fields costs little beside the scores. One template flag splits
// the mode in two: a dense mask alone (beside the causal mask and kv_lens:
// the padded batches of ERNIE and the like) runs the kernels' lean loop;
// the window, segment ids or ALiBi (EXTRA) take hidden, the bias and the
// per-row tracking of which rows some key reaches.

#pragma once

#include <cuda.h>
#include <math.h>
#include <stdint.h>

namespace am {

constexpr float NEG = -1e30f;                  // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// The general mode's argument. Element (b, h, q, k) of the dense mask (p,
// or null without one) lies at p + b·sb + h·sh + q·sq + k·sk (elements; 0
// on a broadcast dim), one byte a bool or an fp32; `bounds` each block's
// [lo, hi) tile range (no kernel reads it: the lists below replaced it);
// window > 0: the causal sliding window; seg_q (b, sq) and seg_k (b, sk)
// int32, or null: the segment ids; slopes (h,) fp32, or null: ALiBi.
// The walks: `list` holds a block's walk at list + b·lsb + head·lsh +
// block·ln (K1, K3: the query head and 128-row block; K4: the kv head and
// 128-key block; 0 strides on a broadcast dim): [n, entry 1 … entry n], an
// entry tile | class << TILE_SHIFT, its c at the same index of `cval`;
// `dead` (or null: dead rows stay on the walk, or there is none) the dead
// rows' bits, 64 rows a word, (b, head) at dead + b·dsb + head·dsh; `red`
// (b, nkv, d) fp32 the dead rows' closed form (K1: the mean of v; K4:
// dsum, the sum of their dO; K3 none: their dq is 0); `words` (or null:
// an fp32 mask or none) the bool mask packed 32 keys a uint32, (wb, wh,
// wq, ww) words, each dim 1 where the mask broadcasts.
struct Mod {
  const void* p;
  long long sb, sh, sq, sk;
  int f32;
  const int* bounds;
  int window;
  const int* seg_q;
  const int* seg_k;
  const float* slopes;
  const int* list;
  const float* cval;
  long long lsb, lsh;
  int ln;
  const unsigned long long* dead;
  long long dsb, dsh;
  const float* red;
  const unsigned* words;
  int wb, wh, wq, ww;
};

// K1's, K3's and K4's argument: Mod and the tensor map of its packed words
// (boxes of 4 words by a block's rows, or 1 row for a key-padding mask),
// which the producer's TMA reads from the kernel's parameters
struct ModTile {
  Mod m;
  alignas(64) CUtensorMap words;
};

// a walk entry: tile | class << TILE_SHIFT
constexpr int TILE_FULL = 1, TILE_MIXED = 2, TILE_SHIFT = 24;

__device__ __forceinline__ int entry_tile(int e) {
  return e & ((1 << TILE_SHIFT) - 1);
}

// The structured masks hide key kc from the query at position qp = q_off +
// row (kv_len, the causal diagonal, the window's lower edge); `seg`: the
// segment ids of the two differ
__device__ __forceinline__ bool hidden(const Mod& md, int kc, int kvlen,
                                       int causal, int qp, bool seg) {
  return kc >= kvlen || (causal && kc > qp) ||
         (md.window > 0 && kc <= qp - md.window) || seg;
}

// The score t of an element from its mask entry, and whether t depends on
// s (g: a gradient reaches s only there): a bool entry `keep`, or an fp32
// one v; st: the structured masks hide the key; bias: ALiBi's term (0
// without it); without a mask keep = true. A FULL tile passes keep = true
// or v = c
__device__ __forceinline__ float entry_score(bool f32, bool keep, float v,
                                             float s, float scale,
                                             float bias, bool st, bool& g) {
  if (f32) {
    g = !st;
    return st ? NEG + v : fmaf(s, scale, bias + v);
  }
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
