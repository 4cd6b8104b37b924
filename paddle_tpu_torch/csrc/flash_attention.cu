// Flash-attention forward for Hopper (sm_90a): blockwise online softmax on
// wgmma tensor-core products, K/V streamed by TMA through a ring of shared
// memory stages, one producer warpgroup and two consumer warpgroups.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernels
// (:526, pallas_call at :648) on every prefill, on the training forward and
// on the UNet's self- and cross-attention (non-causal, ragged sk = 77):
// causal with an explicit query offset (k_pos <= q_off + i), GQA by
// indexing kv head hi / rep (k and v are never repeated), per-batch
// kv_lens, the causal sliding window (the query at p = q_off + i sees the
// keys p - window < k <= p: the reference's window mode, `_window_k0` at
// :465 and the mask at :411-412), and fully-masked rows giving 0 with lse
// NEG_INF. The lse is the natural log of the scaled scores, as the backward
// kernels (csrc/flash_attention_bwd.cu) read it.
//
// What bounds it on the H100: at prefill shapes (sq ~ sk ~ 1k, d = 128) the
// work is 4·d FLOPs per visible (query, key) pair against ~4·d bytes per
// query row, so it is compute bound: the tensor cores' 989 TFLOP/s bf16
// dense, reached only through wgmma fed from shared memory that TMA fills.
//
// Design. A block owns BQ = 128 query rows of one (batch, head):
//  * Producer (warpgroup 2; one thread issues, setmaxnreg drops the group to
//    24 registers): TMA-loads the Q tile once, then K and V tiles of BK =
//    128 keys into an ST-stage ring, each stage guarded by a full barrier
//    for K and one for V (transaction bytes) and an empty barrier for each
//    (256 consumer arrivals): K(j) is released as soon as S(j) completes,
//    a step before V(j), so the next K loads a step ahead with 2 stages.
//    Tiles wholly past the causal or kv_len limit of the block's last row
//    are never loaded. TMA's zero fill covers the ragged sq and sk tails;
//    q (b, sq, h, d) and k/v (b, sk, nkv, d) are read in place through 4-d
//    tensor maps (row stride h·d or nkv·d).
//  * Consumers (warpgroups 0 and 1, 64 query rows each, setmaxnreg raises
//    them to 240): S = Q·Kᵀ by wgmma m64n128k16 with Q and K both from
//    128-byte-swizzled shared memory (K-major); the online softmax in
//    registers in the log2 domain (scale·log2 e folded into one FFMA before
//    ex2); O += P·V by wgmma m64nDk16 with P from registers (the bf16 pack
//    of S's accumulator is the A fragment) and V from shared memory as an
//    MN-major B. Each step issues S(j+1) and then P·V(j); the softmax of
//    S(j+1) runs while P·V(j) is on the tensor cores. Only tiles that
//    straddle the causal diagonal or the kv_len edge for this group's rows
//    take the per-element mask.
//  * Scheduling: a 1-d grid in the order of block_order
//    (hopper_sm90.cuh): (batch, head) units in groups whose K/V fits 4 MB
//    of L2, and inside a group the heaviest causal query tiles (most keys)
//    first, so the light ones fill the tail (a static longest-first order;
//    a persistent grid would add a tile scheduler for the same end). At
//    prefill K/V (75 MB) outgrows L2, and one longest-first order over all
//    units would read it from device memory again for every query tile.
//  * sq = 1 (the layered decode path) and sq < 128 run the same kernel: rows
//    past sq are TMA zero fill and are not stored.
//  * The sliding window is a second instantiation (WIN = true; the
//    windowless kernel's code is unchanged). A block loads the key tiles
//    from t0 = max(0, q_off + q0 - window + 1) / BK, the tile of its first
//    row's first visible key, to the causal / kv_len limit as before,
//    producer and consumers counting ring stages from t0 alike (the peeled
//    last P·V and the matched waits stay unconditional); a tile that
//    straddles the window's lower edge for the group's rows takes the
//    per-element mask as the diagonal does. A row whose visible keys all
//    lie in later tiles keeps m = -inf and p = 0 until it meets them. At
//    sq = 1 a decode step reads only the window's tiles.
//  * Dropout is a third template flag (DROP = true; the kernels without it
//    run the code they ran before, their registers untouched): after
//    softmax_tile has taken a tile's undropped P into m and l (the lse stays
//    the undropped one, as the reference's "probabilities drop AFTER the
//    softmax statistics accumulate", :533-535), drop_tile zeroes the
//    dropped elements and scales the kept ones by 1/keep before P is packed
//    for P·V. The keep bits are not hashed here: kernel W
//    (csrc/dropout.cu) hashes the call's mask once into packed words (bit
//    k % 32 of word k / 32 of a row: the keep bit of the element whose flat
//    index is ((b·h + hi)·sq + q)·sk + k, csrc/threefry.cuh), and the
//    producer TMA-loads a tile's words (4 a row, 2 KB for the block's 128
//    rows) beside K on K's full barrier into a ring of its own (`mz`, a
//    tensor map of the words); K's stage is released after drop_tile has
//    read them. K3 and K4 read the same words. A template and
//    not a per-launch flag: the consumers run at 240 registers, and a flag
//    would make every launch carry the drop's registers and a branch in
//    the softmax pass.
//  * ptxas keeps the wgmmas asynchronous only when each wait matches its
//    group statically: every wgmma in the main loop is issued
//    unconditionally (the last tile's P·V is peeled off), and P is
//    repacked into the registers P·V(j) reads only after P·V(j) completes.
//
//  * The general mode is a fourth flag (MOD = true, at D 64 and 128, with
//    or without DROP; the kernels without it run the code they ran
//    before): the dense mask, the segment ids and ALiBi beside the causal
//    mask, kv_lens and the window, each a runtime field of one argument
//    (am::Mod, csrc/attn_mask.cuh, with this mode's contract and its
//    natural-domain softmax). The mask is bool or fp32, read in place
//    through four element strides (0 on a broadcast dim, so a (b, 1, 1,
//    sk) key-padding mask is never expanded); a row's segment ids are read
//    once, a key's per element; the ALiBi bias slope_h·(k - q - q_off) is
//    added to the scaled score before every mask. A block walks the list
//    of key tiles the caller gives it (ops/flash_attention.py
//    `mask_bounds`' fwd_list: the reference's _mask_block_bounds, :445,
//    made per tile at this kernel's 128 x 128 tiles, the structured limits
//    and the window folded in), producer and consumers counting ring
//    stages over the list: an EMPTY tile (no entry can change a counted
//    row) is never loaded, wherever it lies. A FULL tile (every entry True,
//    or every fp32 entry one value c) takes no mask load; a MIXED tile of a
//    bool mask reads its entries as bits from shared memory, its packed
//    words (4 uint32 a row) TMA-loaded by the producer beside K on K's full
//    barrier (2 KB, or 16 bytes for a key-padding mask; K's stage is then
//    released after the softmax, which reads them); a MIXED fp32 tile reads
//    the mask in place (staging it, 64 KB a tile, would not fit beside two
//    stages of K and V at d 128). The structured test runs per element
//    only on a tile that kv_len, the diagonal, the window or segment ids
//    cut for the group's rows. A dead row of a bool mask without dropout
//    (csrc/attn_mask.cuh) is off the walk: the epilogue writes it as the
//    mean of v (`red`, from the row-sum kernel, csrc/attn_rows.cu) with the
//    pair (NEG, log sk), and a block whose rows are all dead walks nothing;
//    a float mask's or a dropout call's dead row keeps its block on every
//    tile, each MIXED. A row no key reaches through the structured masks
//    (tracked per row while the tiles pass) gives 0. The row statistics are written as the
//    pair (m, log l) in place of the lse. Dropout applies after the
//    statistics, as in DROP. Inside MOD, WIN picks the loop with the
//    window, segment ids and ALiBi (EXTRA: the per-row ids, the slope and
//    the tracking of which rows some key reaches); without it a dense mask
//    alone (the padded batches of the encoders) runs a lean loop whose
//    test is kv_len, the diagonal and the mask, and kv_len and the
//    diagonal say which rows no key reaches. The host picks the pair from
//    the argument's fields; the windowed walk (t0) is never MOD's.
//
//  * Kernel widths D = 64, 128 and 256 (the reference's kernel widths).
//    D = 256 is a fourth instantiation with its own key tile (Fwd<256>::BK
//    = 64: S by m64n64k16, P·V by m64n256k16 into a 128-float O
//    accumulator a thread); only its windowless, dropout-free kernel is
//    built. A head dim d that is a multiple of 8 up to 256 runs at the next
//    width D at or above it, at its own width in memory: the tensor maps'
//    column size is d (row stride h·d or nkv·d), so the columns d … D - 1
//    of every Q, K and V tile arrive as TMA's zero fill, and the epilogue
//    stores O at row stride h·d, only the column groups below d. The
//    reference pads such a d in the caller (_pad_for_kernel, :339), a TPU
//    tiling device; here the zero fill replaces the pad and the slice,
//    and the tiles hold what the padded tensors would give. A 64-column
//    box that lies wholly past d (columns 192-255 at d = 160) is still
//    loaded, as zero fill, and counts towards its barrier's expected bytes
//    like any other box. The plain mode at d = 40, 80 and 160 (SD-1.5's
//    UNet, every one of its attention calls) runs instantiations whose
//    Q·Kᵀ issues only the k16 steps that hold data (KS = 3, 5, 10 of D / 16
//    = 4, 8, 16; any d with ceil(d / 16) <= KS takes them): a step over
//    zero columns adds +0 to every score, so O and the lse are bitwise
//    those of the padded call. KS is a template parameter: a run-time
//    bound on the wgmma loop would make ptxas serialise the wgmmas, and
//    every other instantiation keeps its loop. P·V stays at width D: its
//    columns past d are zero and never stored. Every other mode at such a
//    d runs the full loop on the zero-filled tiles. ptxas (-v, sm_90a):
//    the trimmed instantiations <64, 3>, <128, 5> and <256, 10> take 168
//    registers at entry, spill nothing and raise none of C7510-C7515, as
//    the full loops do. On an H100 (700 W) the trim takes K1 at SD-1.5's
//    largest call (b 2, 8 heads, 4096 x 4096, d 40) from 0.185 to 0.175
//    ms (chip_smoke.py --k1h, against a copy whose QK_TRIM<D> is D / 16).
//
// Shared memory: Q 128·d·2 + ST·2·BK·d·2 bytes (d = 128, ST = 2: 160 KB;
// d = 64, ST = 3: 112 KB; d = 256, BK = 64, ST = 2: 192 KB) + barriers;
// one block per SM; MOD adds a ring of packed-word stages and walk-entry
// slots past the barriers (ST · 2 KB + ST · 8 bytes), DROP a ring of keep
// words past those (ST · 2 KB). Registers (nvcc 12.9 -Xptxas -v, sm_90a):
// 168 at entry for 384 threads (consumers 240, producer 24 after
// setmaxnreg), no wgmma serialisation warning; the spills of each
// instantiation are in the port's kernel table (PERF.md).

// Layouts: q (b, sq, h, d), k/v (b, sk, nkv, d), out (b, sq, h, d), all
// bf16 and contiguous (16-byte aligned); lse (b, h, sq) fp32; kv_lens (b,)
// int32 or null.

#include "attn_mask.cuh"
#include "hopper_sm90.cuh"

using namespace sm90;

#define NEG_INF (-1e30f)

namespace {

constexpr int BQ = 128;       // query rows per block (64 per consumer group)
constexpr int THREADS = 384;  // consumer groups 0, 1; producer group 2

template <int D>
struct Fwd {
  // keys per tile: 128, and 64 at d = 256, where Q (64 KB) and two stages
  // of 128-key K and V tiles (256 KB) would pass the 227 KB of shared
  // memory a block may have; 64 keys make S an m64n64 product and P·V an
  // m64n256 one (wgmma's widest N)
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int ST = D == 64 ? 3 : 2;    // ring stages
  static constexpr int NCH = D / 64;            // 64-column tiles a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * ST * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (1 + 4 * ST) * 8 + 1024;
  // MOD: a ring stage of a MIXED bool tile's packed words (4 a row), and
  // of the walk entry and its c, past the barriers, so that the other
  // instantiations keep their layout
  static constexpr int W_BYTES = BQ * 16;
  static constexpr int W_OFF = (BAR_OFF + (1 + 4 * ST) * 8 + 127) / 128 * 128;
  static constexpr int E_OFF = W_OFF + ST * W_BYTES;
  static constexpr int SMEM_MOD = E_OFF + ST * 8 + 1024;
  // DROP: a ring stage of a tile's keep words (4 a row), past MOD's
  static constexpr int Z_OFF = (E_OFF + ST * 8 + 127) / 128 * 128;
  static constexpr int SMEM_DROP = Z_OFF + ST * W_BYTES + 1024;
};

// The k16 steps of Q·Kᵀ in the plain mode's trimmed instantiation at
// width D: those that hold data at SD-1.5's head dims 40, 80 and 160
template <int D>
constexpr int QK_TRIM = D == 64 ? 3 : D == 128 ? 5 : 10;

// S (64 x BK) = Q (this group's 64 rows) · K(tile)ᵀ over the first KS k16
// steps (the columns past 16·KS are zero), issued and committed
template <int D, int KS>
__device__ __forceinline__ void issue_qk(float (&s)[Fwd<D>::BK / 2],
                                         uint64_t dq, uint64_t dk) {
  constexpr int BK = Fwd<D>::BK;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // 16 columns inside a 64-column tile: +32 bytes; next tile: +rows·128
    const uint32_t oq = ((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4;
    const uint32_t ok = ((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4;
    if constexpr (BK == 128)
      wgmma_ss_n128(s, dq + oq, dk + ok, kk > 0);
    else
      wgmma_ss_n64(s, dq + oq, dk + ok, kk > 0);
  }
  wgmma_commit();
}

// DROP's scalar argument, 1/keep. It fills the 16 bytes of kernel
// parameters that the dropout draw's key held before the keep words: the
// general argument after it (am::ModTile, 64-byte aligned) keeps its offset,
// so the instantiations without dropout keep their machine code.
struct DropScale {
  float inv;
  uint32_t unused[3];
};

// Mask tile k0 where it straddles the causal diagonal, the kv_len edge or
// (WIN) the window's lower edge for this group's rows (rw0 … rw0+63; key
// kc is below row r's window when kc <= wlo + r, wlo = q_off - window),
// then the online-softmax update in the log2 domain: m, l per row (l a
// per-thread partial), s -> p = 2^(s·sl2 − m), alpha the factor that
// rescales the rows of O.
template <int BK, bool WIN>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int r0, int rw0, int tg,
                                             int kvlen, int causal, int q_off,
                                             int wlo, float sl2) {
  if (k0 + BK > kvlen || (causal && k0 + BK - 1 > q_off + rw0) ||
      (WIN && k0 <= wlo + rw0 + 63)) {
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kc = k0 + c * 8 + tg * 2 + j;
          if (kc >= kvlen || (causal && kc > q_off + r0 + 8 * i) ||
              (WIN && kc <= wlo + r0 + 8 * i))
            s[4 * c + 2 * i + j] = -INFINITY;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
      mx = fmaxf(mx, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float mnew = fmaxf(m[i], mx * sl2);
    // a row with no visible key yet keeps m = -inf: its p must be 0
    const float muse = mnew == -INFINITY ? 0.f : mnew;
    alpha[i] = ex2(m[i] - muse);
    m[i] = mnew;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = ex2(fmaf(s[4 * c + 2 * i + j], sl2, -muse));
        s[4 * c + 2 * i + j] = v;
        rs += v;
      }
    l[i] = l[i] * alpha[i] + rs;
  }
}

// MOD: the sources of a walked tile's mask entries: a FULL tile's (every
// entry True or the value c; a call without a mask too), a MIXED bool
// tile's bits staged in shared memory, a MIXED fp32 tile's mask in place
// (the (batch, head)'s elements from mb)
enum { SRC_FULL, SRC_BITS, SRC_F32, SRC_ANY };

// MOD: tile k0's scores t in place of s (csrc/attn_mask.cuh) from one
// source: the thread's rows r0 and r0 + 8 read an fp32 mask from elements
// mb + row·sq + key·sk and bits from wr[0], wr[1] (the 4 words
// of the row's 128 keys); a FULL tile's entries are cv (0 for a bool mask).
// The structured test runs per element only on an EDGE tile (kv_len, the
// diagonal, the window, segment ids or the key range cut it for the
// group's rows). EXTRA: the rows' segment ids sg[i] against the keys' at
// segk, the bias slope·(k - q - q_off), and `seen` marks a row that the
// structured masks leave some key. SRC_ANY takes the tile's source at run
// time (`full`, else the words or the fp32 mask)
template <int BK, bool EXTRA, int SRC, bool EDGE>
__device__ __forceinline__ void mod_scores(
    float (&s)[BK / 2], bool (&seen)[2], int k0, int r0, int tg, int sq,
    int sk, int kvlen, int causal, int q_off, float scale,
    const am::Mod& md, long long mb, const int (&sg)[2], const int* segk,
    float slope, bool full, float cv, const uint4 (&wr)[2]) {
  // a hidden key's score: NEG (+ c) beside a mask, -inf without one
  const float hid = md.p != nullptr ? am::NEG + cv : -INFINITY;
  if constexpr (EXTRA && !EDGE) {
    seen[0] = true;
    seen[1] = true;
  }
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + c * 8 + tg * 2 + j;
        const int qp = q_off + r0 + 8 * i;
        float& v = s[4 * c + 2 * i + j];
        bool st = false;
        if constexpr (EDGE) {
          if constexpr (EXTRA) {
            st = am::hidden(md, kc, kvlen, causal, qp,
                            segk != nullptr && kc < sk &&
                                __ldg(segk + kc) != sg[i]);
            seen[i] |= !st;
          } else {
            st = kc >= kvlen || (causal && kc > qp);
          }
        }
        const float bias = EXTRA ? slope * (float)(kc - qp) : 0.f;
        float t;
        if (SRC == SRC_FULL || (SRC == SRC_ANY && full)) {
          t = st ? hid : fmaf(v, scale, bias + cv);
        } else if (SRC == SRC_BITS ||
                   (SRC == SRC_ANY && md.words != nullptr)) {
          const uint32_t w = (c >> 2) == 0   ? wr[i].x
                             : (c >> 2) == 1 ? wr[i].y
                             : (c >> 2) == 2 ? wr[i].z
                                             : wr[i].w;
          t = ((w >> ((c & 3) * 8 + tg * 2 + j)) & 1) && !st
                  ? fmaf(v, scale, bias)
                  : am::NEG;
        } else if (r0 + 8 * i >= sq) {
          t = -INFINITY;          // a row past sq: no entry to read
        } else {
          const float x = __ldg(reinterpret_cast<const float*>(md.p) + mb +
                                (long long)(r0 + 8 * i) * md.sq +
                                (long long)kc * md.sk);
          t = st ? am::NEG + x : fmaf(v, scale, bias + x);
        }
        if constexpr (EDGE)
          if (kc >= sk) t = -INFINITY;
        v = t;
      }
}

// MOD: tile k0's scores through the modifiers (mod_scores, one loop per
// source and edge, picked once a tile: `cls` its class, *cvp its c, ws the
// words staged for it, lr r0's row in the block; FEW: a FULL tile on a
// loop of its own, with and without the structured test, and the others
// on one, SRC_ANY, which keeps the dropout instantiations' registers),
// then the online-softmax
// update in the natural domain: m, l per row, s -> p = 2^((t − m)·log2 e),
// alpha the factor that rescales O
template <int BK, bool EXTRA, bool FEW>
__device__ __forceinline__ void softmax_tile_mod(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool (&seen)[2], int k0, int r0, int lr, int tg, int sq, int sk,
    int kvlen, int causal, int q_off, float scale, const am::Mod& md,
    int bi, int hi, const int (&sg)[2], const int* segk, float slope,
    int cls, const float* cvp, const uint4* ws, bool edge) {
#define MOD_SCORES(SRC, EDGE)                                                 \
  mod_scores<BK, EXTRA, SRC, EDGE>(s, seen, k0, r0, tg, sq, sk, kvlen,        \
                                   causal, q_off, scale, md, mb, sg, segk,    \
                                   slope, cls == am::TILE_FULL, cv, wr)
  if constexpr (FEW) {
    const bool fl = cls == am::TILE_FULL;
    const uint4 wr[2] = {
        fl || md.words == nullptr ? make_uint4(0, 0, 0, 0)
                                  : ws[md.wq > 1 ? lr : 0],
        fl || md.words == nullptr ? make_uint4(0, 0, 0, 0)
                                  : ws[md.wq > 1 ? lr + 8 : 0]};
    const float cv = fl ? *cvp : 0.f;
    const long long mb = bi * md.sb + hi * md.sh;
    if (fl && !edge)
      MOD_SCORES(SRC_FULL, false);
    else if (fl)
      MOD_SCORES(SRC_FULL, true);
    else
      MOD_SCORES(SRC_ANY, true);
  } else if (cls == am::TILE_FULL) {
    const uint4 wr[2] = {};
    const float cv = *cvp;
    const long long mb = 0;
    if (edge)
      MOD_SCORES(SRC_FULL, true);
    else
      MOD_SCORES(SRC_FULL, false);
  } else if (md.words != nullptr) {
    const uint4 wr[2] = {ws[md.wq > 1 ? lr : 0], ws[md.wq > 1 ? lr + 8 : 0]};
    const float cv = 0.f;
    const long long mb = 0;
    if (edge)
      MOD_SCORES(SRC_BITS, true);
    else
      MOD_SCORES(SRC_BITS, false);
  } else {
    const uint4 wr[2] = {};
    const float cv = 0.f;
    const long long mb = bi * md.sb + hi * md.sh;
    if (edge)
      MOD_SCORES(SRC_F32, true);
    else
      MOD_SCORES(SRC_F32, false);
  }
#undef MOD_SCORES
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
      mx = fmaxf(mx, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float mnew = fmaxf(m[i], mx);
    // a row with no key yet (every entry -inf) keeps m = -inf: p = 0
    const float muse = mnew == -INFINITY ? 0.f : mnew;
    alpha[i] = ex2((m[i] - muse) * am::LOG2E);
    m[i] = mnew;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = ex2((s[4 * c + 2 * i + j] - muse) * am::LOG2E);
        s[4 * c + 2 * i + j] = v;
        rs += v;
      }
    l[i] = l[i] * alpha[i] + rs;
  }
}

// Dropout on a tile of P from its staged keep words (zw: the 4 words of
// the thread's row r0, 16 bytes a row, so r0 + 8's lie 8 entries on): a
// dropped element becomes 0, a kept one P·inv (inv = 1/keep). Element
// (c, i, j) is key c·8 + 2·tg + j of the tile: word c / 4, bit (c % 4)·8 +
// 2·tg + j
template <int BK>
__device__ __forceinline__ void drop_tile(float (&s)[BK / 2], const uint4* zw,
                                          float inv, int tg) {
  const uint4 z[2] = {zw[0], zw[8]};
  uint32_t w[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w[i][0] = z[i].x >> (tg * 2);
    w[i][1] = z[i].y >> (tg * 2);
    w[i][2] = z[i].z >> (tg * 2);
    w[i][3] = z[i].w >> (tg * 2);
  }
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& v = s[4 * c + 2 * i + j];
        v = (w[i][c >> 2] >> ((c & 3) * 8 + j)) & 1 ? v * inv : 0.f;
      }
}

// O += P·V(tile): V is the MN-major B, 16 keys = +2048 bytes; committed
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&p)[Fwd<D>::BK / 16][4], uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Fwd<D>::BK / 16; ++kk)
    wgmma_rs<D>(o, p[kk], dv + ((kk * 16 * 128) >> 4), 1);
  wgmma_commit();
}

template <int D, bool WIN, bool DROP, bool MOD = false, int KS = D / 16>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ kv_lens,
               int sq, int sk, int h, int nkv, int causal, int q_off,
               int window, float scale, int group, DropScale ds, int d,
               const __grid_constant__ am::ModTile mt,
               const __grid_constant__ CUtensorMap mz) {
  using C = Fwd<D>;
  constexpr int ST = C::ST;
  constexpr int BK = C::BK;
  // the general mode (MOD) reads its window from md and walks the tiles of
  // its list: there WIN picks the loop with the window, segment ids and
  // ALiBi (EXTRA), and the windowed walk (WND) is the WIN kernel's alone
  constexpr bool WND = WIN && !MOD;
  constexpr bool EXTRA = WIN && MOD;
  const am::Mod& md = mt.m;
  const float inv = ds.inv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm;
  uint8_t* Ks = sm + C::Q_BYTES;                      // stage s at s·KV_BYTES
  uint8_t* Vs = sm + C::Q_BYTES + ST * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + ST;
  uint64_t* empty_k = bars + 1 + 2 * ST;
  uint64_t* empty_v = bars + 1 + 3 * ST;

  // (batch, head) units in groups whose K/V stays in L2, the heaviest
  // causal query tiles (the last: most keys) first inside a group
  const int nqt = (sq + BQ - 1) / BQ;
  const BlockOrder ord = block_order(blockIdx.x, gridDim.x / nqt, nqt, group);
  const int qt = nqt - 1 - ord.tile;
  const int hi = ord.unit % h, bi = ord.unit / h;
  const int kh = hi / (h / nkv);
  const int q0 = qt * BQ;

  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  // keys that can be visible to some row of this block
  int kend = kvlen;
  if (causal) kend = min(kend, q_off + min(q0 + BQ, sq));
  // WND: the tile of the block's first row's first visible key; both roles
  // load and walk tiles t0 … t0 + ntiles - 1 and count ring stages from t0
  int t0 = WND ? max(0, q_off + q0 - window + 1) / BK : 0;
  int ntiles = kend > t0 * BK ? (kend + BK - 1) / BK - t0 : 0;
  const int wlo = WND ? q_off - window : 0;
  // MOD: this block's walk, [n, entry 1 … entry n] (entry: tile | class),
  // the entries' c at the same index of wc; ring index it is entry it + 1,
  // which the producer passes to the consumers in stage it % ST's slot
  // (went, wcv) beside the tile's words (Ws)
  const int* walk = nullptr;
  const float* wc = nullptr;
  if constexpr (MOD) {
    const long long at = bi * md.lsb + hi * md.lsh + (long long)qt * md.ln;
    walk = md.list + at;
    wc = md.cval + at;
    t0 = 0;
    ntiles = walk[0];
  }
  uint8_t* Ws = sm + C::W_OFF;          // MOD: stage s at s·W_BYTES
  int* went = reinterpret_cast<int*>(sm + C::E_OFF);
  float* wcv = reinterpret_cast<float*>(sm + C::E_OFF + ST * 4);
  uint8_t* Zs = sm + C::Z_OFF;          // DROP: stage s at s·W_BYTES

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 256);
      mbar_init(&empty_v[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform for the compiler, so that setmaxnreg applies per group
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && ntiles > 0) {
      tma_prefetch_map(&mq);
      tma_prefetch_map(&mk);
      tma_prefetch_map(&mv);
      if constexpr (DROP) tma_prefetch_map(&mz);
      mbar_arrive_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(Qs + c * BQ * 128, &mq, qbar, c * 64, hi, q0, bi);
      if constexpr (MOD) {
        // the walk's tiles; a MIXED tile of a bool mask brings its packed
        // words (the block's rows, or the one row of a key-padding mask)
        // on K's full barrier
        const uint32_t wbytes = (md.wq > 1 ? BQ : 1) * 16;
        if (md.words != nullptr) tma_prefetch_map(&mt.words);
        int e_nx = walk[1];    // the next tile's entry and c, a tile ahead
        float c_nx = wc[1];
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % ST;
          const uint32_t par = ((it / ST) & 1) ^ 1;
          const int e = e_nx, tile = am::entry_tile(e);
          const float cv = c_nx;
          if (it + 1 < ntiles) {
            e_nx = walk[2 + it];
            c_nx = wc[2 + it];
          }
          const bool stage = md.words != nullptr &&
                             (e >> am::TILE_SHIFT) == am::TILE_MIXED;
          mbar_wait(&empty_k[s], par);
          went[s] = e;
          wcv[s] = cv;
          mbar_arrive_tx(&full_k[s], C::KV_BYTES + (stage ? wbytes : 0) +
                                         (DROP ? C::W_BYTES : 0));
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Ks + s * C::KV_BYTES + c * BK * 128, &mk, &full_k[s],
                        c * 64, kh, tile * BK, bi);
          if (stage)
            tma_load_4d(Ws + s * C::W_BYTES, &mt.words, &full_k[s], tile * 4,
                        md.wq > 1 ? q0 : 0, md.wh > 1 ? hi : 0,
                        md.wb > 1 ? bi : 0);
          if constexpr (DROP)   // the tile's keep words, the block's rows
            tma_load_4d(Zs + s * C::W_BYTES, &mz, &full_k[s], tile * 4, q0,
                        hi, bi);
          mbar_wait(&empty_v[s], par);
          mbar_arrive_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Vs + s * C::KV_BYTES + c * BK * 128, &mv, &full_v[s],
                        c * 64, kh, tile * BK, bi);
        }
      } else {
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % ST;
          const uint32_t par = ((it / ST) & 1) ^ 1;
          mbar_wait(&empty_k[s], par);
          mbar_arrive_tx(&full_k[s], C::KV_BYTES + (DROP ? C::W_BYTES : 0));
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Ks + s * C::KV_BYTES + c * BK * 128, &mk, &full_k[s],
                        c * 64, kh, (t0 + it) * BK, bi);
          if constexpr (DROP)   // the tile's keep words, the block's rows
            tma_load_4d(Zs + s * C::W_BYTES, &mz, &full_k[s], (t0 + it) * 4,
                        q0, hi, bi);
          mbar_wait(&empty_v[s], par);
          mbar_arrive_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c)
            tma_load_4d(Vs + s * C::KV_BYTES + c * BK * 128, &mv, &full_v[s],
                        c * 64, kh, (t0 + it) * BK, bi);
        }
      }
    }
  } else {
    // ---- consumers: rows q0 + 64·wg … +63 ----
    setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, wl = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int rw0 = q0 + wg * 64;                 // the group's first row
    const int r0 = rw0 + wl * 16 + g;             // rows of d[4c + j] ...
    const float sl2 = scale * 1.4426950408889634f;
    // DROP: the keep words of row r0 in stage stg (r0 + 8's 8 entries on)
    auto zrow = [&](int stg) {
      return reinterpret_cast<const uint4*>(Zs + stg * C::W_BYTES) + (r0 - q0);
    };
    // EXTRA: the segment ids of rows r0 and r0 + 8, the keys' ids, the
    // head's slope
    int sg[2] = {0, 0};
    bool seen[2] = {false, false};
    const int* segk = nullptr;
    float slope = 0.f;
    if constexpr (MOD) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < sq) {
          if constexpr (EXTRA)
            sg[i] = am::seg_id(md.seg_q, (long long)bi * sq + r0 + 8 * i);
        }
      if constexpr (EXTRA) {
        if (md.seg_k != nullptr) segk = md.seg_k + (long long)bi * sk;
        if (md.slopes != nullptr) slope = md.slopes[hi];
      }
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (ntiles > 0) {
      float s[BK / 2];
      uint32_t p[BK / 16][4];
      float alpha[2];
      // descriptors: Q rows of this group, K and V of stage 0; a stage is
      // +KV_BYTES >> 4 on the start address
      const uint64_t dq = desc_sw128(Qs + wg * 64 * 128, 16, 1024);
      const uint64_t dk0 = desc_sw128(Ks, 16, 1024);
      const uint64_t dv0 = desc_sw128(Vs, BK * 128, 1024);
      constexpr uint32_t STAGE = C::KV_BYTES >> 4;

      // MOD: the first key of ring entry it's tile, and its softmax: the
      // tile's class and c, the words staged in K's stage, the structured
      // test only where kv_len, the diagonal, the window or segment ids cut
      // the tile for the group's rows; K's stage (and the words) released
      // after it and (DROP) the drop, which reads the stage's keep words
      // (its entry and c from the stage's slot)
      auto mod_tile = [&](int stg) {
        const int e = went[stg], k0 = am::entry_tile(e) * BK;
        bool edge = k0 + BK > kvlen || (causal && k0 + BK - 1 > q_off + rw0);
        if constexpr (EXTRA)
          edge = edge || segk != nullptr ||
                 (md.window > 0 && k0 <= q_off - md.window + rw0 + 63);
        softmax_tile_mod<BK, EXTRA, DROP>(
            s, m, l, alpha, seen, k0, r0, r0 - q0, tg, sq, sk, kvlen, causal,
            q_off, scale, md, bi, hi, sg, segk, slope, e >> am::TILE_SHIFT,
            wcv + stg,
            reinterpret_cast<const uint4*>(Ws + stg * C::W_BYTES), edge);
        if constexpr (DROP) drop_tile<BK>(s, zrow(stg), inv, tg);
        mbar_arrive(&empty_k[stg]);
      };

      mbar_wait(qbar, 0);
      mbar_wait(&full_k[0], 0);
      issue_qk<D, KS>(s, dq, dk0);
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (MOD) {
        mod_tile(0);
      } else {
        // DROP: K's stage is released once the drop has read its words
        if constexpr (!DROP) mbar_arrive(&empty_k[0]);
        softmax_tile<BK, WIN>(s, m, l, alpha, t0 * BK, r0, rw0, tg, kvlen,
                              causal, q_off, wlo, sl2);
        if constexpr (DROP) {
          drop_tile<BK>(s, zrow(0), inv, tg);
          mbar_arrive(&empty_k[0]);
        }
      }
      pack_a<BK>(s, p);
      // A pass issues S(it+1) and then P·V(it) (every wgmma unconditional,
      // so ptxas matches each wait to its group and keeps them
      // asynchronous). The older group, S(it+1), is waited for first and its
      // softmax runs while P·V(it) is on the tensor cores; P is packed into
      // the registers P·V(it) read, and O rescaled, only once P·V(it) is
      // done. The last tile's P·V is peeled off.
      for (int it = 0; it + 1 < ntiles; ++it) {
        const int st = it % ST, sn = (it + 1) % ST;
        mbar_wait(&full_k[sn], ((it + 1) / ST) & 1);
        issue_qk<D, KS>(s, dq, dk0 + sn * STAGE);
        mbar_wait(&full_v[st], (it / ST) & 1);
        issue_pv<D>(o, p, dv0 + st * STAGE);
        wgmma_wait<1>();
        fence_regs(s);
        if constexpr (MOD) {
          mod_tile(sn);
        } else {
          // K(it+1) is read: it may refill (DROP: once the drop has read
          // its keep words)
          if constexpr (!DROP) mbar_arrive(&empty_k[sn]);
          softmax_tile<BK, WIN>(s, m, l, alpha, (t0 + it + 1) * BK, r0, rw0,
                                tg, kvlen, causal, q_off, wlo, sl2);
          if constexpr (DROP) {
            drop_tile<BK>(s, zrow(sn), inv, tg);
            mbar_arrive(&empty_k[sn]);
          }
        }
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        mbar_arrive(&empty_v[st]);
        pack_a<BK>(s, p);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
      }
      const int last = ntiles - 1;
      mbar_wait(&full_v[last % ST], (last / ST) & 1);
      issue_pv<D>(o, p, dv0 + (last % ST) * STAGE);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: rows r0 and r0 + 8, the column groups below d (row
    // stride h·d)
    const long q_rs = (long)h * d;
    bf16* ob = out + (long)bi * sq * q_rs + (long)hi * d;
    float* lb = lse + ((long)bi * h + hi) * sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffff, li, 1);
      li += __shfl_xor_sync(0xffffffff, li, 2);
      float inv = li == 0.f ? 0.f : 1.f / li;
      const int r = r0 + 8 * i;
      if constexpr (MOD) {
        // a row the structured masks hide wholly gives 0 (the reference's
        // `structured.any` rule); any other row without a key (a float
        // row at -inf everywhere) gives NaN, as the twin. Without EXTRA
        // kv_len and the diagonal say which rows some key reaches
        int any;
        if constexpr (EXTRA) {
          any = seen[i];
          any |= __shfl_xor_sync(0xffffffff, any, 1);
          any |= __shfl_xor_sync(0xffffffff, any, 2);
        } else {
          any = min(kvlen, causal ? q_off + r + 1 : sk) > 0;
        }
        if (!any) {
          inv = 0.f;
          m[i] = am::NEG;
          li = 0.f;
        } else if (li == 0.f) {
          inv = NAN;
          m[i] = -INFINITY;
          li = NAN;
        }
      }
      if (r < sq) {
        if constexpr (MOD) {
          // a dead row off the walk (a bool mask without dropout): the mean
          // of v over all sk keys and the pair (NEG, log sk)
          if (md.dead != nullptr &&
              ((md.dead[bi * md.dsb + hi * md.dsh + (r >> 6)] >> (r & 63)) &
               1)) {
            const float* vm = md.red + ((long)bi * nkv + kh) * D;
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
              if (c * 8 < d) {
                const float2 v2 =
                    *reinterpret_cast<const float2*>(vm + c * 8 + tg * 2);
                *reinterpret_cast<uint32_t*>(ob + r * q_rs + c * 8 +
                                             tg * 2) = pack_f2(v2.x, v2.y);
              }
            }
            if (tg == 0)
              *reinterpret_cast<float2*>(
                  lse + 2 * (((long)bi * h + hi) * sq + r)) =
                  make_float2(am::NEG, logf((float)sk));
            continue;
          }
        }
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          if (c * 8 < d)
            *reinterpret_cast<uint32_t*>(ob + r * q_rs + c * 8 + tg * 2) =
                pack_f2(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
        if constexpr (MOD) {
          // the pair (m, log l) of (b, h, sq, 2) statistics
          if (tg == 0)
            *reinterpret_cast<float2*>(lse + 2 * (((long)bi * h + hi) * sq +
                                                  r)) =
                make_float2(m[i], logf(li));
        } else if (tg == 0) {
          lb[r] = li == 0.f ? NEG_INF
                            : m[i] * 0.6931471805599453f + logf(li);
        }
      }
    }
  }
}

// head dim d (a multiple of 8, at most D) at kernel width D: the maps'
// column size is d, so the columns d … D - 1 arrive as TMA's zero fill
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* kv_lens, int b, int sq, int sk, int h, int nkv, int d,
           int causal, int q_off, int window, float scale, const void* keep,
           int keep_ww, float inv, const am::Mod* mod, cudaStream_t st) {
  const bool drop = keep != nullptr;
  CUtensorMap mq, mk, mv;
  int err = sm90_map_bshd(&mq, q, b, sq, h, d, BQ);
  constexpr int BK = Fwd<D>::BK;
  if (!err) err = sm90_map_bshd(&mk, k, b, sk > 1 ? sk : 1, nkv, d, BK);
  if (!err) err = sm90_map_bshd(&mv, v, b, sk > 1 ? sk : 1, nkv, d, BK);
  if (err) return err;
  // window > 0 (with causal): the windowed instantiation; drop: the
  // dropout one; the general argument (mod): the general one, with or
  // without dropout, and with the window, segment ids or ALiBi (WIN) or a
  // dense mask alone. D = 256 has none of them yet: only its plain
  // instantiation is built. The plain mode at a d whose data fits
  // QK_TRIM<D> k16 steps takes the trimmed Q·Kᵀ
  constexpr int KT = QK_TRIM<D>;
  const bool trim = (d + 15) / 16 <= KT;
  auto kern = trim ? flash_fwd_sm90<D, false, false, false, KT>
                   : flash_fwd_sm90<D, false, false>;
  if constexpr (D == 256) {
    if (window > 0 || drop || mod) return (int)cudaErrorInvalidValue;
  } else if (mod) {
    if (mod->window > 0 || mod->seg_k || mod->slopes)
      kern = drop ? flash_fwd_sm90<D, true, true, true>
                  : flash_fwd_sm90<D, true, false, true>;
    else
      kern = drop ? flash_fwd_sm90<D, false, true, true>
                  : flash_fwd_sm90<D, false, false, true>;
  } else if (window > 0 || drop) {
    kern = window > 0 ? (drop ? flash_fwd_sm90<D, true, true>
                              : flash_fwd_sm90<D, true, false>)
                      : flash_fwd_sm90<D, false, true>;
  }
  // the general argument, and the tensor map of its packed words: boxes of
  // 4 words by the block's 128 rows, or 1 row for a key-padding mask
  am::ModTile mt{};
  if (mod) {
    mt.m = *mod;
    if (mod->words != nullptr)
      err = sm90_map_words(&mt.words, mod->words, mod->wb, mod->wh, mod->wq,
                           mod->ww, mod->wq > 1 ? BQ : 1);
    if (err) return err;
  }
  // the keep words (drop): boxes of 4 words by the block's 128 rows
  CUtensorMap mz{};
  if (drop) err = sm90_map_words(&mz, keep, b, h, sq, keep_ww, BQ);
  if (err) return err;
  const int smem = drop ? Fwd<D>::SMEM_DROP
                        : mod ? Fwd<D>::SMEM_MOD : Fwd<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // a (batch, head) unit shares its kv head's K and V: sk·d·2·2 bytes
  const int group = sm90_group((long long)sk * D * 4);
  const int grid = ((sq + BQ - 1) / BQ) * h * b;
  kern<<<grid, THREADS, smem, st>>>(
      mq, mk, mv, (bf16*)out, (float*)lse, (const int*)kv_lens, sq, sk, h,
      nkv, causal, q_off, window, scale, group, DropScale{inv, {}}, d, mt,
      mz);
  return (int)cudaGetLastError();
}

}  // namespace

// keep (or null: no dropout): the dropout instantiation, reading the call's
// keep words (kernel W, csrc/dropout.cu: (b, h, sq, keep_ww) uint32,
// keep_ww = ceil(sk / 128)·4), a kept probability scaled by inv = 1/keep.
// mod (or null): the general mode's argument (csrc/attn_mask.cuh: the
// dense mask, the window, the segment ids, the ALiBi slopes), its walk
// lists (ops/flash_attention.py `mask_bounds`' fwd_list: each 128-row
// block's 128-key tiles), the packed bool mask, and the dead rows with
// their means of v (or null); lse is then the (b, h, sq, 2) pairs (m,
// log l). d: the head dim, a multiple of 8 up to 256 (q, k, v and out at
// that width), run at the next kernel width of 64, 128 and 256
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* kv_lens,
                                   int b, int sq, int sk, int h, int nkv,
                                   int d, int causal, int q_off, int window,
                                   float scale, const am::Mod* mod,
                                   const void* keep, int keep_ww, float inv,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (window > 0 && !causal) return (int)cudaErrorInvalidValue;
  if (keep != nullptr && keep_ww != (sk + 127) / 128 * 4)
    return (int)cudaErrorInvalidValue;
  if (d < 8 || d > 256 || d % 8) return (int)cudaErrorInvalidValue;
  if (d > 128)
    return launch<256>(q, k, v, out, lse, kv_lens, b, sq, sk, h, nkv, d,
                       causal, q_off, window, scale, keep, keep_ww, inv, mod,
                       st);
  if (d > 64)
    return launch<128>(q, k, v, out, lse, kv_lens, b, sq, sk, h, nkv, d,
                       causal, q_off, window, scale, keep, keep_ww, inv, mod,
                       st);
  return launch<64>(q, k, v, out, lse, kv_lens, b, sq, sk, h, nkv, d, causal,
                    q_off, window, scale, keep, keep_ww, inv, mod, st);
}
