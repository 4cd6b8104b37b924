// Flash-attention backward for Hopper (sm_90a): dq (K3) and dk/dv (K4),
// bf16 wgmma tensor-core products with fp32 accumulation, fed by TMA through
// a ring of shared-memory stages, one producer warpgroup and two consumer
// warpgroups each.
//
// Replaces the TPU kernels paddle_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (pallas_call at :776) and ::_bwd_dkv_kernel (pallas_call at :919) on the
// training path: causal with an explicit query offset (k_pos <= q_off + i),
// the causal sliding window (the query at p = q_off + i sees the keys
// p - window < k <= p: the reference's window mode, `_window_k0` at :465,
// :749 for dq and the query range at :884-891 for dk/dv), GQA by kv-head
// index, per-batch kv_lens, any sq/sk with ragged tails.
// Both recompute P = exp(S·scale − lse) from the forward's log-sum-exp
// (csrc/flash_attention.cu: natural log of the scaled scores, NEG_INF for a
// row with no visible key, whose P is 0 here as in the reference, :732/:859)
// and take Δ = rowsum(dO∘O) (fp32, computed by the caller, as the reference
// does outside its kernels at :1059). dS = P∘(dP − Δ) with dP = dO·Vᵀ.
//
//   K3: dq = scale · Σ_k dS·K
//   K4: dv = Σ_q Pᵀ·dO,  dk = scale · Σ_q dSᵀ·Q
//
// What bounds them on the H100: at the training shape (s = 1024, d = 64,
// causal) both do 6·d (K3) or 8·d (K4) FLOPs per visible (query, key) pair
// against ~8·d bytes per row, so they are compute bound (989 TFLOP/s bf16
// dense, which only wgmma reaches). Neither writes the (sq, sk) matrices to
// device memory: one tile of S, dP and dS lives in registers at a time, and
// each kernel skips the tiles past the causal or kv_len limit.
//
// ptxas keeps the wgmmas asynchronous only when every wgmma in a loop is
// issued unconditionally and each wait matches its group statically, and no
// register that an in-flight wgmma reads is repacked before its wait (it
// serialises them otherwise, warnings C7513-C7515). K4 waits for each
// pass's products inside the pass; K3 overlaps the next tile's products
// with this one's (below); in both the two consumer groups overlap each
// other. Registers (nvcc 12.9 -Xptxas -v, sm_90a): 168 at entry for 384
// threads (consumers 240, producer 24 after setmaxnreg), no wgmma
// serialisation warning, every instantiation; 0 bytes spilled in K3's and
// in K4's but some at d 128 (the general mode with EXTRA or DROP:
// loop-invariant scalars stored once and reloaded at the loop's head and
// in the epilogue, nvdisasm --print-line-info, the price of the walk's
// state beside dk and dv's 128 accumulators); each instantiation's bytes
// are in the port's kernel table (PERF.md). d = 256
// (flash_bwd_dq_sm90<256, false, false>, flash_bwd_dkv_sm90<256, false,
// false>): 168 at entry, 0 bytes spilled, none of warnings C7513-C7515.
//
// Head dims 64, 128 and 256 (the reference's kernel widths; the caller
// zero-pads others, ops/flash_attention.py). At d = 256 the tiles that fit
// d 64 and 128 pass the 227 KB of shared memory and setmaxnreg's 240
// registers, so the tile shapes are per-D traits (Dq<D>, Dkv<D>, as K1's
// Fwd<D>::BK): K3 streams 32-key tiles, K4 owns 64 keys a block and its
// two consumer groups split dk/dv's columns (see each kernel); d 64 and
// 128 keep the shapes, and the code, they had. Only the windowless,
// dropout-free kernels are built at d = 256.
//
// The window is a second instantiation of each kernel (WIN = true; the
// windowless kernels' code is unchanged, as K1's in csrc/flash_attention.cu):
// K3 walks the key tiles from the tile of its block's first row's first
// visible key, K4 the query tiles up to the last row that sees its block's
// last key; tiles straddling the window's lower edge take the per-element
// mask as the diagonal does (see each kernel below).
//
// Dropout is a third instantiation flag of each kernel (DROP = true, as
// K1's; the kernels without it run the code they ran before). With Z the
// keep mask and P̃ = P∘Z/keep the forward's dropped probabilities:
//   dS = P∘(dP∘Z/keep − Δ), Δ = rowsum(dO∘O) over the dropped O as before,
//   dv = P̃ᵀ·dO.
// Neither kernel hashes: both read the forward's keep words (kernel W,
// csrc/dropout.cu, as K1 reads them), which each producer TMA-loads on the
// stage's full barrier into a ring of its own. K3's stage holds the 4
// words a row of its block's 128 rows over the 128-key group that holds
// the streamed 64-key tile (2 KB, the layout of a MIXED bool tile's mask
// words), and k3_ds reads its rows' two words of the tile's half; K4's
// holds the 4 words a row of a streamed query tile over the block's 128
// keys (1 KB), and k4_drop_ds reads Z's bits there (dSᵀ, and Pᵀ dropped
// for dv).
//
// The general mode is a fourth flag (MOD = true, at d 64 and 128, with or
// without DROP; the kernels without it run the code they ran before), K1's
// general mode's backward (csrc/flash_attention.cu, csrc/attn_mask.cuh:
// the dense mask, the segment ids and ALiBi beside the causal mask,
// kv_lens and the window, runtime fields of one argument): each element's
// score t is recomputed as the forward took it, the ALiBi bias included,
// P = 2^((t − m)·log2 e − log2 l) from the forward's pair (m, log l), and
//   dS = P∘(dP∘[Z/keep] − Δ) where t depends on s (no bias term: the bias
//        is constant in s; a float mask, or a key the structured masks and
//        a bool mask leave visible), 0 elsewhere;
//   dv = (P∘[Z/keep])ᵀ·dO over every element (P is nonzero off those only
//        in a dead row, whose uniform softmax weighs every key,
//        csrc/attn_mask.cuh).
// Both walk lists of tiles, as K1 walks its key tiles
// (csrc/flash_attention.cu, csrc/attn_mask.cuh): EMPTY tiles never loaded,
// FULL tiles with no mask load, a MIXED bool tile's packed words staged by
// the producer's TMA beside the tile on its stage's full barrier, a MIXED
// fp32 tile's mask read in place, the structured test per element only
// where kv_len, the diagonal, the window or segment ids (K4: also sq) cut
// the tile for the group's rows. K3 walks each 128-row block's list of
// 64-key tiles (`mask_bounds`' dq_list: the reference's _mask_block_bounds,
// :445, per query block, made per tile; the window folded in); a MIXED
// tile stages the 4 words a row of the 128-key group that holds it (2 KB,
// or 16 bytes for a key-padding mask: a TMA box is 16 bytes wide at least)
// and reads its half. K4 walks each 128-key block's list of 64-row query
// tiles (`mask_bounds`' dkv_list: the reference's per key block bounds,
// axis_q=False, made per tile; under GQA the union over the kv head's
// query heads, whose own mask rows, segment ids and slopes K4 reads),
// staging a MIXED tile's words beside Q and dO (1 KB, or 16 bytes).
// A dead row of a bool mask (every key it reaches hidden by the mask) has
// no score that depends on s, so its dq is 0 and its Pᵀ·dO the same at
// every key: it is off K3's walk with or without dropout (its rows do not
// count for a tile's class; the consumer gives it log2 l = +inf, so its P
// and dS are 0 on a FULL tile it shares with live rows; a block of dead
// rows walks nothing and writes zeros), and off K4's without dropout (the
// producer gives it log2 l = +inf, and the epilogue adds dsum / sk to
// every key's dv: `red`, the sum of the dead rows' dO from
// csrc/attn_rows.cu). A float mask's dead row keeps its block on every
// tile of both walks, as MIXED. Inside MOD, WIN picks the loop with the
// window, segment ids and ALiBi (EXTRA), as in K1; without it a dense mask
// alone runs the lean loop (kv_len, the diagonal and the mask).
//
// Layouts: q, dout (b, sq, h, d), k/v (b, sk, nkv, d), dq (b, sq, h, d),
// dk/dv (b, sk, nkv, d), all bf16 and contiguous; lse, delta (b, h, sq)
// fp32 ((b, h, sq, 2) pairs (m, log l) for lse in the mask modes); kv_lens
// (b,) int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mask.cuh"
#include "hopper_sm90.cuh"

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)

namespace {

// Both kernels pair a 128-row tile held for the whole block (K3: Q and dO;
// K4: K and V) with 64-row tiles streamed through the ring (K3: K and V;
// K4: Q and dO). Each consumer group owns 64 rows of the held tile.
constexpr int HELD = 128;       // rows of the held tile (64 per consumer group)
constexpr int STREAM = 64;      // rows of a streamed tile
constexpr int THREADS = 384;    // consumer groups 0, 1; producer group 2

// X (64 x N) = A (this group's 64 rows of the held tile, whose 64-column
// tiles are HR rows apart) · B (a streamed tile of N rows)ᵀ over d, both
// K-major: K3's S = Q·Kᵀ and dP = dO·Vᵀ, K4's Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ.
// `ob` is the streamed tile's stage offset (start address >> 4). Issued and
// committed as one group. (HR, N) = (HELD, STREAM) but at d = 256: K3's
// (128, 32), K4's (64, 64).
template <int D, int HR, int N>
__device__ __forceinline__ void issue_hs(float (&x)[N / 2], uint64_t da,
                                         uint64_t db, uint32_t ob) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns inside a 64-column tile: +32 bytes; next tile: +rows·128
    const uint32_t oa = ((kk >> 2) * HR * 128 + (kk & 3) * 32) >> 4;
    const uint32_t o = ob + (((kk >> 2) * N * 128 + (kk & 3) * 32) >> 4);
    if constexpr (N == 64)
      sm90::wgmma_ss_n64(x, da + oa, db + o, kk > 0);
    else
      sm90::wgmma_ss_n32(x, da + oa, db + o, kk > 0);
  }
  sm90::wgmma_commit();
}

// acc (64 rows x N columns) += A (registers: 64 rows x the KR rows of a
// streamed tile) · B (that tile, MN-major: 16 rows = +2048 bytes): K3's dq
// += dS·K, K4's dv += Pᵀ·dO and dk += dSᵀ·Q; committed. N is d but at
// K4's d = 256 (128: a group's half of the columns); KR is STREAM but at
// K3's d = 256 (32)
template <int N, int KR>
__device__ __forceinline__ void issue_acc(float (&acc)[N / 2],
                                          const uint32_t (&a)[KR / 16][4],
                                          uint64_t db) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk)
    sm90::wgmma_rs<N>(acc, a[kk], db + ((kk * 16 * 128) >> 4), 1);
  sm90::wgmma_commit();
}

// ---- K3: dq ------------------------------------------------------------------
//
// K1's data flow with K4's roles swapped. A block owns 128 query rows of one
// (batch, head), 64 per consumer group, on a 1-d grid of ceil(sq/128) × h ×
// b in the order of block_order (hopper_sm90.cuh: (batch, head) units
// grouped so their kv head's K/V fits 4 MB of L2, the heaviest causal query
// tiles, the last, first). The producer warp TMA-loads the block's Q and dO
// once, then streams K and V tiles of 64 keys (32 at d = 256, below)
// through an ST-stage ring
// (one full barrier a stage with the transaction bytes of both, one empty
// barrier of 256 consumer arrivals); tiles wholly past the causal or kv_len
// limit of the block's last row are never loaded, and TMA's zero fill
// covers the ragged sq and sk tails. Each consumer group, per key tile:
//  * S = Q·Kᵀ and dP = dO·Vᵀ by wgmma m64n64k16, both operands K-major from
//    shared memory (K1's S form);
//  * P = 2^(S·scale·log2 e − lse·log2 e), the per-element mask only on
//    tiles that straddle the causal diagonal or the kv_len edge for the
//    group's rows, and dS = P∘(dP − Δ) in place of dP; each thread's two
//    rows' lse·log2 e (+inf for a row with no visible key or past sq, so its
//    P is exactly 0) and Δ stay in registers for the whole walk;
//  * dq += dS·K by wgmma m64nDk16, dS packed into the register A operand,
//    K as an MN-major B from the same stage (K1's P·V form, K in V's role).
// Scheduling within a group (K1's): a pass issues S(j+1) and dP(j+1), then
// dq(j); it waits for the older two, forms dS(j+1) while dq(j) is on the
// tensor cores, and packs dS(j+1) into the registers dq(j) read only once
// dq(j) is done; the last tile's dq is peeled off. (Against passes that wait
// for their own products, as K4's do, it was faster at d = 64 and 128 in
// development runs on the H100, with the same bits.) A group walks
// only the tiles its own rows can see; it releases the block's further
// tiles (the first group's on the causal diagonal; all of them for a group
// past sq) unread.
//
// Window (WIN): the block's producer loads the key tiles t0 … t0 + ntiles
// - 1, t0 = max(0, q_off + q0 - window + 1) / 64 (the tile of the block's
// first row's first visible key), and both roles count ring stages and
// barrier parities by the ring index from t0 alike, as K1 does (a group
// that counted from 0 would wait on the wrong phase of a stage).
// A consumer group first releases, unread, the ring's tiles below its own
// first row's window (at most two: its rows start 64 below the block's),
// then walks from there as above; the `edge` test and k3_ds's mask also
// catch a tile that straddles the window's lower edge for the group's rows
// (key <= q_off - window + r).
//
// General mode (MOD): the producer walks the block's list (`dq_list`),
// reading each entry a tile ahead and passing it and its c to the
// consumers in the stage's slot (an entry read from global memory right
// before the softmax that needs it stalls every tile), and loads a MIXED
// bool tile's words on the stage's full barrier. Both consumer groups walk
// the whole list (a tile past a group's rows gives dS = 0 there). The
// softmax pass, which hides under dq(j) on the tensor cores, takes one of
// three loops a tile: a FULL tile no edge cuts (no mask load, no
// structured test: most of a walk), a FULL edge tile, and a MIXED tile
// (its bits from shared memory, or the fp32 mask in place). Shared memory
// adds ST words stages of 2 KB and ST slots past the barriers (d = 128:
// 201 KB).
//
// Dropout (DROP): the producer loads, beside each K and V tile, the keep
// words of the block's 128 rows over the tile's 128-key group (4 words a
// row, 2 KB) into a ring of ST stages past MOD's (d = 128: 209 KB), and
// each consumer reads its two rows' two words of the tile's half before
// the softmax pass; the general mode with dropout stages both its mask's
// words and the keep words. The arithmetic is the hashing kernel's, on the
// same bits: dS = P∘(dP∘Z/keep − Δ).
//
// Why 64-key tiles: S and dP (2 × 32 fp32 a thread), dq (d/2) and the packed
// dS (16) are live together, ≈ 150 registers at d = 128; 128-key tiles
// would hold ≈ 230 and spill. Why one empty barrier a stage (K1 releases K
// a step before V): K is read until the pass's last product, and with
// ST = 4 stages the ring already holds three tiles ahead. Shared memory:
// Q, dO 2·128·d·2 + ST·2·64·d·2 bytes (d = 128: 192 KB; d = 64: 96 KB);
// one block per SM (the 384 threads' registers fill the SM).
//
// Determinism: no atomics. dq is written once, by the block that owns its
// rows, after a fixed-order sum over key tiles: two launches give equal
// bits. (Folding dq into K4 by atomic adds would change its bits from run
// to run.)
//
// d = 256 (SD-1.5's head dim 160, zero-padded by the caller) takes 32-key
// tiles (Dq<256>::BK): at 64 keys, Q and dO (128 rows, 64 KB each) and even
// two stages of K and V (64 KB a stage) are 256 KB, past the 227 KB a block
// may have, and dq (128 fp32 a thread) beside S, dP (32 each) and the
// packed dS (16) would reach setmaxnreg's 240 before addresses and
// indices. With 32-key tiles S and dP are m64n32k16 products (16 fp32 each),
// dq += dS·K two m64n256k16 steps, ≈ 170 registers live; shared memory is
// Q, dO 128 KB + 2 stages × 32 KB = 192 KB. The block keeps its 128 rows,
// so no product is computed twice (a 64-row block splitting d between the
// groups would recompute S and dP in both). Only the windowless,
// dropout-free instantiation is built at d = 256.

constexpr int BQ3 = HELD;       // K3: query rows per block

template <int D>
struct Dq {
  static constexpr int BK = D == 256 ? 32 : STREAM;   // keys a streamed tile
  static constexpr int ST = D == 256 ? 2 : 4;   // ring stages
  static constexpr int NCH = D / 64;            // 64-column tiles a row
  static constexpr int Q_BYTES = BQ3 * D * 2;   // Q or dO
  static constexpr int KT_BYTES = BK * D * 2;   // a K or V tile
  static constexpr int O_OFF = Q_BYTES;                     // dO
  static constexpr int K_OFF = 2 * Q_BYTES;                 // K stages
  static constexpr int V_OFF = K_OFF + ST * KT_BYTES;       // V stages
  static constexpr int BAR_OFF = V_OFF + ST * KT_BYTES;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * ST) * 8 + 1024;
  // MOD: a ring stage of a MIXED bool tile's packed words (the 4 words a
  // row of the 128-key group that holds the 64-key tile: a TMA box's inner
  // extent is 16 bytes at least), and of the walk entry and its c, past
  // the barriers, so that the other instantiations keep their layout
  static constexpr int W_BYTES = BQ3 * 16;
  static constexpr int W_OFF = (BAR_OFF + (1 + 2 * ST) * 8 + 127) / 128 * 128;
  static constexpr int E_OFF = W_OFF + ST * W_BYTES;
  static constexpr int SMEM_MOD = E_OFF + ST * 8 + 1024;
  // DROP: a ring stage of the keep words (the 4 words a row of the 128-key
  // group that holds the 64-key tile, as W_BYTES), past MOD's
  static constexpr int Z_OFF = (E_OFF + ST * 8 + 127) / 128 * 128;
  static constexpr int SMEM_DROP = Z_OFF + ST * W_BYTES + 1024;
};

// The bit of element (row i, key 8c + 2·tg + j of a 64-key tile) in zr[i],
// the row's two words of the tile's half of its 128-key group: a MIXED
// bool tile's mask bit, or (DROP) its keep bit
__device__ __forceinline__ bool k3_bit(const uint2 (&zr)[2], int i, int c,
                                       int tg, int j) {
  const uint32_t w = c < 4 ? zr[i].x : zr[i].y;
  return (w >> ((c & 3) * 8 + tg * 2 + j)) & 1;
}

// DROP: rows lr and lr + 8 (the block's local rows) of a stage's keep words
// (zs: 4 words a row), half hf (the 64-key tile's) of their four
__device__ __forceinline__ void k3_keep_rows(const uint8_t* zs, int lr,
                                             int hf, uint2 (&zr)[2]) {
  const uint2* z = reinterpret_cast<const uint2*>(zs);
  zr[0] = z[lr * 2 + hf];
  zr[1] = z[(lr + 8) * 2 + hf];
}

// dS = P∘(dP − Δ) in place of dP, P = 2^(S·sl2 − lse·log2 e) from the S
// accumulator (rows r0 + 8i, keys k0 + 8c + 2·tg + j); 0 where the key is
// masked for the row (only `edge` tiles test): past kv_len, past the causal
// diagonal, or (WIN) at or below wlo + r, wlo = q_off - window. DROP:
// dS = P∘(dP∘Z/keep − Δ), Z the keep bits in zr (k3_bit), inv = 1/keep
template <int BK, bool WIN, bool DROP>
__device__ __forceinline__ void k3_ds(const float (&sa)[BK / 2],
                                      float (&dp)[BK / 2],
                                      const float (&l2)[2],
                                      const float (&dl)[2], bool edge, int k0,
                                      int r0, int tg, int kvlen, int causal,
                                      int q_off, int wlo, float sl2,
                                      const uint2 (&zr)[2], float inv) {
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const int key = k0 + c * 8 + tg * 2 + j;
        float p = sm90::ex2(fmaf(sa[e], sl2, -l2[i]));
        if (edge) {
          if (key >= kvlen || (causal && key > q_off + r0 + 8 * i) ||
              (WIN && key <= wlo + r0 + 8 * i))
            p = 0.f;
        }
        if constexpr (DROP) {
          const bool kp = k3_bit(zr, i, c, tg, j);
          dp[e] = p * ((kp ? dp[e] * inv : 0.f) - dl[i]);
        } else {
          dp[e] = p * (dp[e] - dl[i]);
        }
      }
}

// MOD: the sources of a walked tile's mask entries in K3: a FULL tile's
// (every entry True or the value c; a call without a mask too), or a MIXED
// tile's (a bool mask's bits staged in shared memory, an fp32 mask read in
// place)
enum { K3_FULL, K3_MIXED };

// MOD: dS = P∘(dP − Δ) in place of dP where the score t depends on s, else
// 0, for tile k0 (keys k0 + 8c + 2·tg + j, rows r0 + 8i), with t the score
// of csrc/attn_mask.cuh's entry_score: a FULL tile's entries are cv (0 for
// a bool mask); a MIXED bool tile's are bits of wr[i] (the row's two words
// of the tile's 64 keys), a MIXED fp32 tile's the mask at element mr[i] +
// key·sk (mr[i] < 0: a row past sq). P = 2^((t − m)·log2 e − log2 l) from
// the row's (m, log2 l) in (mm, lg) (log2 l = +inf: P = 0). The structured
// test runs per element only on an EDGE tile (kv_len, the diagonal, the
// window or segment ids cut it for the group's rows). EXTRA: the rows'
// segment ids sg[i] against the keys' at segk, the bias slope·(k - q -
// q_off). DROP: dS = P∘(dP∘Z/keep − Δ), Z the keep bits in zr as in k3_ds
template <int BK, bool DROP, bool EXTRA, int SRC, bool EDGE>
__device__ __forceinline__ void k3_ds_mod(
    const float (&sa)[BK / 2], float (&dp)[BK / 2], const float (&mm)[2],
    const float (&lg)[2], const float (&dl)[2], int k0, int r0, int tg,
    int sk, int kvlen, int causal, int q_off, float scale, const am::Mod& md,
    const long long (&mr)[2], const int (&sg)[2], const int* segk,
    float slope, float cv, const uint2 (&wr)[2], const uint2 (&zr)[2],
    float inv) {
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const int key = k0 + c * 8 + tg * 2 + j;
        const int qp = q_off + r0 + 8 * i;
        bool st = false;
        if constexpr (EDGE) {
          if constexpr (EXTRA)
            st = am::hidden(
                md, key, kvlen, causal, qp,
                segk != nullptr && key < sk && __ldg(segk + key) != sg[i]);
          else
            st = key >= kvlen || (causal && key > qp);
        }
        const float bias = EXTRA ? slope * (float)(key - qp) : 0.f;
        bool keep = true;
        float v = cv;
        if constexpr (SRC == K3_MIXED) {
          if (md.words != nullptr) {
            keep = k3_bit(wr, i, c, tg, j);
          } else if (mr[i] < 0) {
            st = true;            // a row past sq: no entry to read
          } else if (!st) {
            v = __ldg(reinterpret_cast<const float*>(md.p) + mr[i] +
                      (long long)key * md.sk);
          }
        }
        bool g;
        const float t =
            am::entry_score(md.f32, keep, v, sa[e], scale, bias, st, g);
        const float p = am::prob(t, mm[i], lg[i]);
        float d = dp[e];
        if constexpr (DROP) d = k3_bit(zr, i, c, tg, j) ? d * inv : 0.f;
        dp[e] = g ? p * (d - dl[i]) : 0.f;
      }
}

template <int D, bool WIN, bool DROP, bool MOD = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  const int* __restrict__ kv_lens, int sq, int sk, int h,
                  int nkv, int causal, int q_off, int window, float scale,
                  int group, float inv,
                  const __grid_constant__ am::ModTile mt,
                  const __grid_constant__ CUtensorMap mz) {
  using C = Dq<D>;
  constexpr int ST = C::ST;
  constexpr int BK = C::BK;
  static_assert(!DROP || BK == 64, "k3_bit reads 64-key tiles");
  // the general mode (MOD) reads its window from md and walks the tiles of
  // its list: there WIN picks the loop with the window, segment ids and
  // ALiBi (EXTRA), and the windowed walk (WND) is the WIN kernel's alone
  constexpr bool WND = WIN && !MOD;
  constexpr bool EXTRA = WIN && MOD;
  const am::Mod& md = mt.m;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = sm90::align1024(smem_raw);
  uint8_t* Qs = sm;
  uint8_t* Os = sm + C::O_OFF;
  uint8_t* Ks = sm + C::K_OFF;                 // stage s at s·KT_BYTES
  uint8_t* Vs = sm + C::V_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  // (batch, head) units in groups whose K/V stays in L2, the heaviest
  // causal query tiles (the last: most keys) first inside a group
  const int nqt = (sq + BQ3 - 1) / BQ3;
  const sm90::BlockOrder ord =
      sm90::block_order(blockIdx.x, gridDim.x / nqt, nqt, group);
  const int qt = nqt - 1 - ord.tile;
  const int hi = ord.unit % h, bi = ord.unit / h;
  const int kh = hi / (h / nkv);
  const int q0 = qt * BQ3;

  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  // keys that can be visible to some row of this block
  int kend = kvlen;
  if (causal) kend = min(kend, q_off + min(q0 + BQ3, sq));
  // WND: the tile of the block's first row's first visible key; both roles
  // load and walk the ring's tiles t0 … t0 + ntiles - 1 and count ring
  // stages from t0
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
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform for the compiler, so that setmaxnreg applies per group
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  if (wg == 2) {
    // ---- producer: one thread issues, the group only gives up registers ----
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && ntiles > 0) {
      sm90::tma_prefetch_map(&mq);
      sm90::tma_prefetch_map(&mo);
      sm90::tma_prefetch_map(&mk);
      sm90::tma_prefetch_map(&mv);
      if constexpr (DROP) sm90::tma_prefetch_map(&mz);
      sm90::mbar_arrive_tx(qbar, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        sm90::tma_load_4d(Qs + c * BQ3 * 128, &mq, qbar, c * 64, hi, q0, bi);
        sm90::tma_load_4d(Os + c * BQ3 * 128, &mo, qbar, c * 64, hi, q0, bi);
      }
      if constexpr (MOD) {
        // the walk's tiles; a MIXED tile of a bool mask brings the packed
        // words of the 128-key group that holds it (the block's rows, or
        // the one row of a key-padding mask) on the stage's full barrier
        const uint32_t wbytes = (md.wq > 1 ? BQ3 : 1) * 16;
        if (md.words != nullptr) sm90::tma_prefetch_map(&mt.words);
        int e_nx = walk[1];    // the next tile's entry and c, a tile ahead
        float c_nx = wc[1];
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % ST;
          const int e = e_nx, tile = am::entry_tile(e);
          const float cv = c_nx;
          if (it + 1 < ntiles) {
            e_nx = walk[2 + it];
            c_nx = wc[2 + it];
          }
          const bool stage = md.words != nullptr &&
                             (e >> am::TILE_SHIFT) == am::TILE_MIXED;
          sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          went[s] = e;
          wcv[s] = cv;
          sm90::mbar_arrive_tx(&full[s], 2 * C::KT_BYTES +
                                             (stage ? wbytes : 0) +
                                             (DROP ? C::W_BYTES : 0));
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_4d(Ks + s * C::KT_BYTES + c * BK * 128, &mk,
                              &full[s], c * 64, kh, tile * BK, bi);
            sm90::tma_load_4d(Vs + s * C::KT_BYTES + c * BK * 128, &mv,
                              &full[s], c * 64, kh, tile * BK, bi);
          }
          if (stage)
            sm90::tma_load_4d(Ws + s * C::W_BYTES, &mt.words, &full[s],
                              (tile >> 1) * 4, md.wq > 1 ? q0 : 0,
                              md.wh > 1 ? hi : 0, md.wb > 1 ? bi : 0);
          if constexpr (DROP)   // the tile's 128-key group's keep words
            sm90::tma_load_4d(Zs + s * C::W_BYTES, &mz, &full[s],
                              (tile >> 1) * 4, q0, hi, bi);
        }
      } else {
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % ST;
          sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          sm90::mbar_arrive_tx(&full[s], 2 * C::KT_BYTES +
                                             (DROP ? C::W_BYTES : 0));
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            sm90::tma_load_4d(Ks + s * C::KT_BYTES + c * BK * 128, &mk,
                              &full[s], c * 64, kh, (t0 + it) * BK, bi);
            sm90::tma_load_4d(Vs + s * C::KT_BYTES + c * BK * 128, &mv,
                              &full[s], c * 64, kh, (t0 + it) * BK, bi);
          }
          if constexpr (DROP)   // the tile's 128-key group's keep words
            sm90::tma_load_4d(Zs + s * C::W_BYTES, &mz, &full[s],
                              ((t0 + it) >> 1) * 4, q0, hi, bi);
        }
      }
    }
  } else {
    // ---- consumers: rows q0 + 64·wg … +63 ----
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, wl = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int rw0 = q0 + wg * 64;                 // the group's first row
    const int r0 = rw0 + wl * 16 + g;             // rows of d[4c + j] ...
    const float sl2 = scale * 1.4426950408889634f;

    // this thread's rows r0 and r0 + 8: lse·log2 e (+inf where P is 0) and Δ
    float l2[2], dl[2];
    const float* lb = lse + ((long)bi * h + hi) * sq;
    const float* db = delta + ((long)bi * h + hi) * sq;
    // MOD: the rows' m (in mm; l2 holds log2 l, +inf for a bool mask's
    // dead row: its P and dS are 0 on every tile it shares with live
    // rows, FULL ones included, whose class its row did not count) and
    // first mask elements; EXTRA: their segment ids, the keys' ids, the
    // head's slope
    float mm[2] = {0.f, 0.f};
    long long mr[2] = {-1, -1};
    int sg[2] = {0, 0};
    const int* segk = nullptr;
    float slope = 0.f;
    if constexpr (EXTRA) {
      if (md.seg_k != nullptr) segk = md.seg_k + (long long)bi * sk;
      if (md.slopes != nullptr) slope = md.slopes[hi];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if constexpr (MOD) {
        am::row_stats(lse + 2 * ((long)bi * h + hi) * sq, r, sq, mm[i],
                      l2[i]);
        if (r < sq) {
          if (md.dead != nullptr &&
              ((md.dead[bi * md.dsb + hi * md.dsh + (r >> 6)] >> (r & 63)) &
               1))
            l2[i] = INFINITY;
          mr[i] = bi * md.sb + hi * md.sh + (long long)r * md.sq;
          if constexpr (EXTRA)
            sg[i] = am::seg_id(md.seg_q, (long long)bi * sq + r);
        }
      } else {
        const float l = r < sq ? lb[r] : NEG_INF;
        l2[i] = l > NEG_INF * 0.5f ? l * 1.4426950408889634f : INFINITY;
      }
      dl[i] = r < sq ? db[r] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (ntiles > 0) {
      // K-major descriptors (this group's Q, dO rows as A; K, V as B) and
      // the MN-major one (K as B of dq += dS·K); a stage is +KT_BYTES >> 4
      // on the start address
      const uint64_t dQ = sm90::desc_sw128(Qs + wg * 64 * 128, 16, 1024);
      const uint64_t dO = sm90::desc_sw128(Os + wg * 64 * 128, 16, 1024);
      const uint64_t dK = sm90::desc_sw128(Ks, 16, 1024);
      const uint64_t dV = sm90::desc_sw128(Vs, 16, 1024);
      const uint64_t dKt = sm90::desc_sw128(Ks, BK * 128, 1024);
      constexpr uint32_t STAGE = C::KT_BYTES >> 4;

      sm90::mbar_wait(qbar, 0);
      // the ring's tiles this group's rows can see: [j0, nt) (ring index,
      // tile t0 + j)
      int kg = kvlen;
      if (causal) kg = min(kg, q_off + min(rw0 + 64, sq));
      const int nt = rw0 >= sq ? 0
                     : MOD    ? ntiles
                              : (kg > 0 ? (kg + BK - 1) / BK - t0 : 0);
      const int j0 =
          WND ? min(ntiles, max(0, q_off + rw0 - window + 1) / BK - t0) : 0;
      // tile k0 straddles the causal diagonal, the kv_len edge or (WIN) the
      // window's lower edge for the group's rows: only then the per-element
      // mask
      auto edge = [&](int k0) {
        return k0 + BK > kvlen || (causal && k0 + BK - 1 > q_off + rw0) ||
               (WIN && k0 <= wlo + rw0 + 63);
      };
      // WND: tiles below this group's rows' windows: released unread
      for (int it = 0; it < j0; ++it) {
        sm90::mbar_wait(&full[it % ST], (it / ST) & 1);
        sm90::mbar_arrive(&empty[it % ST]);
      }
      if (nt > j0) {
        float sa[BK / 2], dp[BK / 2];
        uint32_t da[BK / 16][4];
        // MOD: dS of the tile in stage stg (its entry and c from the stage's
        // slot): a FULL tile that no edge (kv_len, the diagonal, the window,
        // segment ids) cuts for the group's rows on a loop of its own, a FULL
        // edge tile on another, a MIXED one (its bits staged in the stage's
        // words, or the fp32 mask in place) on the third
        auto mod_ds = [&](int stg) {
          const int e = went[stg], tile = am::entry_tile(e), k0 = tile * BK;
          const bool fl = (e >> am::TILE_SHIFT) == am::TILE_FULL;
          bool ed = k0 + BK > kvlen || (causal && k0 + BK - 1 > q_off + rw0);
          if constexpr (EXTRA)
            ed = ed || segk != nullptr ||
                 (md.window > 0 && k0 <= q_off - md.window + rw0 + 63);
          const float cv = fl ? wcv[stg] : 0.f;
          // the rows' two words of the tile's 64 keys (half of its 128-key
          // group's four), row 0 for a key-padding mask
          uint2 wr[2] = {make_uint2(0, 0), make_uint2(0, 0)};
          if (!fl && md.words != nullptr) {
            const uint2* ws =
                reinterpret_cast<const uint2*>(Ws + stg * C::W_BYTES);
            const int lr = r0 - q0;
            wr[0] = ws[(md.wq > 1 ? lr : 0) * 2 + (tile & 1)];
            wr[1] = ws[(md.wq > 1 ? lr + 8 : 0) * 2 + (tile & 1)];
          }
          // DROP: the rows' keep words of the tile's half
          uint2 zr[2] = {make_uint2(0, 0), make_uint2(0, 0)};
          if constexpr (DROP)
            k3_keep_rows(Zs + stg * C::W_BYTES, r0 - q0, tile & 1, zr);
#define K3_DS(SRC, EDGE)                                                      \
  k3_ds_mod<BK, DROP, EXTRA, SRC, EDGE>(sa, dp, mm, l2, dl, k0, r0, tg, sk,   \
                                        kvlen, causal, q_off, scale, md, mr,  \
                                        sg, segk, slope, cv, wr, zr, inv)
          if (fl && !ed)
            K3_DS(K3_FULL, false);
          else if (fl)
            K3_DS(K3_FULL, true);
          else
            K3_DS(K3_MIXED, true);
#undef K3_DS
        };
        sm90::mbar_wait(&full[j0 % ST], (j0 / ST) & 1);
        issue_hs<D, HELD, BK>(sa, dQ, dK, (j0 % ST) * STAGE);
        issue_hs<D, HELD, BK>(dp, dO, dV, (j0 % ST) * STAGE);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sa);
        sm90::fence_regs(dp);
        // DROP (the walk without MOD, whose mod_ds reads its own): the rows'
        // keep words of ring index it's tile (t0 + it) in stage stg, the
        // tile's half
        uint2 zr[2] = {make_uint2(0, 0), make_uint2(0, 0)};
        auto keep_rows = [&](int it, int stg) {
          if constexpr (DROP && !MOD)
            k3_keep_rows(Zs + stg * C::W_BYTES, r0 - q0, (t0 + it) & 1, zr);
        };
        const int kb = (t0 + j0) * BK;
        keep_rows(j0, j0 % ST);
        if constexpr (MOD)
          mod_ds(j0 % ST);
        else
          k3_ds<BK, WIN, DROP>(sa, dp, l2, dl, edge(kb), kb, r0, tg, kvlen,
                               causal, q_off, wlo, sl2, zr, inv);
        sm90::pack_a<BK>(dp, da);
        // K1's overlap (see "Scheduling within a group" above)
        for (int it = j0; it + 1 < nt; ++it) {
          const int st = it % ST, sn = (it + 1) % ST,
                    k1 = (t0 + it + 1) * BK;
          sm90::mbar_wait(&full[sn], ((it + 1) / ST) & 1);
          issue_hs<D, HELD, BK>(sa, dQ, dK, sn * STAGE);
          issue_hs<D, HELD, BK>(dp, dO, dV, sn * STAGE);
          issue_acc<D, BK>(acc, da, dKt + st * STAGE);
          sm90::wgmma_wait<1>();
          sm90::fence_regs(sa);
          sm90::fence_regs(dp);
          keep_rows(it + 1, sn);
          if constexpr (MOD)
            mod_ds(sn);
          else
            k3_ds<BK, WIN, DROP>(sa, dp, l2, dl, edge(k1), k1, r0, tg, kvlen,
                                 causal, q_off, wlo, sl2, zr, inv);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          sm90::fence_regs(da);
          sm90::mbar_arrive(&empty[st]);
          sm90::pack_a<BK>(dp, da);
        }
        const int last = nt - 1;
        issue_acc<D, BK>(acc, da, dKt + (last % ST) * STAGE);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::mbar_arrive(&empty[last % ST]);
      }
      // tiles past this group's rows: released unread
      for (int it = WND ? max(nt, j0) : nt; it < ntiles; ++it) {
        sm90::mbar_wait(&full[it % ST], (it / ST) & 1);
        sm90::mbar_arrive(&empty[it % ST]);
      }
    }

    // epilogue: dq × scale for rows r0 and r0 + 8 below sq
    const long q_rs = (long)h * D;
    bf16* qo = dq + (long)bi * sq * q_rs + (long)hi * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < sq) {
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<uint32_t*>(qo + r * q_rs + c * 8 + tg * 2) =
              sm90::pack_f2(acc[4 * c + 2 * i] * scale,
                            acc[4 * c + 2 * i + 1] * scale);
      }
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* kv_lens, int b, int sq, int sk, int h, int nkv,
              int causal, int q_off, int window, float scale,
              const void* keep, int keep_ww, float inv, const am::Mod* mod,
              cudaStream_t st) {
  const bool drop = keep != nullptr;
  CUtensorMap mq, mk, mv, mo;
  int err = sm90_map_bshd(&mq, q, b, sq, h, D, BQ3);
  if (!err) err = sm90_map_bshd(&mo, dout, b, sq, h, D, BQ3);
  constexpr int BK = Dq<D>::BK;
  if (!err) err = sm90_map_bshd(&mk, k, b, sk > 1 ? sk : 1, nkv, D, BK);
  if (!err) err = sm90_map_bshd(&mv, v, b, sk > 1 ? sk : 1, nkv, D, BK);
  if (err) return err;
  // window > 0 (with causal): the windowed instantiation; drop: the
  // dropout one; the general argument (mod): the general one, with or
  // without dropout, and with the window, segment ids or ALiBi (WIN) or a
  // dense mask alone. d = 256 has none of them yet: only its plain
  // instantiation is built
  auto kern = flash_bwd_dq_sm90<D, false, false>;
  if constexpr (D == 256) {
    if (window > 0 || drop || mod) return (int)cudaErrorInvalidValue;
  } else if (mod) {
    if (mod->window > 0 || mod->seg_k || mod->slopes)
      kern = drop ? flash_bwd_dq_sm90<D, true, true, true>
                  : flash_bwd_dq_sm90<D, true, false, true>;
    else
      kern = drop ? flash_bwd_dq_sm90<D, false, true, true>
                  : flash_bwd_dq_sm90<D, false, false, true>;
  } else {
    kern = window > 0 ? (drop ? flash_bwd_dq_sm90<D, true, true>
                              : flash_bwd_dq_sm90<D, true, false>)
                      : (drop ? flash_bwd_dq_sm90<D, false, true>
                              : flash_bwd_dq_sm90<D, false, false>);
  }
  // the general argument, and the tensor map of its packed words: boxes of
  // 4 words by the block's 128 rows, or 1 row for a key-padding mask
  am::ModTile mt{};
  if (mod) {
    mt.m = *mod;
    if (mod->words != nullptr)
      err = sm90_map_words(&mt.words, mod->words, mod->wb, mod->wh, mod->wq,
                           mod->ww, mod->wq > 1 ? BQ3 : 1);
    if (err) return err;
  }
  // the keep words (drop): boxes of 4 words by the block's 128 rows
  CUtensorMap mz{};
  if (drop) err = sm90_map_words(&mz, keep, b, h, sq, keep_ww, BQ3);
  if (err) return err;
  const int smem = drop  ? Dq<D>::SMEM_DROP
                   : mod ? Dq<D>::SMEM_MOD : Dq<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // a (batch, head) unit streams its kv head's K and V: sk·d·2·2 bytes
  const int group = sm90_group((long long)sk * D * 4);
  const int grid = ((sq + BQ3 - 1) / BQ3) * h * b;
  kern<<<grid, THREADS, smem, st>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta, (bf16*)dq,
      (const int*)kv_lens, sq, sk, h, nkv, causal, q_off, window, scale,
      group, inv, mt, mz);
  return (int)cudaGetLastError();
}

// ---- K4: dk, dv --------------------------------------------------------------
//
// One block owns BKEY = 128 keys of one kv head (64 per consumer warpgroup;
// at d = 256 64 keys, below) and walks the query tiles of every query head of its GQA group. The
// producer warp TMA-loads K and V once, then streams Q, dO (64 rows each) and
// the tile's lse (as lse·log2 e; +inf for a row with no visible key or past
// sq, so its P is exactly 0) and Δ through an ST-stage ring. Each consumer
// group computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma m64n64k16 (K, V as A,
// Q, dO as B, all K-major from shared memory), forms Pᵀ and dSᵀ in
// registers, and accumulates dv += Pᵀ·dO and dk += dSᵀ·Q by wgmma
// m64nDk16 with Pᵀ, dSᵀ from registers and dO, Q as MN-major B from the
// same tiles: no transpose, no scalar fragment assembly. dk and dv stay in
// fp32 registers over all the group's heads (fixed order, no atomics: two
// launches give equal bits). At d = 128 each group holds dk and dv (2 × 64
// fp32 a thread) and a 64-query tile (Sᵀ, dPᵀ: 2 × 32) in registers.
// Shared memory: K, V 2·128·d·2 + ST·(2·64·d·2 + 512) bytes (d = 128,
// ST = 2: 129 KB; d = 64, ST = 3: 81.5 KB).
//
// Window (WIN): a block's query tiles end at the tile of the last row that
// sees its last key (row k0 + 127 + window - 1 - q_off), so the walk per
// head is qt0 … qhi - 1; a group skips a tile whose first row's window lies
// wholly above the group's keys, and the edge test and k4_p's mask also
// catch the window's lower edge (key <= q_off - window + row). A key block
// that no query sees walks nothing and writes zeros.
//
// d = 256 (SD-1.5's head dim 160, zero-padded by the caller): a group that
// held dk and dv for 64 keys would hold 2 × 128 fp32 a thread, past
// setmaxnreg's 240 before Sᵀ and dPᵀ, and K, V for 128 keys are 128 KB on
// their own. So a block owns 64 keys (Dkv<256>::BKEY) and both consumer
// groups take all 64 (SPLIT): group g accumulates dk and dv for the columns
// 128·g … 128·g + 127 only (NA = 128: dv += Pᵀ·dO and dk += dSᵀ·Q by
// m64n128k16 over that half of the dO and Q tiles), and each recomputes
// the whole Sᵀ and dPᵀ (over all 256 columns) that it needs. A thread then
// holds what it holds at d = 128 (dk, dv 2 × 64 fp32, Sᵀ, dPᵀ 2 × 32, the
// packed Pᵀ and dSᵀ), and shared memory is K, V 64 KB + 2 stages × 64 KB
// of Q and dO + the rows: 193 KB. The price is Sᵀ and dPᵀ twice, 6 of the
// 8·d FLOPs a pair counted double (the alternative split, dv in one group
// and dk in the other, balances no better: 2 products against 3). Only the
// windowless, dropout-free instantiation is built at d = 256.

constexpr int BQ4 = STREAM;     // K4: query rows per streamed tile

template <int D>
struct Dkv {
  static constexpr bool SPLIT = D == 256;       // groups split the columns
  // keys a block: 64 per consumer group, or 64 shared by both (SPLIT)
  static constexpr int BKEY = SPLIT ? 64 : HELD;
  static constexpr int NA = SPLIT ? D / 2 : D;   // dk, dv columns a group
  static constexpr int ST = D == 64 ? 3 : 2;    // ring stages
  static constexpr int NCH = D / 64;            // 64-column tiles a row
  static constexpr int KV_BYTES = BKEY * D * 2; // K or V
  static constexpr int QT_BYTES = BQ4 * D * 2;  // a Q or dO tile
  static constexpr int Q_OFF = 2 * KV_BYTES;                // Q stages
  static constexpr int O_OFF = Q_OFF + ST * QT_BYTES;       // dO stages
  static constexpr int ROW_OFF = O_OFF + ST * QT_BYTES;     // lse·log2e, Δ
  // (the mask modes: log2 l, Δ and m)
  static constexpr int BAR_OFF = ROW_OFF + ST * 3 * BQ4 * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * ST) * 8 + 1024;
  // MOD: a ring stage of a MIXED bool tile's packed words (4 a query row)
  // past the barriers, so that the other instantiations keep their layout
  static constexpr int W_BYTES = BQ4 * 16;
  static constexpr int W_OFF = (BAR_OFF + (1 + 2 * ST) * 8 + 127) / 128 * 128;
  // MOD: a ring stage's walk entry and its c
  static constexpr int E_OFF = W_OFF + ST * W_BYTES;
  static constexpr int SMEM_MOD = E_OFF + ST * 8 + 1024;
  // DROP: a ring stage of a query tile's keep words (4 a row: the block's
  // 128 keys), past MOD's
  static constexpr int Z_OFF = (E_OFF + ST * 8 + 127) / 128 * 128;
  static constexpr int SMEM_DROP = Z_OFF + ST * W_BYTES + 1024;
};

// Pᵀ = 2^(Sᵀ·sl2 − lse·log2 e) in place, 0 where the key is masked for the
// query (only `edge` tiles test: past kv_len, past the causal diagonal, or
// (WIN) at or below wlo + the query's row, wlo = q_off - window); ls holds
// the tile's lse·log2 e
template <bool WIN>
__device__ __forceinline__ void k4_p(float (&sa)[BQ4 / 2], const float* ls,
                                     bool edge, int c0, int tg, int kvlen,
                                     int causal, int q_off, int q0, int wlo,
                                     float sl2) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const int qi = c * 8 + tg * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        float p = sm90::ex2(fmaf(sa[e], sl2, -(j ? l2.y : l2.x)));
        if (edge) {
          const int key = c0 + 8 * i;
          if (key >= kvlen || (causal && key > q_off + q0 + qi + j) ||
              (WIN && key <= wlo + q0 + qi + j))
            p = 0.f;
        }
        sa[e] = p;
      }
  }
}

// DROP: the keep words of a streamed query tile's row qi in the stage (4
// a row over the block's 128 keys), the thread's word of them at zq[qi·4]
// (zq = the stage's words + its keys' word) shifted so that bits 0 and 8
// are its keys c0 and c0 + 8 (zsh = c0 % 32)
__device__ __forceinline__ uint32_t k4_keep(const uint32_t* zq, int qi,
                                            int zsh) {
  return zq[qi * 4] >> zsh;
}

// DROP: dSᵀ = Pᵀ∘(dPᵀ∘Z/keep − Δ) in place of dPᵀ, then Pᵀ∘Z/keep in
// place of Pᵀ (for dv); element (key c0 + 8i, query q0 + 8c + 2·tg + j)
// keeps iff bit 8i of k4_keep(zq, 8c + 2·tg + j, zsh); dl holds the tile's
// Δ, inv = 1/keep
__device__ __forceinline__ void k4_drop_ds(float (&sa)[BQ4 / 2],
                                           float (&dp)[BQ4 / 2],
                                           const float* dl, int tg,
                                           const uint32_t* zq, int zsh,
                                           float inv) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + c * 8 + tg * 2);
    const uint32_t z[2] = {k4_keep(zq, c * 8 + tg * 2, zsh),
                           k4_keep(zq, c * 8 + tg * 2 + 1, zsh)};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const bool kp = (z[j] >> (8 * i)) & 1;
        dp[e] = sa[e] * ((kp ? dp[e] * inv : 0.f) - (j ? d2.y : d2.x));
        sa[e] = kp ? sa[e] * inv : 0.f;
      }
  }
}

// dSᵀ = Pᵀ∘(dPᵀ − Δ) in place of dPᵀ; dl holds the tile's Δ
__device__ __forceinline__ void k4_ds(const float (&sa)[BQ4 / 2],
                                      float (&dp)[BQ4 / 2], const float* dl,
                                      int tg) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + c * 8 + tg * 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dp[4 * c + 2 * i] = sa[4 * c + 2 * i] * (dp[4 * c + 2 * i] - d2.x);
      dp[4 * c + 2 * i + 1] =
          sa[4 * c + 2 * i + 1] * (dp[4 * c + 2 * i + 1] - d2.y);
    }
  }
}

// MOD: the sources of a walked tile's mask entries: a FULL tile's (every
// entry True or the value c; a call without a mask too), or any tile's,
// taken at run time (FULL, else a MIXED bool tile's staged bits or a MIXED
// fp32 tile's mask in place). One loop a source and edge, as K1's
// (csrc/flash_attention.cu), holds more registers than K4 has beside dk
// and dv at d 128
enum { SRC_FULL, SRC_ANY };

// MOD: the scores t of csrc/attn_mask.cuh in place of Sᵀ for (key c0 +
// 8i, query q0 + 8c + 2·tg + j) of query head hq: a FULL tile's entries
// *cvp (0 for a bool mask; the tile's entry at ent), a bool mask's from the
// tile's words staged at ws (4 words a query row, one row for a
// key-padding mask; the thread's keys are bits lk and lk + 8 of word lk /
// 32, lk its first key's place in the block), an fp32 mask read in place
// at mh + query·sq + key·sk (mh = b·sb + hq·sh). The structured test runs
// per element only on an EDGE tile (kv_len, the diagonal, sq, the window
// or segment ids cut it for the group's keys). EXTRA: the queries' segment
// ids at segq against the keys' sgk[i], the bias slope·(k - q - q_off).
// Returns the elements whose t depends on s (bit 4c + 2i + j): dS flows
// only there
template <bool EXTRA, int SRC, bool EDGE>
__device__ __forceinline__ uint32_t k4_scores(
    float (&sa)[BQ4 / 2], int c0, int tg, int q0, int sq, int sk, int kvlen,
    int causal, int q_off, float scale, const am::Mod& md, int bi, int hq,
    const int* segq, const int (&sgk)[2], float slope, const int* ent,
    const float* cvp, const uint32_t* ws) {
  // a FULL tile's c (the tile's entry and c in the stage's slot, ent and
  // cvp), and a hidden key's score: NEG (+ c) beside a mask, -inf without
  // one; an fp32 mask's elements of the (batch, head) from mh
  const bool fl = SRC == SRC_FULL ||
                  (SRC == SRC_ANY && (*ent >> am::TILE_SHIFT) == am::TILE_FULL);
  const float cv = fl ? *cvp : 0.f;
  const float hid = md.p != nullptr ? am::NEG + cv : -INFINITY;
  const long long mh = SRC == SRC_ANY ? bi * md.sb + hq * md.sh : 0;
  const int lk = c0 & 127;   // the thread's first key in its 128-key block
  uint32_t gm = 0;
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const int qi = c * 8 + tg * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const int key = c0 + 8 * i, q = q0 + qi + j;
        bool st = false;
        if constexpr (EDGE) {
          if constexpr (EXTRA)
            st = am::hidden(
                md, key, kvlen, causal, q_off + q,
                segq != nullptr && q < sq && __ldg(segq + q) != sgk[i]);
          else
            st = key >= kvlen || (causal && key > q_off + q);
        }
        const float bias = EXTRA ? slope * (float)(key - q_off - q) : 0.f;
        bool g = !st;
        float t;
        if (fl) {
          t = st ? hid : fmaf(sa[e], scale, bias + cv);
        } else if (md.words != nullptr) {
          const uint32_t w = ws[(md.wq > 1 ? qi + j : 0) * 4 + (lk >> 5)];
          g = ((w >> ((lk & 31) + 8 * i)) & 1) && !st;
          t = g ? fmaf(sa[e], scale, bias) : am::NEG;
        } else if (EDGE && q >= sq) {
          t = -INFINITY;          // a row past sq: no entry to read
        } else {
          const float x =
              __ldg(reinterpret_cast<const float*>(md.p) + mh +
                    (long long)q * md.sq + (long long)key * md.sk);
          t = st ? am::NEG + x : fmaf(sa[e], scale, bias + x);
        }
        if constexpr (EDGE)
          if (q >= sq || key >= sk) {
            t = -INFINITY;
            g = false;
          }
        sa[e] = t;
        gm |= (uint32_t)g << e;
      }
  }
  return gm;
}

// MOD: Pᵀ in place of the scores t in sa and dSᵀ in place of dPᵀ (k4_p and
// k4_ds in one pass): P = 2^((t − m)·log2 e − log2 l), dS = P∘(dP − Δ)
// where t depends on s (gm, k4_scores), 0 elsewhere; ls holds the tile's
// log2 l (+inf for a row whose P is 0: past sq, no key, or a dead row off
// the walk), then Δ, then m. DROP: dSᵀ = Pᵀ∘(dPᵀ∘Z/keep − Δ), then
// Pᵀ∘Z/keep in place of Pᵀ (for dv), Z from the staged keep words as in
// k4_drop_ds (zq, zsh, inv = 1/keep)
template <bool DROP>
__device__ __forceinline__ void k4_pds_mod(float (&sa)[BQ4 / 2],
                                           float (&dp)[BQ4 / 2],
                                           const float* ls, uint32_t gm,
                                           int tg, const uint32_t* zq,
                                           int zsh, float inv) {
#pragma unroll
  for (int c = 0; c < BQ4 / 8; ++c) {
    const int qi = c * 8 + tg * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
    const float2 d2 = *reinterpret_cast<const float2*>(ls + BQ4 + qi);
    const float2 m2 = *reinterpret_cast<const float2*>(ls + 2 * BQ4 + qi);
    uint32_t z[2] = {0, 0};
    if constexpr (DROP) {
      z[0] = k4_keep(zq, qi, zsh);
      z[1] = k4_keep(zq, qi + 1, zsh);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const float p = am::prob(sa[e], j ? m2.y : m2.x, j ? l2.y : l2.x);
        float d = dp[e], pd = p;
        if constexpr (DROP) {
          const bool kp = (z[j] >> (8 * i)) & 1;
          d = kp ? d * inv : 0.f;
          pd = kp ? p * inv : 0.f;
        }
        dp[e] = (gm >> e) & 1 ? p * (d - (j ? d2.y : d2.x)) : 0.f;
        sa[e] = pd;
      }
  }
}

template <int D, bool WIN, bool DROP, bool MOD = false>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                   int sq, int sk, int h, int nkv, int causal, int q_off,
                   int window, float scale, int group, float inv,
                   const __grid_constant__ am::ModTile mt,
                   const __grid_constant__ CUtensorMap mz) {
  using C = Dkv<D>;
  constexpr int ST = C::ST;
  constexpr int BKEY = C::BKEY;
  // the general mode (MOD) reads its window from md and walks the tiles of
  // its bounds: there WIN picks the loop with the window, segment ids and
  // ALiBi (EXTRA), and the windowed walk (WND) is the WIN kernel's alone
  constexpr bool WND = WIN && !MOD;
  constexpr bool EXTRA = WIN && MOD;
  const am::Mod& md = mt.m;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = sm90::align1024(smem_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = sm + C::KV_BYTES;
  uint8_t* Qs = sm + C::Q_OFF;                 // stage s at s·QT_BYTES
  uint8_t* Os = sm + C::O_OFF;
  float* rows = reinterpret_cast<float*>(sm + C::ROW_OFF);  // stage s at
                                                            // s·2·BQ4
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;

  // (batch, kv head) units in groups whose heads' Q and dO stay in L2, the
  // heaviest key blocks (under causal masking the first: they see the most
  // queries) first inside a group
  const int nkt = (sk + BKEY - 1) / BKEY;
  const sm90::BlockOrder ord =
      sm90::block_order(blockIdx.x, gridDim.x / nkt, nkt, group);
  const int k0 = ord.tile * BKEY;
  const int kh = ord.unit % nkv, bi = ord.unit / nkv;
  const int n_rep = h / nkv;
  int kvlen = sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[bi], sk));
  // the first query row that can see a key of this block
  const int nqt = (sq + BQ4 - 1) / BQ4;
  int qt0 = k0 >= kvlen ? nqt : (causal ? max(0, k0 - q_off) : 0) / BQ4;
  // WND: the query tiles end at the one of the last row that sees the
  // block's last key, row k0 + BKEY - 1 + window - 1 - q_off
  int qhi = nqt;
  if (WND) {
    const int last = k0 + BKEY + window - 2 - q_off;
    qhi = last < 0 ? 0 : min(nqt, last / BQ4 + 1);
  }
  const int wlo = WND ? q_off - window : 0;
  // MOD: this key block's walk of query tiles, [n, entry 1 … entry n]
  // (the union over the kv head's query heads; entry: tile | class), the
  // entries' c at the same index of wc; each query head walks it, the
  // producer passing a tile's entry and c in its stage's slot (went, wcv)
  const int* walk = nullptr;
  const float* wc = nullptr;
  if constexpr (MOD) {
    const long long at =
        bi * md.lsb + kh * md.lsh + (long long)ord.tile * md.ln;
    walk = md.list + at;
    wc = md.cval + at;
    qt0 = 0;
    qhi = walk[0];
  }
  const int per_head = max(0, qhi - qt0);
  uint8_t* Ws = sm + C::W_OFF;          // MOD: stage s at s·W_BYTES
  int* went = reinterpret_cast<int*>(sm + C::E_OFF);
  float* wcv = reinterpret_cast<float*>(sm + C::E_OFF + ST * 4);
  uint8_t* Zs = sm + C::Z_OFF;          // DROP: stage s at s·W_BYTES

  if (threadIdx.x == 0) {
    sm90::mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform for the compiler, so that setmaxnreg applies per group
  const int wg = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  if (wg == 2) {
    // ---- producer: warp 8 streams, warps 9-11 only give up registers ----
    sm90::setmaxnreg_dec<24>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 288 && per_head > 0) {
      if (lane == 0) {
        sm90::tma_prefetch_map(&mq);
        sm90::tma_prefetch_map(&mo);
        if constexpr (DROP) sm90::tma_prefetch_map(&mz);
        sm90::mbar_arrive_tx(kvbar, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          sm90::tma_load_4d(Ks + c * BKEY * 128, &mk, kvbar, c * 64, kh, k0,
                            bi);
          sm90::tma_load_4d(Vs + c * BKEY * 128, &mv, kvbar, c * 64, kh, k0,
                            bi);
        }
      }
      int it = 0;
      if constexpr (MOD) {
        // the walk, per query head; a dead row off the walk takes log2 l =
        // +inf (its P, dSᵀ 0: its dv is the epilogue's dsum / sk); a MIXED
        // tile of a bool mask brings its packed words on the full barrier
        const uint32_t wbytes = (md.wq > 1 ? BQ4 : 1) * 16;
        if (lane == 0 && md.words != nullptr)
          sm90::tma_prefetch_map(&mt.words);
        int e_nx = walk[1];    // the next tile's entry and c, a tile ahead
        float c_nx = wc[1];
        for (int r = 0; r < n_rep; ++r) {
          const int hi = kh * n_rep + r;
          const float* db = delta + ((long)bi * h + hi) * sq;
          for (int x = 0; x < per_head; ++x, ++it) {
            const int s = it % ST, e = e_nx;
            const float cv = c_nx;
            e_nx = walk[1 + (x + 1 < per_head ? x + 1 : 0)];
            c_nx = wc[1 + (x + 1 < per_head ? x + 1 : 0)];
            const int qt = am::entry_tile(e), q0 = qt * BQ4;
            const bool stage = md.words != nullptr &&
                               (e >> am::TILE_SHIFT) == am::TILE_MIXED;
            const unsigned long long dw =
                md.dead != nullptr
                    ? md.dead[bi * md.dsb + hi * md.dsh + qt]
                    : 0ull;
            sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
            float* ls = rows + s * 3 * BQ4;
            for (int i = lane; i < BQ4; i += 32) {
              const int q = q0 + i;
              am::row_stats(lse + 2 * ((long)bi * h + hi) * sq, q, sq,
                            ls[2 * BQ4 + i], ls[i]);
              if ((dw >> i) & 1) ls[i] = INFINITY;
              ls[BQ4 + i] = q < sq ? db[q] : 0.f;
            }
            if (lane == 0) {
              went[s] = e;
              wcv[s] = cv;
              sm90::mbar_arrive_tx(&full[s],
                                   2 * C::QT_BYTES + (stage ? wbytes : 0) +
                                       (DROP ? C::W_BYTES : 0));
#pragma unroll
              for (int c = 0; c < C::NCH; ++c) {
                sm90::tma_load_4d(Qs + s * C::QT_BYTES + c * BQ4 * 128, &mq,
                                  &full[s], c * 64, hi, q0, bi);
                sm90::tma_load_4d(Os + s * C::QT_BYTES + c * BQ4 * 128, &mo,
                                  &full[s], c * 64, hi, q0, bi);
              }
              if (stage)
                sm90::tma_load_4d(Ws + s * C::W_BYTES, &mt.words, &full[s],
                                  k0 / 32, md.wq > 1 ? q0 : 0,
                                  md.wh > 1 ? hi : 0, md.wb > 1 ? bi : 0);
              if constexpr (DROP)   // the tile's keep words, head hi's
                sm90::tma_load_4d(Zs + s * C::W_BYTES, &mz, &full[s],
                                  k0 / 32, q0, hi, bi);
            } else {
              sm90::mbar_arrive(&full[s]);
            }
          }
        }
      } else {
        for (int r = 0; r < n_rep; ++r) {
          const int hi = kh * n_rep + r;
          const float* lb = lse + ((long)bi * h + hi) * sq;
          const float* db = delta + ((long)bi * h + hi) * sq;
          for (int qt = qt0; qt < qhi; ++qt, ++it) {
            const int s = it % ST, q0 = qt * BQ4;
            sm90::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
            float* ls = rows + s * 3 * BQ4;
            for (int i = lane; i < BQ4; i += 32) {
              const int q = q0 + i;
              const float l = q < sq ? lb[q] : NEG_INF;
              ls[i] = l > NEG_INF * 0.5f ? l * 1.4426950408889634f : INFINITY;
              ls[BQ4 + i] = q < sq ? db[q] : 0.f;
            }
            if (lane == 0) {
              sm90::mbar_arrive_tx(&full[s], 2 * C::QT_BYTES +
                                                 (DROP ? C::W_BYTES : 0));
#pragma unroll
              for (int c = 0; c < C::NCH; ++c) {
                sm90::tma_load_4d(Qs + s * C::QT_BYTES + c * BQ4 * 128, &mq,
                                  &full[s], c * 64, hi, q0, bi);
                sm90::tma_load_4d(Os + s * C::QT_BYTES + c * BQ4 * 128, &mo,
                                  &full[s], c * 64, hi, q0, bi);
              }
              if constexpr (DROP)   // the tile's keep words, head hi's
                sm90::tma_load_4d(Zs + s * C::W_BYTES, &mz, &full[s],
                                  k0 / 32, q0, hi, bi);
            } else {
              sm90::mbar_arrive(&full[s]);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: keys k0 + 64·wg … +63 ----
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x & 127, wl = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    // the group's first key, and (SPLIT) its first dk/dv column
    const int kw0 = k0 + (C::SPLIT ? 0 : wg * 64);
    const int col0 = C::SPLIT ? wg * C::NA : 0;
    const int c0 = kw0 + wl * 16 + g;          // keys of the rows i = 0, 1
    const float sl2 = scale * 1.4426950408889634f;
    // DROP: the thread's keep word in a stage's row 0 (keys c0 & ~31 …),
    // and c0's bit in it
    const int zw = (c0 - k0) >> 5, zsh = (c0 - k0) & 31;
    // EXTRA: the segment ids of the keys c0 and c0 + 8, the queries'
    int sgk[2] = {0, 0};
    const int* segq = nullptr;
    if constexpr (EXTRA) {
      if (md.seg_q != nullptr) segq = md.seg_q + (long long)bi * sq;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (c0 + 8 * i < sk)
          sgk[i] = am::seg_id(md.seg_k, (long long)bi * sk + c0 + 8 * i);
    }

    float dva[C::NA / 2], dka[C::NA / 2];
#pragma unroll
    for (int i = 0; i < C::NA / 2; ++i) dva[i] = dka[i] = 0.f;

    if (per_head > 0) {
      // K-major descriptors (K, V rows of this group as A; Q, dO as B) and
      // MN-major ones (dO, Q as B of the dv/dk products, from the group's
      // first column's 64-column tile); a stage is +QT_BYTES >> 4 on the
      // start address
      const int kr = C::SPLIT ? 0 : wg * 64, ct = col0 / 64;
      const uint64_t dK = sm90::desc_sw128(Ks + kr * 128, 16, 1024);
      const uint64_t dV = sm90::desc_sw128(Vs + kr * 128, 16, 1024);
      const uint64_t dQ = sm90::desc_sw128(Qs, 16, 1024);
      const uint64_t dO = sm90::desc_sw128(Os, 16, 1024);
      const uint64_t dQt =
          sm90::desc_sw128(Qs + ct * BQ4 * 128, BQ4 * 128, 1024);
      const uint64_t dOt =
          sm90::desc_sw128(Os + ct * BQ4 * 128, BQ4 * 128, 1024);
      constexpr uint32_t STAGE = C::QT_BYTES >> 4;

      sm90::mbar_wait(kvbar, 0);
      // tile it is query tile qt0 + it % per_head of head it / per_head; a
      // group whose keys no row of the tile can see skips it
      const int n = n_rep * per_head;
      auto skip = [&](int it) {
        const int qa = (qt0 + it % per_head) * BQ4;
        return !MOD && (kw0 >= kvlen || (causal && kw0 > q_off + qa + BQ4 - 1) ||
               (WIN && kw0 + 63 <= wlo + qa));
      };
      // Each pass is self-contained (its products are waited for inside
      // it): no wgmma is in flight across the loop edge, which would make
      // ptxas serialise them. The two consumer groups overlap each other.
      for (int it = 0; it < n; ++it) {
        const int s = it % ST;
        const int q0 = (qt0 + it % per_head) * BQ4;
        sm90::mbar_wait(&full[s], (it / ST) & 1);
        if (!skip(it)) {
          float sa[BQ4 / 2], dp[BQ4 / 2];
          uint32_t pa[BQ4 / 16][4], da[BQ4 / 16][4];
          const float* ls = rows + s * 3 * BQ4;   // lse·log2 e, then Δ
          const bool edge = kw0 + 63 >= kvlen ||
                            (causal && kw0 + 63 > q_off + q0) ||
                            (WIN && kw0 <= wlo + q0 + 63);
          const uint32_t so = s * STAGE;
          issue_hs<D, BKEY, BQ4>(sa, dK, dQ, so);   // Sᵀ
          issue_hs<D, BKEY, BQ4>(dp, dV, dO, so);   // dPᵀ
          sm90::wgmma_wait<0>();
          sm90::fence_regs(sa);
          sm90::fence_regs(dp);
          if constexpr (MOD) {
            // the mask rows, the slope and the scores of query head
            // kh·n_rep + it / per_head
            const int hq = kh * n_rep + it / per_head;
            // the tile (its entry in the stage's slot) and whether it takes
            // the FULL loop without the structured test: no edge (kv_len,
            // the diagonal, sq, the window or segment ids) cuts it for the
            // group's keys
            const int qm = am::entry_tile(went[s]) * BQ4;
            bool ed = kw0 + 63 >= kvlen || (causal && kw0 + 63 > q_off + qm) ||
                      qm + BQ4 > sq;
            if constexpr (EXTRA)
              ed = ed || segq != nullptr ||
                   (md.window > 0 && kw0 <= q_off - md.window + qm + 63);
            const bool full = (went[s] >> am::TILE_SHIFT) == am::TILE_FULL;
            const float slope =
                EXTRA && md.slopes != nullptr ? md.slopes[hq] : 0.f;
#define K4_SCORES(SRC, EDGE)                                                 \
  k4_scores<EXTRA, SRC, EDGE>(                                               \
      sa, c0, tg, qm, sq, sk, kvlen, causal, q_off, scale, md, bi, hq, segq, \
      sgk, slope, went + s, wcv + s,                                         \
      reinterpret_cast<const uint32_t*>(Ws + s * C::W_BYTES))
            uint32_t gm;
            // a FULL tile that no edge cuts (most of a walk) on a loop of
            // its own, and with EXTRA (segment ids cut every tile) a FULL
            // edge tile too; the others through one loop that takes the
            // source at run time (a loop for each source and edge spills
            // at d 128)
            if (full && !ed)
              gm = K4_SCORES(SRC_FULL, false);
            else if (EXTRA && full)
              gm = K4_SCORES(SRC_FULL, true);
            else
              gm = K4_SCORES(SRC_ANY, true);
#undef K4_SCORES
            k4_pds_mod<DROP>(
                sa, dp, ls, gm, tg,
                reinterpret_cast<const uint32_t*>(Zs + s * C::W_BYTES) + zw,
                zsh, inv);
          } else {
            k4_p<WIN>(sa, ls, edge, c0, tg, kvlen, causal, q_off, q0, wlo,
                      sl2);
          }
          if constexpr (MOD) {
          } else if constexpr (DROP) {
            // the keep words of the stage's tile (head kh·n_rep + it /
            // per_head)
            k4_drop_ds(
                sa, dp, ls + BQ4, tg,
                reinterpret_cast<const uint32_t*>(Zs + s * C::W_BYTES) + zw,
                zsh, inv);
          } else {
            k4_ds(sa, dp, ls + BQ4, tg);
          }
          sm90::pack_a<BQ4>(dp, da);
          sm90::pack_a<BQ4>(sa, pa);
          issue_acc<C::NA, BQ4>(dva, pa, dOt + so);
          issue_acc<C::NA, BQ4>(dka, da, dQt + so);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dva);
          sm90::fence_regs(dka);
        }
        sm90::mbar_arrive(&empty[s]);
      }
    }

    const long kv_rs = (long)nkv * D;
    const long kv_base = (long)bi * sk * kv_rs + (long)kh * D + col0;
    const float rsk = __frcp_rn((float)sk);    // MOD: 1 / sk
    bf16* dkb = dk + kv_base;
    bf16* dvb = dv + kv_base;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = c0 + 8 * i;
      if (key < sk) {
#pragma unroll
        for (int c = 0; c < C::NA / 8; ++c) {
          const int col = c * 8 + tg * 2;
          *reinterpret_cast<uint32_t*>(dkb + key * kv_rs + col) =
              sm90::pack_f2(dka[4 * c + 2 * i] * scale,
                      dka[4 * c + 2 * i + 1] * scale);
          if constexpr (MOD) {
            // the dead rows off the walk: dO / sk at every key (dsum · rsk;
            // a reciprocal, no division's slow-path call beside dk and dv)
            float2 a = make_float2(0.f, 0.f);
            if (md.red != nullptr) {
              a = *reinterpret_cast<const float2*>(
                  md.red + ((long)bi * nkv + kh) * D + col0 + col);
              a.x *= rsk;
              a.y *= rsk;
            }
            *reinterpret_cast<uint32_t*>(dvb + key * kv_rs + col) =
                sm90::pack_f2(dva[4 * c + 2 * i] + a.x,
                              dva[4 * c + 2 * i + 1] + a.y);
          } else {
          *reinterpret_cast<uint32_t*>(dvb + key * kv_rs + col) =
              sm90::pack_f2(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]);
          }
        }
      }
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* kv_lens, int b, int sq, int sk, int h, int nkv,
               int causal, int q_off, int window, float scale,
               const void* keep, int keep_ww, float inv, const am::Mod* mod,
               cudaStream_t st) {
  const bool drop = keep != nullptr;
  CUtensorMap mq, mk, mv, mo;
  int err = sm90_map_bshd(&mq, q, b, sq, h, D, BQ4);
  if (!err) err = sm90_map_bshd(&mo, dout, b, sq, h, D, BQ4);
  constexpr int BKEY = Dkv<D>::BKEY;
  if (!err) err = sm90_map_bshd(&mk, k, b, sk > 1 ? sk : 1, nkv, D, BKEY);
  if (!err) err = sm90_map_bshd(&mv, v, b, sk > 1 ? sk : 1, nkv, D, BKEY);
  if (err) return err;
  // window > 0 (with causal): the windowed instantiation; drop: the
  // dropout one; the general argument (mod): the general one, with or
  // without dropout, and with the window, segment ids or ALiBi (WIN) or a
  // dense mask alone. d = 256 has none of them yet: only its plain
  // instantiation is built
  auto kern = flash_bwd_dkv_sm90<D, false, false>;
  if constexpr (D == 256) {
    if (window > 0 || drop || mod) return (int)cudaErrorInvalidValue;
  } else if (mod) {
    if (mod->window > 0 || mod->seg_k || mod->slopes)
      kern = drop ? flash_bwd_dkv_sm90<D, true, true, true>
                  : flash_bwd_dkv_sm90<D, true, false, true>;
    else
      kern = drop ? flash_bwd_dkv_sm90<D, false, true, true>
                  : flash_bwd_dkv_sm90<D, false, false, true>;
  } else {
    kern = window > 0 ? (drop ? flash_bwd_dkv_sm90<D, true, true>
                              : flash_bwd_dkv_sm90<D, true, false>)
                      : (drop ? flash_bwd_dkv_sm90<D, false, true>
                              : flash_bwd_dkv_sm90<D, false, false>);
  }
  // the general argument, and the tensor map of its packed words: boxes of
  // 4 words by a query tile's 64 rows, or 1 row for a key-padding mask
  am::ModTile mt{};
  if (mod) {
    mt.m = *mod;
    if (mod->words != nullptr)
      err = sm90_map_words(&mt.words, mod->words, mod->wb, mod->wh, mod->wq,
                           mod->ww, mod->wq > 1 ? BQ4 : 1);
    if (err) return err;
  }
  // the keep words (drop): boxes of 4 words by a query tile's 64 rows
  CUtensorMap mz{};
  if (drop) err = sm90_map_words(&mz, keep, b, h, sq, keep_ww, BQ4);
  if (err) return err;
  const int smem = drop ? Dkv<D>::SMEM_DROP
                        : mod ? Dkv<D>::SMEM_MOD : Dkv<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // a (batch, kv head) unit streams its n_rep heads' Q and dO
  const int group = sm90_group((long long)(h / nkv) * sq * D * 4);
  const int grid = ((sk + BKEY - 1) / BKEY) * nkv * b;
  kern<<<grid, THREADS, smem, st>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, (const int*)kv_lens, sq, sk, h, nkv, causal, q_off, window,
      scale, group, inv, mt, mz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const void* kv_lens, int b,
                                      int sq, int sk, int h, int nkv, int d,
                                      int causal, int q_off, int window,
                                      float scale, const am::Mod* mod,
                                      const void* keep, int keep_ww,
                                      float inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // window: 0 = none; a window needs causal (the reference's validation)
  if (window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  // keep (or null): the forward's keep words as K1 takes them
  if (keep != nullptr && keep_ww != (sk + 127) / 128 * 4)
    return (int)cudaErrorInvalidValue;
  // mod (or null): the general argument as K1 takes it, its walk lists
  // (`mask_bounds`' dq_list: each 128-row block's 64-key tiles), the
  // packed bool mask and the dead rows' bits (a bool mask); lse the (b, h,
  // sq, 2) pairs
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lens, b, sq, sk,
                          h, nkv, causal, q_off, window, scale, keep,
                          keep_ww, inv, mod, st);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lens, b, sq, sk,
                         h, nkv, causal, q_off, window, scale, keep, keep_ww,
                         inv, mod, st);
  if (d == 256)
    return launch_dq<256>(q, k, v, dout, lse, delta, dq, kv_lens, b, sq, sk,
                          h, nkv, causal, q_off, window, scale, keep,
                          keep_ww, inv, mod, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const void* kv_lens, int b, int sq,
                                       int sk, int h, int nkv, int d,
                                       int causal, int q_off, int window,
                                       float scale, const am::Mod* mod,
                                       const void* keep, int keep_ww,
                                       float inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // window: 0 = none; a window needs causal (the reference's validation)
  if (window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  // keep (or null): the forward's keep words as K1 takes them
  if (keep != nullptr && keep_ww != (sk + 127) / 128 * 4)
    return (int)cudaErrorInvalidValue;
  // mod (or null): as K1 takes it, its walk lists (`mask_bounds`'
  // dkv_list: each key block's 64-row query tiles) and the dead rows' dsum
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, b, sq,
                           sk, h, nkv, causal, q_off, window, scale, keep,
                           keep_ww, inv, mod, st);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, b, sq,
                          sk, h, nkv, causal, q_off, window, scale, keep,
                          keep_ww, inv, mod, st);
  if (d == 256)
    return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, kv_lens, b, sq,
                           sk, h, nkv, causal, q_off, window, scale, keep,
                           keep_ww, inv, mod, st);
  return (int)cudaErrorInvalidValue;
}
