"""Attention: the dispatch, the plain versions, and the flash-attention kernels.

Port of ``paddle_tpu/ops/flash_attention.py``. Layout (batch, seq, heads,
head_dim); GQA when k/v carry fewer heads than q.

* ``_xla_attention`` — the plain version (port of the reference of the same
  name): dense fp32 scores, structured and dense masks, fully-masked rows
  emit 0 where the reference zeroes them.
* ``flash_attention_fwd`` — the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attention.cu`` (K1, replaces the TPU kernel ``_fwd_kernels``,
  ``paddle_tpu/ops/flash_attention.py:526``), and ``flash_attention_fwd_plain``,
  its plain twin in fp32 with the same (out, lse) contract.
* ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` — the wrappers of
  ``csrc/flash_attention_bwd.cu`` (K3 and K4, replace ``_bwd_dq_kernel``
  :668 and ``_bwd_dkv_kernel`` :787); ``flash_attention_bwd`` computes
  Δ = rowsum(dO∘O) and runs both; ``flash_attention_bwd_plain`` is their
  plain twin in fp32.
* ``FlashAttention`` — the ``torch.autograd.Function`` over K1 and K3/K4
  (the reference's ``_flash_vjp_entry`` custom_vjp, :1019-1125).
* ``scaled_dot_product_attention`` — the dispatch. When a gradient is
  needed (grad mode on and q, k or v requires grad) the call goes through
  ``FlashAttention``: on CUDA tensors K1 + K3 + K4, on CPU tensors the
  plain forward and backward. Otherwise CPU tensors take ``_xla_attention``
  and CUDA tensors K1 alone. There is no shape gate (the reference's
  ``_pallas_seq_ok`` is a TPU heuristic): every CUDA call, sq=1 included,
  goes to the kernels, and what they do not take raises. A head dim d
  that is a multiple of 8 up to 256 goes to them at its own width: they
  run at the next kernel width D of 64, 128 and 256 and read the columns
  d … D - 1 as TMA's zero fill (``kernel_width``), so SD-1.5's 40, 80 and
  160 make no copy. Any other d up to 256 is zero-padded to its kernel
  width first, with the scale of the original d (the reference's
  ``_pad_for_kernel``), forward and backward; the plain versions take any
  head dim.

``causal_offset`` is a port-side extension: with ``is_causal`` it sets the
causal limit to ``k_pos <= causal_offset + i`` instead of the bottom-right
alignment ``sk - sq``. The KV-cache prefill passes it (with ``kv_lens``)
where the reference passes the equivalent dense bool mask.

``dropout_p`` with ``key`` is the attention dropout of the reference
(``:135-140``): after the softmax (and after fully-masked rows are
zeroed) each probability is kept with probability 1 - p and the kept ones
are divided by 1 - p. The mask is the reference's CPU mask,
``bernoulli(key, 1 - p, (b, h, sq, sk))`` (``ops.dropout``): element
(bi, hi, q, k) hashes its flat index ``((bi·h + hi)·sq + q)·sk + k``.
The mask is hashed once a call, into packed words (``ops.dropout.
attention_keep_words``: kernel W on the card, bit k % 32 of word k / 32 of
a row the keep bit of key k, 0 past the structured limits), which K1, K3
and K4 read by TMA beside their tiles: no attention kernel hashes. K1
drops the probabilities after its softmax statistics took them undropped
(the lse stays the undropped one, as in the reference, ``:533``); K3 and
K4 apply the same mask: dS = P∘(dP̃∘Z/keep − Δ) with Δ = rowsum(dO∘O) over
the dropped O, dv = (P∘Z/keep)ᵀ·dO. ``FlashAttention`` makes the words in
its forward and saves them for K3 and K4; a raw K1, K3 or K4 call given
none makes them itself. Each kernel drops in an instantiation of its own
(``DROP``), so the kernels without dropout run the code they ran before.
``scaled_dot_product_attention`` draws one key a call from
``next_rng_key("dropout")`` on every path, as the reference does on both
of its paths (``:137``, ``:995``), so the streams advance alike on the CPU
and on the card.

``window`` (``window_size`` at the dispatch) is the causal sliding window
of the reference (Mistral): the query at absolute position
``p = off + i`` sees the keys ``p - window < k <= p``, i.e. the
reference's ``q_pos + off - k_pos < window`` (``:79-84``, ``:411-412``).
It needs ``is_causal`` and ``window >= 1``. K1, K3 and K4 compute it, each
in a windowed instantiation that skips the tiles wholly outside the window
(K1 and K3 the key tiles below the block's first visible key, K4 the query
tiles past the last row that sees its block's last key). On the card a
windowed call launches the windowed kernels or raises: it never runs
without the window and never falls back to a plain version.

``attn_mask`` is the reference's dense mask, bool (False hides a key) or
float (added to the scaled score), broadcast right-aligned against
``(b, h, sq, sk)`` as ``jnp.where`` does (2-D ``(sq, sk)``, 3-D
``(h|1, sq, sk)``, any dim 1). The contract is ``_xla_attention``'s: a
hidden key scores ``NEG_INF``, a float mask adds in fp32 after the
structured masks put ``NEG_INF`` on their keys, and a row whose every key
is hidden by a bool mask takes the uniform softmax over all sk keys (the
mean of v; the reference's Pallas kernel gives 0 there, ROADMAP Queue C).
K1, K3 and K4 compute it in their general instantiations (below; kernel
widths 64 and 128; csrc/attn_mask.cuh), each block walking the tiles of
``mask_bounds`` (the device-side port of the reference's
``_mask_block_bounds``) as
per-tile lists that skip EMPTY tiles, read no mask on FULL ones and a bool
mask's packed words (``mask_words``) on MIXED ones (an fp32 mask's MIXED
tiles read it in place through four element strides). A bool mask's dead
rows are off K1's and K4's walks when there is no dropout (the mean of v
and dO / sk to dv, ``dead_row_sums``) and off K3's always (dq = 0). The bounds of the last call are cached
(``_call_bounds``): the layers of a step share one mask. The mask mode keeps a
row's statistics as the pair (m, log l), shape (b, h, sq, 2), in place of
the lse: a float mask can put a whole row at −1e10 and a bool mask at
−1e30, where an fp32 lse m + log l loses log l, and with it the backward's
1/l.

``seg_q`` / ``seg_k`` (``segment_ids`` / ``kv_segment_ids`` at the
dispatch) are the reference's packed-sequence ids, int32 (b, sq) and
(b, sk): a key whose id differs from the query's is hidden like the other
structured masks (``:91-93``). ``alibi_slopes`` (h,) fp32 is the reference's
ALiBi: with ``is_causal`` the scaled score gains ``slope_h · (k_pos − q_pos −
off)``, ``off`` the causal offset, before every mask; the slopes get no
gradient (``:203-217``). A row that no key reaches through the structured
masks gives 0. The dense mask, the segment ids and ALiBi run on the card in
the general mode of K1, K3 and K4 (``MOD``, with or without dropout; kernel
widths 64 and 128), whose modifiers are runtime fields of one argument
(csrc/attn_mask.cuh ``am::Mod``): the mask, the window, the segment ids and
the slopes, in any combination, with the mask mode's (m, log l) pairs and
its natural-domain softmax. One instantiation takes the window, segment ids
or ALiBi; a dense mask alone runs a leaner one, picked from the argument. ``mask_bounds`` gives every such call
its tiles, the window folded into the structured limits; a block holding a
dead row that stays on the walk takes every key tile, later ones included. Any of these modes, the
window or dropout at kernel width 256 raises (ROADMAP Queue B rows 1-3).

``flash_fwd_lse`` is the reference's (out, lse) forward (``:1177-1215``)
with a differentiable lse: its cotangent enters Δ = rowsum(dO∘O) − g_lse,
which K3 and K4 take as they take Δ. ``flash_attention`` is the reference's
``paddle.nn.functional.flash_attention`` (``:144``): (out, None).
"""

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import dropout as drop_ops
from paddle_tpu_torch.ops.dropout import _pack_bits

NEG_INF = -1e30
# the device type whose tensors the kernels take (a test sets "meta" to run
# the wrappers' checks and argument marshalling up to the C call)
KERNEL_DEVICE = "cuda"
# the kernel widths K1, K3 and K4 are built for (the reference's kernel
# widths, :351); at 256 only their windowless, dropout-free kernels. A head
# dim that is a multiple of 8 up to 256 runs at the next of them
# (kernel_width), at its own width in memory; the dispatch zero-pads any
# other d <= 256 (_pad_head_dim)
FWD_DIMS = (64, 128, 256)
# the kernels' tiles, which the mask bounds count in: K1 and K3 walk 128-
# (K1) or 64-key (K3) tiles for blocks of 128 query rows, K4 64-row query
# tiles for blocks of 128 keys
BLOCK_ROWS, K1_KEYS, K3_KEYS = 128, 128, 64
K4_KEYS, K4_ROWS = 128, 64


def kernel_width(d):
    """The kernel width D that runs head dim d: the next of FWD_DIMS at or
    above d, for a d the kernels read in place (a multiple of 8, 8 … 256:
    a TMA row stride of d·2 bytes must be a multiple of 16); None for any
    other d."""
    if d % 8 or not 8 <= d <= 256:
        return None
    return next(t for t in FWD_DIMS if t >= d)


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _check_window(window, is_causal):
    """The reference's validation of window_size (:196-202)."""
    if window is None:
        return None
    window = int(window)
    if not is_causal:
        raise ValueError("window_size requires is_causal=True (causal "
                         "sliding window)")
    if window < 1:
        raise ValueError(f"window_size must be >= 1, got {window}")
    return window


def _check_segments(seg_q, seg_k, sq, sk):
    """The reference's pairing of segment_ids / kv_segment_ids (:186-195):
    (seg_q, seg_k), seg_k defaulting to seg_q when sq == sk."""
    if seg_k is None and seg_q is not None:
        if sq != sk:
            raise ValueError(
                "segment_ids alone requires sq == sk; pass kv_segment_ids "
                f"explicitly for cross-attention (sq={sq}, sk={sk})")
        seg_k = seg_q
    if (seg_q is None) != (seg_k is None):
        raise ValueError("segment_ids and kv_segment_ids must be given "
                         "together (or segment_ids alone when sq == sk)")
    return seg_q, seg_k


def _check_alibi(alibi_slopes, is_causal, h, device):
    """The reference's validation of alibi_slopes (:203-217): causal only,
    shape (h,); fp32 with no gradient (the slopes are constants)."""
    if alibi_slopes is None:
        return None
    if not is_causal:
        raise ValueError(
            "alibi_slopes requires is_causal=True (the ALiBi bias is "
            "defined over causal distances; a non-causal form would "
            "reward distant FUTURE keys)")
    slopes = torch.as_tensor(alibi_slopes, device=device).detach().to(
        torch.float32)
    if tuple(slopes.shape) != (h,):
        raise ValueError(f"alibi_slopes must be (num_heads,)=({h},), got "
                         f"{tuple(slopes.shape)}")
    return slopes


def _alibi_bias(slopes, sq, sk, causal_offset, dtype):
    """(1, h, sq, sk): slope_h · (k_pos − q_pos − off) in `dtype`."""
    off = sk - sq if causal_offset is None else int(causal_offset)
    dev = slopes.device
    dist = (torch.arange(sk, device=dev)[None, :]
            - (torch.arange(sq, device=dev)[:, None] + off)).to(dtype)
    return slopes.to(dtype)[None, :, None, None] * dist[None, None]


def _structured_mask(sq, sk, is_causal, kv_lens, causal_offset, device,
                     window=None, seg_q=None, seg_k=None):
    """Dense (b|1, 1, sq, sk) bool mask of the structured arguments."""
    window = _check_window(window, is_causal)
    masks = []
    if is_causal:
        off = sk - sq if causal_offset is None else int(causal_offset)
        q_pos = torch.arange(sq, device=device)[:, None] + off
        k_pos = torch.arange(sk, device=device)[None, :]
        masks.append((k_pos <= q_pos)[None, None])
        if window is not None:
            masks.append((k_pos > q_pos - window)[None, None])
    if kv_lens is not None:
        kl = torch.as_tensor(kv_lens, device=device).reshape(-1)
        masks.append((torch.arange(sk, device=device)[None, :]
                      < kl[:, None])[:, None, None, :])
    if seg_q is not None:
        sq_ids = torch.as_tensor(seg_q, device=device)
        sk_ids = torch.as_tensor(seg_k, device=device)
        masks.append((sq_ids[:, :, None] == sk_ids[:, None, :])[:, None])
    if not masks:
        return None
    m = masks[0]
    for extra in masks[1:]:
        m = m & extra
    return m


def dense_mask(attn_mask, b, h, sq, sk, device=None):
    """The dense mask as the kernels and the plain twins take it: a 4-d
    view whose dims are each 1 or (b, h, sq, sk), right-aligned as
    ``jnp.where`` broadcasts it; bool stays bool, any other dtype becomes
    fp32 (exact for bf16 and fp16, as the reference's ``_kernel_mask``).
    Raises on a shape that does not broadcast."""
    m = torch.as_tensor(attn_mask, device=device)
    if m.dim() > 4 or any(n not in (1, t) for n, t in zip(
            m.shape[::-1], (sk, sq, h, b))):
        raise ValueError(f"attn_mask of shape {tuple(m.shape)} does not "
                         f"broadcast to (b, h, sq, sk) = {(b, h, sq, sk)}")
    m = m.reshape((1,) * (4 - m.dim()) + tuple(m.shape))
    return m if m.dtype == torch.bool else m.float()


def _visible_keys(b, sq, sk, is_causal, kv_lens, causal_offset, device):
    """(b|1, sq): the keys [0, n) the structured masks leave each row."""
    vis = torch.full((1, sq), sk, dtype=torch.int64, device=device)
    if kv_lens is not None:
        kl = torch.as_tensor(kv_lens, device=device).reshape(-1)
        vis = torch.minimum(vis, kl.to(torch.int64).clamp(0, sk).expand(
            b)[:, None])
    if is_causal:
        off = sk - sq if causal_offset is None else int(causal_offset)
        vis = torch.minimum(vis, (torch.arange(sq, device=device) + off
                                  + 1).clamp(min=0)[None])
    return vis


def _window_start(sq, sk, causal_offset, window, device):
    """(1, sq): each row's first key the window leaves (0 without one),
    at most sk."""
    if window is None:
        return torch.zeros((1, sq), dtype=torch.int64, device=device)
    off = sk - sq if causal_offset is None else int(causal_offset)
    return (torch.arange(sq, device=device) + off - window + 1).clamp(
        0, sk)[None]


def _dead_rows(live, lo, hi, seg_q, seg_k):
    """(B, mh, sq) bool: the rows that some key reaches through the
    structured masks (keys [lo, hi) of (b|1, sq) lo, hi, and equal segment
    ids) but no live one. `live` (mb, mh, mq, sk) is the dense mask's
    valid entries. A key-padding mask (mq = 1) without segment ids counts
    its live keys by a prefix sum; any other form tests (sq, sk) at once."""
    mb, mh, mq, sk = live.shape
    dev = live.device
    if mq == 1 and seg_q is None:
        csum = torch.nn.functional.pad(
            live[:, :, 0].to(torch.int32).cumsum(-1), (1, 0))  # (mb, mh, sk+1)
        nb = max(mb, lo.shape[0], hi.shape[0])
        csum = csum.expand(nb, mh, sk + 1)
        at = lambda i: torch.gather(csum, -1, i[:, None].expand(
            nb, mh, i.shape[-1]))
        lo = torch.minimum(lo, hi)
        return (hi > lo)[:, None] & (at(hi) == at(lo))
    keys = torch.arange(sk, device=dev)
    reach = ((keys >= lo[..., None]) & (keys < hi[..., None]))[:, None]
    if seg_q is not None:
        reach = reach & (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
    return reach.any(-1) & ~(reach & live).any(-1)


def _tiles_any(x, n, t):
    """(..., n·t) bool padded with False, then any over tiles of t along
    the last axis: (..., n)."""
    buf = torch.zeros(x.shape[:-1] + (n * t,), dtype=torch.bool,
                      device=x.device)
    buf[..., :x.shape[-1]] = x
    return buf.reshape(x.shape[:-1] + (n, t)).any(-1)


def _first_last(x, empty):
    """(lo, hi): the first True along the last axis and one past the last
    one; (empty, 0) where there is none."""
    n = x.shape[-1]
    has = x.any(-1)
    lo = torch.where(has, x.to(torch.uint8).argmax(-1), empty)
    hi = torch.where(has, n - x.flip(-1).to(torch.uint8).argmax(-1), 0)
    return lo, hi


def _pairs(lo, hi, shape):
    """int32 (*shape, 2) of [lo, hi), an empty range as (0, 0)."""
    empty = lo >= hi
    lo = torch.where(empty, 0, lo)
    hi = torch.where(empty, 0, hi)
    return torch.stack([lo.expand(shape), hi.expand(shape)],
                       -1).to(torch.int32).contiguous()


# A tile's class in the walks of K1 and K4's general mode, and the walk
# entry's layout: tile | class << TILE_SHIFT
TILE_EMPTY, TILE_FULL, TILE_MIXED = 0, 1, 2
TILE_SHIFT = 24


def mask_words(mask):
    """A bool (mb, mh, mq, sk) mask packed into uint32 words (as int32)
    (mb, mh, mq, W): bit i of word w is key 32w + i, W = ceil(sk / 32)
    rounded up to a multiple of 4, so that every row is 16-byte aligned for
    TMA. A (b, 1, 1, sk) key-padding mask packs to b·W words."""
    nw = drop_ops.keep_words_width(mask.shape[-1])
    return _pack_bits(mask, nw * 32).view(torch.int32)


def _walk_lists(cls, c):
    """Per block (the last axis: its tiles' classes, (…, n)), the compact
    walk of its non-EMPTY tiles in increasing order: int32 (…, 1 + n),
    [count, tile | class << TILE_SHIFT, …], and fp32 (…, 1 + n), each
    entry's c at the same index (entries past the count are 0)."""
    n = cls.shape[-1]
    ne = cls != TILE_EMPTY
    order = torch.argsort((~ne).to(torch.int8), dim=-1, stable=True)
    ent = order.to(torch.int32) | (torch.gather(cls, -1, order).to(
        torch.int32) << TILE_SHIFT)
    cv = torch.gather(c, -1, order)
    count = ne.sum(-1, keepdim=True, dtype=torch.int32)
    live = torch.arange(n, device=cls.device) < count
    ent = torch.where(live, ent, 0)
    cv = torch.where(live, cv, 0.0)
    return (torch.cat([count, ent], -1).contiguous(),
            torch.cat([torch.zeros_like(cv[..., :1]), cv], -1).contiguous())


def _key_pairs(x, fill, op):
    """x (..., n) reduced by `op` over pairs of neighbouring key tiles,
    (..., ceil(n / 2)); an odd last tile pairs with `fill`: K3's 64-key
    tiles into the 128-key tiles of K1 and K4."""
    if x.shape[-1] % 2:
        x = torch.cat([x, torch.full_like(x[..., :1], fill)], -1)
    return op(x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), -1)


def _tile_classes(mask, b, h, nkv, sq, sk, vis, wlo, dead, walk_dead):
    """The class of every tile of K1's grid (128-row blocks × 128-key
    tiles, (B, mh, nqb, nk)), of K3's (128-row blocks × 64-key tiles,
    (B, mh, nqb, nk3)) and of K4's (128-key blocks × 64-row query tiles,
    the union over a kv head's query heads: (B, mh', nkb, nqt)), with each
    tile's c (fp32 masks). The rows that count are those some key reaches
    through kv_lens, causal and the window ([wlo, vis)) that are not dead;
    a tile is EMPTY when no counting row has a valid entry (bool True,
    float not −inf) at a key it reaches; FULL when every counting row's
    reached entries are True (bool), or every entry of the tile's rows
    equals one value c (fp32); MIXED otherwise. Without a mask (segment ids
    or ALiBi alone) every tile with a reached key is FULL: no entry to
    read. Each row's counts are taken once, at K3's 64-key tiles, and
    K1's and K4's 128-key tiles are pairs of them.
    `walk_dead`: a block holding a dead row takes every tile as MIXED (K1),
    and every query tile holding one is MIXED in every key block (K4). K3
    does so for a float mask's dead rows only: a bool mask's dead row has
    dq = 0 (no score of it depends on s), with or without dropout, so it
    never counts there."""
    dev = vis.device
    nk = -(-sk // K3_KEYS)
    nqb, nqt = -(-sq // BLOCK_ROWS), -(-sq // K4_ROWS)
    t0 = torch.arange(nk, device=dev) * K3_KEYS
    t1 = torch.clamp(t0 + K3_KEYS, max=sk)
    hi = torch.minimum(torch.maximum(vis[..., None], t0), t1)   # (vb, sq, nk)
    lo = torch.minimum(torch.maximum(wlo[..., None], t0), hi)
    nvis = (hi - lo)[:, None]                              # (vb, 1, sq, nk)
    reach = (vis > wlo)[:, None]                           # (vb, 1, sq)
    count = reach & ~dead
    f32 = mask is not None and mask.dtype != torch.bool
    if mask is None:
        ne_row, full_row = nvis > 0, torch.zeros((), dtype=torch.bool,
                                                 device=dev)
    else:
        ok = mask if not f32 else mask != float("-inf")
        csum = torch.nn.functional.pad(ok.to(torch.int32).cumsum(-1), (1, 0))
        bx = max(csum.shape[0], hi.shape[0])
        csum = csum.expand(bx, csum.shape[1], sq, sk + 1)
        at = lambda i: torch.gather(csum, -1, i[:, None].expand(
            bx, csum.shape[1], sq, nk).long())
        nok = at(hi) - at(lo)
        ne_row = nok > 0
        full_row = nok == nvis
    bx = max(ne_row.shape[0], count.shape[0])
    mh = ne_row.shape[1] if mask is None else mask.shape[1]
    mh = max(mh, count.shape[1])
    shape = (bx, mh, sq, nk)
    ne_row = (ne_row & count[..., None]).expand(shape)
    full_row = (full_row | ~count[..., None]).expand(shape)
    if f32:
        # the tile's min and max entry over each of its rows' keys
        pad = nk * K3_KEYS - sk
        mn = torch.nn.functional.pad(mask, (0, pad), value=math.inf)
        mx = torch.nn.functional.pad(mask, (0, pad), value=-math.inf)
        mn = mn.reshape(mask.shape[:3] + (nk, K3_KEYS)).amin(-1)
        mx = mx.reshape(mask.shape[:3] + (nk, K3_KEYS)).amax(-1)
        mn = mn.expand(bx, mh, mask.shape[2], nk)
        mx = mx.expand(bx, mh, mask.shape[2], nk)

    def rows(x, n, t, fill, op):
        """x (B, mh, sq|1, nk) reduced by `op` over row groups of t: (B, mh,
        n, nk); rows past sq take `fill`."""
        if x.shape[2] == 1:
            return x.expand(x.shape[0], x.shape[1], n, x.shape[3])
        buf = torch.full(x.shape[:2] + (n * t, x.shape[3]), fill,
                         dtype=x.dtype, device=dev)
        buf[:, :, :x.shape[2]] = x
        return op(buf.reshape(x.shape[:2] + (n, t, x.shape[3])), 3)

    # (ne, full, min, max) of each (row group, 64-key tile), and of each
    # (row group, 128-key tile): the reductions commute
    fills = ((False, torch.any), (True, torch.all), (math.inf, torch.amin),
             (-math.inf, torch.amax))

    def grid(n, t):
        xs = (ne_row, full_row) + ((mn, mx) if f32 else ())
        return [rows(x, n, t, f, op) for x, (f, op) in zip(xs, fills)] + \
            [None] * (0 if f32 else 2)

    def pairs(g):
        return [None if x is None else _key_pairs(x, f, op)
                for x, (f, op) in zip(g, fills)]

    def classes(ne, full, lo_v, hi_v, dead_t, walk):
        c = torch.zeros(ne.shape, device=dev)
        if f32:
            full = lo_v == hi_v
            c = torch.where(full, lo_v, 0.0)
        elif mask is None:
            full = torch.ones_like(ne)
        cls = torch.where(ne, torch.where(full, TILE_FULL, TILE_MIXED),
                          TILE_EMPTY).to(torch.int32)
        if walk:
            cls = torch.where(dead_t, TILE_MIXED, cls)
            c = torch.where(dead_t, 0.0, c)
        return cls, c

    dead_b = _tiles_any(dead, nqb, BLOCK_ROWS)[..., None]      # (B, mh, nqb)
    g3 = grid(nqb, BLOCK_ROWS)                                 # (., nqb, nk)
    cls3, c3 = classes(*g3, dead_b, f32)
    cls1, c1 = classes(*pairs(g3), dead_b, walk_dead)
    ne4, full4, lo4, hi4 = pairs(grid(nqt, K4_ROWS))           # (., nqt, nkb)
    dead_t = _tiles_any(dead, nqt, K4_ROWS).expand(bx, mh, nqt)
    if mh == h and nkv < h:   # a kv head walks its query heads' union
        u = lambda x, op: op(x.reshape(bx, nkv, h // nkv, *x.shape[2:]), 2)
        ne4, full4 = u(ne4, torch.any), u(full4, torch.all)
        if f32:
            lo4, hi4 = u(lo4, torch.amin), u(hi4, torch.amax)
        dead_t = u(dead_t, torch.any)
    cls4, c4 = classes(ne4, full4, lo4, hi4, dead_t[..., None], walk_dead)
    return cls1, c1, cls3, c3, cls4.transpose(2, 3), c4.transpose(2, 3)


class _Bounds(dict):
    """``mask_bounds``' result. Its [lo, hi) hull pairs ``fwd``, ``dq`` and
    ``dkv`` are computed at their first read: no kernel reads them (each
    walks its list), and they would double the host time of a call."""

    def __init__(self, hulls):
        super().__init__()
        self._hulls = hulls

    def __missing__(self, key):
        if self._hulls is None or key not in ("fwd", "dq", "dkv"):
            raise KeyError(key)
        self.update(self._hulls())
        self._hulls = None
        return self[key]


def mask_bounds(mask, b, h, nkv, sq, sk, is_causal=False, kv_lens=None,
                causal_offset=None, window=None, seg_q=None, seg_k=None,
                device=None, dropout=False):
    """The tiles each block of K1, K3 and K4 walks in their general mode:
    the reference's ``_mask_block_bounds`` (:445, all-masked prefix and
    suffix blocks skipped, per row block or, ``axis_q=False``, per key
    block) at the port kernels' own tiles, computed on the device with no
    host sync. `mask` is ``dense_mask``'s view, or None (segment ids or
    ALiBi alone: the structured limits only; `device` then names the
    device). Returns int32 [lo, hi) pairs: ``fwd`` (b, h, ceil(sq/128), 2)
    of K1's 128-key tiles, ``dq`` the same of K3's 64-key tiles, ``dkv``
    (b, nkv, ceil(sk/128), 2) of K4's 64-row query tiles, the union over a
    kv head's query heads (no kernel reads these hulls: each walks its
    list, below; they are computed at their first read, ``_Bounds``).

    A tile is left out only when no entry can change a row: every entry
    bool False or float −inf, or hidden by the structured masks (kv_lens,
    causal, the window), which are folded in; segment ids skip no tile. A
    "dead" row, some key visible to the structured masks (segment ids
    included) but none of them valid (bool True, or a float entry above
    NEG_INF / 2), takes the softmax over every key (the uniform one for a
    bool mask: the mean of v), so its row block walks every key tile, past
    its window and its diagonal, and its query tile lies in every key
    block's range.

    The kernels walk lists (``_tile_classes``, ``_walk_lists``):
    ``fwd_list`` (B, mh, ceil(sq/128), 1 + ceil(sk/128)) each 128-row
    block's non-EMPTY 128-key tiles (K1), ``dq_list`` (B, mh,
    ceil(sq/128), 1 + ceil(sk/64)) each 128-row block's non-EMPTY 64-key
    tiles (K3), ``dkv_list`` (B, mh', ceil(sk/128), 1 + ceil(sq/64)) each
    128-key block's 64-row query tiles (K4; mh' = nkv when the mask has a
    head per query head under GQA: the union), each entry ``tile | class
    << TILE_SHIFT`` with its c in ``fwd_c`` / ``dq_c`` / ``dkv_c``, and
    the classes themselves in ``fwd_cls`` / ``dq_cls`` / ``dkv_cls``; a
    broadcast dim stays 1. With a bool mask and no ``dropout``
    (``dead_off``) a dead row leaves K1's and K4's walks: K1 writes it as
    the mean of v and K4 adds its dO / sk to every dv row, so a block of
    dead rows walks nothing; otherwise a block holding a dead row walks
    every tile as MIXED. A bool mask's dead row leaves K3's walk with or
    without dropout (its dq is 0: K3 gives it P = 0); a float mask's dead
    row keeps its block on every tile, as MIXED. ``dead`` (B, mh, sq) flags the dead rows, ``dead_bits``
    packs them 64 rows a word (int64), ``dead_any`` says on the device
    whether there is one, and ``words`` is a bool mask packed by
    ``mask_words`` (None for an fp32 mask), which MIXED tiles read."""
    dev = mask.device if mask is not None else torch.device(device)
    window = _check_window(window, is_causal)
    vis = _visible_keys(b, sq, sk, is_causal, kv_lens, causal_offset, dev)
    wlo = _window_start(sq, sk, causal_offset, window, dev)
    if mask is None:
        skip_ok = torch.ones((1, 1, 1, sk), dtype=torch.bool, device=dev)
        dead = torch.zeros((1, 1, sq), dtype=torch.bool, device=dev)
    else:
        if mask.dtype == torch.bool:
            skip_ok, live = mask, mask
        else:
            skip_ok = mask != float("-inf")   # NaN stays in
            live = mask > NEG_INF * 0.5
        mb, mh, mq = mask.shape[:3]
        skip_ok = skip_ok.expand(mb, mh, mq, sk)
        dead = _dead_rows(live.expand(mb, mh, mq, sk), wlo, vis, seg_q,
                          seg_k)                            # (B, mh, sq)
    mb, mh, mq = skip_ok.shape[:3]

    def hulls():
        """The [lo, hi) pairs ``fwd``, ``dq``, ``dkv``."""
        nqb = -(-sq // BLOCK_ROWS)
        nk3 = -(-sk // K3_KEYS)
        nk1 = -(-sk // K1_KEYS)
        dead_b = _tiles_any(dead, nqb, BLOCK_ROWS)              # (B, mh, nqb)
        tiles = _tiles_any(skip_ok, nk3, K3_KEYS)          # (mb, mh, mq, nk3)
        if mq != 1:
            tiles = _tiles_any(tiles.transpose(2, 3), nqb,
                               BLOCK_ROWS).transpose(2, 3)  # (., nqb, nk3)
        lo3, hi3 = _first_last(tiles, nk3)
        # the structured limits of each block: its last row's visible keys and
        # (window) its first row's first key
        rows0 = torch.arange(nqb, device=dev) * BLOCK_ROWS
        last = torch.clamp(rows0 + BLOCK_ROWS - 1, max=sq - 1)
        kend = vis[:, last][:, None]                           # (vb, 1, nqb)
        hi3 = torch.minimum(hi3, -(-kend // K3_KEYS))
        lo3 = torch.maximum(lo3, wlo[:, rows0][:, None] // K3_KEYS)
        lo1, hi1 = lo3 // 2, (hi3 + 1) // 2
        lo3, hi3 = torch.where(dead_b, 0, lo3), torch.where(dead_b, nk3, hi3)
        lo1, hi1 = torch.where(dead_b, 0, lo1), torch.where(dead_b, nk1, hi1)

        nkb = -(-sk // K4_KEYS)
        nqt = -(-sq // K4_ROWS)
        keys = _tiles_any(skip_ok, nkb, K4_KEYS)           # (mb, mh, mq, nkb)
        if mq == 1:
            rows = keys.expand(mb, mh, nqt, nkb)
        else:
            rows = _tiles_any(keys.transpose(2, 3), nqt,
                              K4_ROWS).transpose(2, 3)    # (mb, mh, nqt, nkb)
        dead_t = _tiles_any(dead, nqt, K4_ROWS)                 # (B, mh, nqt)
        if mh == h and nkv < h:   # a kv head walks its query heads' union
            rows = rows.reshape(mb, nkv, h // nkv, nqt, nkb).any(2)
            dead_t = dead_t.reshape(dead_t.shape[0], nkv, h // nkv, nqt).any(2)
        lo4, hi4 = _first_last(rows.transpose(2, 3), nqt)     # (mb, mh', nkb)
        # the structured lower limit: no row sees a key past its kv_len; under
        # causal the first row that sees key k0 is k0 - offset (K4's qt0)
        k0 = torch.arange(nkb, device=dev) * K4_KEYS
        kvlen = _visible_keys(b, 1, sk, False, kv_lens, None, dev)   # (vb, 1)
        off = sk - sq if causal_offset is None else int(causal_offset)
        qs0 = ((k0 - off).clamp(min=0) // K4_ROWS if is_causal
               else torch.zeros_like(k0))[None]
        qs0 = torch.where(k0[None] >= kvlen, nqt, qs0)          # (vb, nkb)
        lo4 = torch.maximum(lo4, qs0[:, None])
        if window is not None:
            # the last row that sees the block's last key k0 + 127 (K4's qhi)
            qlast = k0 + K4_KEYS - 1 - off + window - 1
            hi4 = torch.minimum(hi4, torch.where(
                qlast < 0, 0, torch.clamp(qlast // K4_ROWS + 1, max=nqt)))
        empty4 = lo4 >= hi4
        lo4, hi4 = torch.where(empty4, nqt, lo4), torch.where(empty4, 0, hi4)
        lox, hix = _first_last(dead_t, nqt)                     # (B, mh')
        lo4 = torch.minimum(lo4, lox[..., None])
        hi4 = torch.maximum(hi4, hix[..., None])
        return {"fwd": _pairs(lo1, hi1, (b, h, nqb)),
                "dq": _pairs(lo3, hi3, (b, h, nqb)),
                "dkv": _pairs(lo4, hi4, (b, nkv, nkb))}

    out = _Bounds(hulls)
    # the walks of K1 and K4: dead rows of a bool mask without dropout are
    # closed forms (the mean of v; dv += dsum / sk) and leave the walk;
    # K3's a bool mask's dead rows leave always (their dq is 0)
    dead_off = mask is not None and mask.dtype == torch.bool and not dropout
    m = None if mask is None else mask.expand(mask.shape[:3] + (sk,))
    cls1, c1, cls3, c3, cls4, c4 = _tile_classes(
        m, b, h, nkv, sq, sk, vis, wlo, dead, not dead_off)
    out["fwd_list"], out["fwd_c"] = _walk_lists(cls1, c1)
    out["dq_list"], out["dq_c"] = _walk_lists(cls3, c3)
    out["dkv_list"], out["dkv_c"] = _walk_lists(cls4, c4)
    out.update(fwd_cls=cls1, dq_cls=cls3, dkv_cls=cls4, dead=dead,
               dead_off=dead_off,
               dead_any=dead.any(),
               dead_bits=_pack_bits(dead, -(-sq // 64) * 64).view(
                   torch.int64),
               words=None if mask is None or mask.dtype != torch.bool
               else mask_words(m))
    return out


def _tensor_key(t):
    """A hashable stand-in for a bounds argument: a tensor by its storage,
    version, shape, strides, dtype and device (None where it has no
    version: an inference tensor is never cached); a list as a tuple."""
    if isinstance(t, torch.Tensor):
        try:
            return (t.data_ptr(), t._version, tuple(t.shape), t.stride(),
                    t.dtype, str(t.device))
        except RuntimeError:
            return None
    return tuple(t) if isinstance(t, list) else t


# the last call's bounds: [key, the tensors the key names (kept alive, so
# that no other tensor takes their storage), the bounds]
_BOUNDS_CACHE = [None, None, None]


def _call_bounds(q, k, attn_mask, is_causal, kv_lens, causal_offset,
                 window=None, seg_q=None, seg_k=None, dropout_p=0.0):
    """``mask_bounds`` of a call on (b, sq, h, d) q and (b, sk, nkv, d) k
    (its dense mask, or None). One entry is cached, keyed on the mask, its
    version, shape and dtype and the structured arguments: the layers of
    a step share one mask, and K1 and K4 of a layer share the bounds
    through the autograd context."""
    b, sq, h, _ = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    mask = None if attn_mask is None else dense_mask(attn_mask, b, h, sq, sk)
    args = (mask, kv_lens, seg_q, seg_k)
    key = tuple(_tensor_key(t) for t in args)
    key = None if any(t is not None and kt is None
                      for t, kt in zip(args, key)) else key + (
        b, h, nkv, sq, sk, bool(is_causal), causal_offset, window,
        dropout_p > 0.0, str(q.device))
    if key is not None and _BOUNDS_CACHE[0] == key:
        return _BOUNDS_CACHE[2]
    bounds = mask_bounds(mask, b, h, nkv, sq, sk, is_causal, kv_lens,
                         causal_offset, window, seg_q, seg_k, device=q.device,
                         dropout=dropout_p > 0.0)
    if key is not None:
        _BOUNDS_CACHE[:] = [key, args, bounds]
    return bounds


def _has_dead_rows(bounds):
    """Whether a call's dead rows leave K1's and K4's walks and there is
    one: the one host read of ``dead_any``, kept in the bounds, so that
    the layers sharing them read it once (meta tensors carry no values:
    none)."""
    if not bounds["dead_off"]:
        return False
    if "has_dead" not in bounds:
        d = bounds["dead_any"]
        bounds["has_dead"] = d.device.type != "meta" and bool(d)
    return bounds["has_dead"]


def _masked_scores(s, mask, structured):
    """The scores of ``_xla_attention`` in the general mode (s scaled, the
    ALiBi bias added, fp32): t = where(structured, s, NEG_INF), then, with a
    dense mask, where(mask, t, NEG_INF) for a bool one or t + mask for a
    float one; and g, where t depends on s."""
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    t = s if structured is None else torch.where(structured, s, neg)
    g = torch.ones((), dtype=torch.bool, device=s.device) \
        if structured is None else structured
    if mask is None:
        return t, g
    if mask.dtype == torch.bool:
        return torch.where(mask, t, neg), g & mask
    return t + mask.to(s.dtype), g


def _check_dropout(dropout_p, key, keep_words=None):
    """The dropout arguments of the kernels' wrappers and plain versions:
    p in [0, 1], and whenever p > 0 a key (2,) or the draw's keep words
    (``ops.dropout.attention_keep_words``, where the caller takes them)."""
    if not 0.0 <= dropout_p <= 1.0:
        raise ValueError(f"dropout_p must be in [0, 1], got {dropout_p}")
    if dropout_p > 0.0 and key is None and keep_words is None:
        raise ValueError("attention dropout needs the draw's key")
    return float(dropout_p)


def _keep_mask(key, keep_words, dropout_p, b, h, sq, sk, device):
    """The plain twins' keep mask Z (b, h, sq, sk): the keep words' bits
    when given, else ``attention_keep_mask`` of `key`; None without
    dropout."""
    if dropout_p == 0.0:
        return None
    if keep_words is not None:
        return drop_ops.keep_words_mask(keep_words, sk)
    return drop_ops.attention_keep_mask(key, dropout_p, b, h, sq, sk, device)


def _drop_probs(probs, z, dropout_p):
    """where(z, probs / keep, 0), keep = 1 - p in probs' dtype (the
    reference's ``probs / keep``)."""
    return torch.where(z, drop_ops.divide_by_keep(probs, dropout_p),
                       torch.zeros((), dtype=probs.dtype, device=probs.device))


def _xla_attention(q, k, v, attn_mask=None, is_causal=False, scale=None,
                   kv_lens=None, causal_offset=None, window=None,
                   dropout_p=0.0, training=True, key=None, seg_q=None,
                   seg_k=None, alibi_slopes=None):
    """The plain version: scores in fp32 (fp64 for fp64 inputs), the ALiBi
    bias added before every mask. With ``dropout_p`` in training the
    probabilities are dropped by the draw `key` (by default the next key
    of stream "dropout", as the reference's ``_xla_attention`` draws
    it)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if alibi_slopes is not None:
        scores = scores + _alibi_bias(alibi_slopes, sq, sk, causal_offset,
                                      acc)
    structured = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                                  q.device, window, seg_q, seg_k)
    if structured is not None:
        scores = torch.where(structured, scores,
                             torch.tensor(NEG_INF, dtype=acc, device=q.device))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.tensor(NEG_INF, dtype=acc,
                                              device=q.device))
        else:
            scores = scores + attn_mask.to(acc)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if structured is not None:
        # fully-masked rows emit 0 (flash-attn-2 convention, and the
        # kernel's); rows with a visible key are unchanged
        probs = torch.where(structured.any(-1, keepdim=True), probs,
                            torch.zeros((), dtype=probs.dtype,
                                        device=q.device))
    if dropout_p > 0.0 and training:
        if key is None:
            key = rng.next_rng_key("dropout")
        probs = _drop_probs(probs, drop_ops.keep_mask(
            key, dropout_p, probs.shape, q.device), dropout_p)
    pv = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(pv),
                        v.to(pv)).to(q.dtype)


def _general(attn_mask, seg_q, alibi_slopes):
    """The call runs the kernels' general mode (a dense mask, segment ids
    or ALiBi), whose row statistics are the pairs (m, log l)."""
    return (attn_mask is not None or seg_q is not None
            or alibi_slopes is not None)


def _plain_scores(q, k, scale, sq, sk, causal_offset, alibi_slopes):
    """fp32 (b, h, sq, sk) scaled scores over repeated k, the ALiBi bias
    added."""
    n_rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, n_rep).float()) * scale
    if alibi_slopes is not None:
        s = s + _alibi_bias(alibi_slopes, sq, sk, causal_offset,
                            torch.float32)
    return s


def flash_attention_fwd_plain(q, k, v, is_causal=False, scale=None,
                              kv_lens=None, causal_offset=None, window=None,
                              dropout_p=0.0, key=None, attn_mask=None,
                              seg_q=None, seg_k=None, alibi_slopes=None,
                              keep_words=None):
    """Plain twin of the kernel: (out (b, sq, h, d) in q's dtype, lse
    (b, h, sq) fp32), computed in fp32. Fully-masked rows give out 0 and
    lse NEG_INF, as the kernel does. With ``dropout_p`` the normalised
    probabilities are dropped by ``attention_keep_mask(key)``, or by the
    bits of `keep_words` (``ops.dropout.attention_keep_words``) when given;
    the lse stays the undropped one. In the general mode (``attn_mask``,
    segment ids or ALiBi) the scores are ``_xla_attention``'s and the lse
    is the pair (m, log l), (b, h, sq, 2) (``_masked_fwd_plain``)."""
    dropout_p = _check_dropout(dropout_p, key, keep_words)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    vf = _repeat_kv(v, h // k.shape[2]).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _plain_scores(q, k, scale, sq, sk, causal_offset, alibi_slopes)
    mask = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                            q.device, window, seg_q, seg_k)
    z = _keep_mask(key, keep_words, dropout_p, b, h, sq, sk, q.device)
    if _general(attn_mask, seg_q, alibi_slopes):
        dm = None if attn_mask is None else dense_mask(attn_mask, b, h, sq,
                                                       sk, q.device)
        return _masked_fwd_plain(s, vf, mask, dm, q.dtype, z, dropout_p)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    l = p.sum(-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    pn = p / lsafe
    if z is not None:
        pn = _drop_probs(pn, z, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", pn, vf).to(q.dtype)
    lse = (m + torch.log(lsafe))[..., 0]
    return out, lse


def _masked_fwd_plain(s, vf, structured, mask, dtype, z=None, dropout_p=0.0):
    """The general mode of the forward twin: out = softmax(t)·v over every
    key with t ``_masked_scores``'s (dropped by the keep mask `z` after the
    statistics), and the pair (m, log l); a row the structured masks hide
    wholly gives 0 and (NEG_INF, −inf), a float row at −inf everywhere NaN
    (as ``_xla_attention``'s softmax)."""
    t, _ = _masked_scores(s, mask, structured)
    m = t.amax(-1, keepdim=True)
    p = torch.exp(t - m)
    l = p.sum(-1, keepdim=True)
    pn = p / l
    if z is not None:
        pn = _drop_probs(pn, z, dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", pn, vf)
    stats = torch.cat([m, torch.log(l)], -1)
    if structured is not None:
        live = structured.any(-1, keepdim=True)                # (., 1, sq, 1)
        out = torch.where(live[..., 0].transpose(1, 2)[..., None], out,
                          torch.zeros((), device=out.device))
        stats = torch.where(live, stats, torch.tensor(
            [NEG_INF, -math.inf], device=out.device))
    return out.to(dtype), stats.expand(t.shape[:3] + (2,)).contiguous()


def _masked_bwd_plain(s, qf, kf, vf, of, delta, stats, structured, mask,
                      scale, z=None, dropout_p=0.0):
    """The general mode of the backward twin: P = exp(t − m − log l) from
    the forward's pair (0 where l = 0), dS = P∘(dP∘Z/keep − Δ) where t
    depends on s and 0 elsewhere, dv = (P∘Z/keep)ᵀ·dO over every element
    (Z/keep = 1 without dropout)."""
    t, g = _masked_scores(s, mask, structured)
    m, logl = stats.float()[..., :1], stats.float()[..., 1:]
    p = torch.exp(t - m - torch.where(logl == -math.inf, math.inf, logl))
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    pd = p
    if z is not None:
        dp = _drop_probs(dp, z, dropout_p)
        pd = _drop_probs(p, z, dropout_p)
    ds = torch.where(g, p * (dp - delta), torch.zeros((), device=s.device))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", pd, of))


def flash_attention_bwd_plain(q, k, v, out, lse, dout, is_causal=False,
                              scale=None, kv_lens=None, causal_offset=None,
                              window=None, dropout_p=0.0, key=None,
                              attn_mask=None, seg_q=None, seg_k=None,
                              alibi_slopes=None, g_lse=None, keep_words=None):
    """Plain twin of the backward kernels: (dq, dk, dv) in fp32 from the
    forward's (out, lse), with the kernels' contract: P = exp(S·scale − lse)
    on visible keys and 0 on a row whose lse is NEG_INF, Δ = rowsum(dO∘O)
    (minus ``g_lse``, the cotangent of a differentiable lse, (b, h, sq)),
    dS = P∘(dP − Δ), dq = scale·dS·K, dk = scale·dSᵀ·Q, dv = Pᵀ·dO, and the
    GQA groups summed into their kv head. With ``dropout_p`` (Z the keep
    mask of `key`, or the bits of `keep_words`): dS = P∘(dP∘Z/keep − Δ) and
    dv = (P∘Z/keep)ᵀ·dO. In the
    general mode (``attn_mask``, segment ids or ALiBi) `lse` is the
    forward's pair (m, log l) (``_masked_bwd_plain``)."""
    dropout_p = _check_dropout(dropout_p, key, keep_words)
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    n_rep = h // nkv
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    qf, of = q.float(), dout.float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _plain_scores(q, k, scale, sq, sk, causal_offset, alibi_slopes)
    mask = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                            q.device, window, seg_q, seg_k)
    delta = (of * out.float()).sum(-1).transpose(1, 2)[..., None]
    if g_lse is not None:
        delta = delta - g_lse.float()[..., None]
    z = _keep_mask(key, keep_words, dropout_p, b, h, sq, sk, q.device)
    if _general(attn_mask, seg_q, alibi_slopes):
        dm = None if attn_mask is None else dense_mask(attn_mask, b, h, sq,
                                                       sk, q.device)
        dq, dk, dv = _masked_bwd_plain(s, qf, kf, vf, of, delta, lse, mask,
                                       dm, scale, z, dropout_p)
    else:
        lse = lse.float()[..., None]
        p = torch.exp(s - lse)
        keep = (lse > NEG_INF * 0.5).expand_as(p)
        if mask is not None:
            keep = keep & mask
        p = torch.where(keep, p, torch.zeros((), device=q.device))
        dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
        pd = p
        if z is not None:
            dp = _drop_probs(dp, z, dropout_p)
            pd = _drop_probs(p, z, dropout_p)
        ds = p * (dp - delta)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        dv = torch.einsum("bhqk,bqhd->bkhd", pd, of)
    if n_rep != 1:
        dk = dk.reshape(b, sk, nkv, n_rep, d).sum(3)
        dv = dv.reshape(b, sk, nkv, n_rep, d).sum(3)
    return dq, dk, dv


def _kv_lens_arg(kv_lens, b, device):
    if kv_lens is None:
        return None
    if isinstance(kv_lens, int):   # a fill, not a stream-synchronising copy
        return torch.full((b,), kv_lens, dtype=torch.int32, device=device)
    kl = torch.as_tensor(kv_lens, device=device)
    if kl.dim() == 0:
        kl = kl.expand(b)
    return kl.to(torch.int32).contiguous()


def _check_kernel_inputs(what, q, k, v, *more):
    """Raise on what the CUDA kernels do not take: q/k/v and the bf16
    tensors in `more` on q's CUDA device, bf16, contiguous, 16-byte aligned
    (K1, K3 and K4 read them through TMA tensor maps), head_dim a multiple
    of 8 up to 256 (``kernel_width``), kv heads dividing the heads. Returns
    (b, sq, sk, h, nkv, d)."""
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.device.type != KERNEL_DEVICE or t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected "
                             f"{q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes "
                            "bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} not 16-byte aligned")
    if (kernel_width(d) is None or k.shape != (b, sk, nkv, d)
            or v.shape != k.shape):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (head_dim "
                         "a multiple of 8 up to 256)")
    if nkv == 0 or h % nkv:
        raise ValueError(f"{what}: {h} heads not a multiple of {nkv} kv "
                         "heads")
    if sq == 0 or b == 0:
        raise ValueError(f"{what}: empty q")
    return b, sq, sk, h, nkv, d


def _check_rows(what, b, h, sq, q, general=False, **rows):
    """lse / delta: fp32 (b, h, sq), contiguous, on q's device; a general
    call's lse the (b, h, sq, 2) pairs."""
    for name, t in rows.items():
        shape = (b, h, sq, 2) if general and name == "lse" else (b, h, sq)
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _refuse_grad(what, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{what}: inputs require grad, and the raw kernel output would be "
            "cut from the autograd graph; call scaled_dot_product_attention "
            "(which differentiates through FlashAttention) or run under "
            "torch.no_grad()")


def _inv_keep(dropout_p):
    """1/keep in fp32, keep = float32(1 - p) (0 when nothing is kept)."""
    keep = float(np.float32(1.0 - dropout_p))
    return float(np.float32(1.0) / np.float32(keep)) if keep > 0 else 0.0


def _keep_args(what, dropout_p, key, keep_words, q, b, h, sq, sk, is_causal,
               causal_offset, kv_lens, window, general):
    """K1's, K3's and K4's dropout arguments: (the keep words, [their pointer,
    words a row, 1/keep]); without dropout (None, [null, 0, 1.0]). Words
    not given are made here, one launch of kernel W (every key of a row in
    the general mode, whose dead rows weigh every key); given ones must be
    the call's: int32 (b, h, sq, ceil(sk / 128)·4), contiguous, 16-byte
    aligned, on q's device."""
    if dropout_p <= 0.0:
        return None, [None, 0, 1.0]
    ww = drop_ops.keep_words_width(sk)
    if keep_words is None:
        keep_words = drop_ops.attention_keep_words(
            key, dropout_p, b, h, sq, sk, is_causal, causal_offset, kv_lens,
            window, everything=general, device=q.device)
    elif (keep_words.device != q.device or keep_words.dtype != torch.int32
          or tuple(keep_words.shape) != (b, h, sq, ww)
          or not keep_words.is_contiguous() or keep_words.data_ptr() % 16):
        raise ValueError(
            f"{what}: keep_words must be contiguous, 16-byte aligned int32 "
            f"{(b, h, sq, ww)} on {q.device} (ops.dropout."
            f"attention_keep_words), got {keep_words.dtype} "
            f"{tuple(keep_words.shape)} on {keep_words.device}")
    return keep_words, [_build.ptr(keep_words), ww, _inv_keep(dropout_p)]


class _ModArg(ctypes.Structure):
    """csrc/attn_mask.cuh's am::Mod: the dense mask's pointer (or null), its
    element strides (b, h, q, k; 0 on a broadcast dim), fp32 or bool, the
    block bounds (null: no kernel reads them), the window (0: none), the
    segment ids' pointers (int32 (b, sq) and (b, sk), or null) and the
    ALiBi slopes' (fp32 (h,), or null); then the kernel's walk (the list,
    its c values, its element strides of a batch and a head, 0 on a
    broadcast dim, and a block's entries), the dead rows' bits and word
    strides (null: none off the walk), their closed form `red` (K1: the
    mean of v; K4: dsum; K3 none), and the packed bool mask with its dims
    (batches, heads, rows, words)."""
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("sq", ctypes.c_longlong),
                ("sk", ctypes.c_longlong), ("f32", ctypes.c_int),
                ("bounds", ctypes.c_void_p), ("window", ctypes.c_int),
                ("seg_q", ctypes.c_void_p), ("seg_k", ctypes.c_void_p),
                ("slopes", ctypes.c_void_p),
                ("list", ctypes.c_void_p), ("cval", ctypes.c_void_p),
                ("lsb", ctypes.c_longlong), ("lsh", ctypes.c_longlong),
                ("ln", ctypes.c_int), ("dead", ctypes.c_void_p),
                ("dsb", ctypes.c_longlong), ("dsh", ctypes.c_longlong),
                ("red", ctypes.c_void_p), ("words", ctypes.c_void_p),
                ("wb", ctypes.c_int), ("wh", ctypes.c_int),
                ("wq", ctypes.c_int), ("ww", ctypes.c_int)]


def _on(what, name, t, q, shape, dtype):
    """`t` as the kernels take it: `dtype`, contiguous, of `shape` on q's
    device."""
    t = torch.as_tensor(t)
    if t.device != q.device or tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must be {shape} on {q.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(dtype).contiguous()


def _strides0(t):
    """The element strides of t's leading dims, 0 where a dim is 1."""
    return [0 if n == 1 else st for n, st in zip(t.shape, t.stride())]


def _mod_arg(what, attn_mask, seg_q, seg_k, slopes, window, bounds, part,
             q, b, h, sq, sk, red=None):
    """The kernels' general-mode argument (a pointer to _ModArg; None for a
    call without a dense mask, segment ids or ALiBi) and the tensors it
    points into, which the caller keeps alive over the launch. `part` is
    the kernel's entry of ``mask_bounds``'s dict `bounds` (K1's "fwd", K3's
    "dq", K4's "dkv": each walks its list); `red` the dead rows' closed
    form (K1 and K4, a call with dead rows off the walk), or None. K3 takes
    the dead rows' bits whenever the mask is bool (their P is 0, with or
    without dropout) and no `red`."""
    if not _general(attn_mask, seg_q, slopes):
        return None, None
    m, strides = None, (0, 0, 0, 0)
    if attn_mask is not None:
        m = dense_mask(attn_mask, b, h, sq, sk)
        if m.device != q.device:
            raise ValueError(f"{what}: attn_mask on {m.device}, expected "
                             f"{q.device}")
        strides = tuple(0 if m.shape[i] == 1 else m.stride(i)
                        for i in range(4))
    if seg_q is not None:
        seg_q = _on(what, "seg_q", seg_q, q, (b, sq), torch.int32)
        seg_k = _on(what, "seg_k", seg_k, q, (b, sk), torch.int32)
    if slopes is not None:
        slopes = _on(what, "alibi_slopes", slopes, q, (h,), torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    # `bounds` stays null: every kernel walks its list
    arg = _ModArg(ptr(m), *strides, int(m is not None
                                        and m.dtype != torch.bool),
                  None, min(window or 0, 1 << 30), ptr(seg_q),
                  ptr(seg_k), ptr(slopes))
    lst, cv = bounds[part + "_list"], bounds[part + "_c"]
    arg.list, arg.cval = lst.data_ptr(), cv.data_ptr()
    arg.lsb, arg.lsh = _strides0(lst)[:2]
    arg.ln = lst.shape[-1]
    words, dead = bounds["words"], bounds["dead_bits"]
    if words is not None:
        arg.words = words.data_ptr()
        arg.wb, arg.wh, arg.wq, arg.ww = words.shape
    if red is not None or (part == "dq" and words is not None):
        arg.dead = dead.data_ptr()
        arg.dsb, arg.dsh = _strides0(dead)[:2]
    if red is not None:
        arg.red = red.data_ptr()
    return ctypes.pointer(arg), [m, seg_q, seg_k, slopes, arg, red, lst, cv,
                                 words, dead]


def _refuse_d256_modes(what, d, window, dropout_p, rows, general=False):
    """At kernel width 256 (head dims 136 … 256) the kernels are built
    without the window, dropout and the general mode: those raise, naming
    ROADMAP Queue B rows 1-3 and the kernel's own row(s) there."""
    if kernel_width(d) == 256 and (window is not None or dropout_p > 0.0
                                   or general):
        raise NotImplementedError(
            f"{what}: the sliding window, dropout, a dense attn_mask, segment "
            f"ids and ALiBi at head_dim {d} (kernel width 256) are not ported "
            f"yet (ROADMAP Queue B rows 1-3; this kernel's Queue B {rows}); "
            "width 256 runs without them, and they run at head_dim up to "
            "128")


def _count(wrapper, d, window, dropout_p, attn_mask, seg_q, slopes):
    """One launch on `wrapper`'s counters."""
    wrapper.launches += 1
    wrapper.windowed += window is not None
    wrapper.dropout += dropout_p > 0.0
    wrapper.general += _general(attn_mask, seg_q, slopes)
    wrapper.masked += attn_mask is not None
    wrapper.segmented += seg_q is not None
    wrapper.alibi += slopes is not None
    wrapper.mask_window += attn_mask is not None and window is not None
    wrapper.by_d[kernel_width(d)] += 1


# the counters of each kernel wrapper: its launches, and of them those with
# the window, with dropout, of the general instantiation, with a dense
# mask, with segment ids, with ALiBi and with a mask beside the window
MODE_COUNTERS = ("windowed", "dropout", "general", "masked", "segmented",
                 "alibi", "mask_window")


def _counters(wrapper, dims):
    """Every counter of `wrapper` at 0, and its launches at each kernel
    width (``by_d``: a d-160 call counts at 256)."""
    for name in ("launches",) + MODE_COUNTERS:
        setattr(wrapper, name, 0)
    wrapper.by_d = dict.fromkeys(dims, 0)


def _bounds_for(what, bounds, q, k, attn_mask, is_causal, kv_lens,
                causal_offset, window, seg_q, seg_k, dropout_p):
    """The call's bounds: `bounds` as given (``mask_bounds``' dict, which
    must say the call's dropout: a dead row leaves the walks only without
    it), or computed (``_call_bounds``)."""
    if bounds is None:
        return _call_bounds(q, k, attn_mask, is_causal, kv_lens,
                            causal_offset, window, seg_q, seg_k, dropout_p)
    if bounds["dead_off"] != (bounds["words"] is not None
                              and dropout_p == 0.0):
        raise ValueError(f"{what}: the bounds were computed for another "
                         "dropout setting (mask_bounds(..., dropout=...))")
    return bounds


# the row sums' launch: about this many blocks (two an H100 SM), each
# summing at least ROW_SUM_ROWS rows
ROW_SUM_BLOCKS, ROW_SUM_ROWS = 264, 256


def dead_row_sums_plain(x, groups, scale, dead=None):
    """Plain version of ``dead_row_sums``: fp32 (b, groups, d)."""
    b, r, nh, d = x.shape
    xf = x.float()
    if dead is not None:
        xf = torch.where(dead.transpose(1, 2)[..., None], xf,
                         torch.zeros((), device=x.device))
    return xf.reshape(b, r, groups, nh // groups, d).sum((1, 3)) * scale


def dead_row_sums(x, groups, scale, dead=None, dead_bits=None):
    """scale · the sum over the rows of x (b, R, NH, d) of each group of
    NH / groups heads, fp32 (b, groups, d); with `dead` ((B|1, NH|1, R)
    bool, ``mask_bounds``' dead) over the rows it flags only. The general
    mode's dead rows off the walk (a bool mask without dropout) read it:
    K1 the mean of v (x = v, scale 1 / sk), K4 dsum (x = dO over the dead
    rows, its dead_bits). CUDA tensors launch ``csrc/attn_rows.cu`` (bf16,
    contiguous, d a multiple of 8 up to 256) and return the first d columns
    of a (b, groups, D) buffer, D = kernel_width(d), zeros past d, which K1
    and K4 read at width D; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return dead_row_sums_plain(x, groups, scale, dead)
    b, r, nh, d = x.shape
    dk = kernel_width(d)
    if (x.device.type != KERNEL_DEVICE or x.dtype != torch.bfloat16
            or not x.is_contiguous() or x.data_ptr() % 16
            or dk is None or nh % groups):
        raise ValueError(f"dead_row_sums: x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}: the kernel takes contiguous bf16 "
                         "(b, R, NH, d), d a multiple of 8 up to 256, NH a "
                         f"multiple of {groups}")
    out = torch.empty((b, groups, dk), dtype=torch.float32, device=x.device)
    # a unit's rows over enough blocks for about two a SM, each at least
    # ROW_SUM_ROWS rows
    units = b * groups
    nsplit = max(1, min(-(-ROW_SUM_BLOCKS // units),
                        r * (nh // groups) // ROW_SUM_ROWS))
    part = ticket = None
    if nsplit > 1:
        part = torch.empty((units * nsplit, dk), dtype=torch.float32,
                           device=x.device)
        ticket = torch.zeros(units, dtype=torch.int32, device=x.device)
    lib = _build.library("attn_rows")
    fn = lib.attn_row_sums
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 5 + [cl, cl] + [ci] * 6
                       + [ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    bsb, bsh = (0, 0) if dead_bits is None else _strides0(dead_bits)[:2]
    ptr = lambda t: None if t is None else _build.ptr(t)
    err = fn(_build.ptr(x), _build.ptr(out), ptr(part), ptr(ticket),
             ptr(dead_bits), bsb, bsh, b, r, nh, groups, d, nsplit,
             float(scale), _build.stream_of(x))
    dead_row_sums.launches += 1
    _build.check(err, "dead_row_sums")
    return out[..., :d]


dead_row_sums.launches = 0


def flash_attention_fwd(q, k, v, is_causal=False, scale=None, kv_lens=None,
                        causal_offset=None, window=None, dropout_p=0.0,
                        key=None, attn_mask=None, bounds=None, seg_q=None,
                        seg_k=None, alibi_slopes=None, keep_words=None):
    """Flash-attention forward: (out, lse) as flash_attention_fwd_plain.

    CUDA tensors launch ``csrc/flash_attention.cu`` (bf16, contiguous,
    head_dim a multiple of 8 up to 256, run at the next kernel width of 64,
    128 and 256 at its own width in memory; the plain mode at d 40, 80 and
    160 on the trimmed Q·Kᵀ; with ``window`` its windowed instantiation,
    with ``dropout_p`` its dropout one, reading `keep_words`
    (``ops.dropout.attention_keep_words`` of the call; made here from `key`
    when None, one more launch); with ``attn_mask``,
    segment ids or ``alibi_slopes`` its general one (and the window and
    dropout there), walking `bounds` (``mask_bounds``, computed here when
    None); every mode but the plain one at kernel widths 64 and 128 only,
    head_dim up to 128); anything
    else on CUDA raises. CPU tensors take the plain twin. Inputs that
    require grad, with grad mode on, raise: the output of a raw kernel
    carries no gradient."""
    _refuse_grad("flash_attention_fwd", q, k, v)
    window = _check_window(window, is_causal)
    dropout_p = _check_dropout(dropout_p, key, keep_words)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, is_causal, scale, kv_lens,
                                         causal_offset, window, dropout_p,
                                         key, attn_mask, seg_q, seg_k,
                                         alibi_slopes, keep_words)
    b, sq, sk, h, nkv, d = _check_kernel_inputs("flash_attention_fwd",
                                                q, k, v)
    general = _general(attn_mask, seg_q, alibi_slopes)
    _refuse_d256_modes("flash_attention_fwd", d, window, dropout_p, "row 1",
                       general)
    red = None
    if general:
        bounds = _bounds_for("flash_attention_fwd", bounds, q, k, attn_mask,
                             is_causal, kv_lens, causal_offset, window,
                             seg_q, seg_k, dropout_p)
        if _has_dead_rows(bounds):      # their out: the mean of v
            red = dead_row_sums(v, nkv, 1.0 / sk)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_off = (sk - sq) if causal_offset is None else int(causal_offset)
    kl = _kv_lens_arg(kv_lens, b, q.device)
    out = torch.empty_like(q)
    marg, keep = _mod_arg("flash_attention_fwd", attn_mask, seg_q, seg_k,
                          alibi_slopes, window, bounds, "fwd", q, b, h, sq,
                          sk, red)
    lse = torch.empty((b, h, sq) + ((2,) if general else ()),
                      dtype=torch.float32, device=q.device)
    words, drop = _keep_args("flash_attention_fwd", dropout_p, key,
                             keep_words, q, b, h, sq, sk, is_causal,
                             causal_offset, kv_lens, window, general)
    lib = _kernel_lib("flash_attention", "flash_attention_fwd", 6, 9)
    # window 0: the windowless kernel; a window takes the windowed one
    # (beyond 2^30 it masks nothing and stays a C int); the general
    # argument, the general one; keep words, the dropout one
    err = lib.flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _build.ptr(kl) if kl is not None else None,
        b, sq, sk, h, nkv, d, int(bool(is_causal)), q_off,
        min(window or 0, 1 << 30), float(scale), marg, *drop,
        _build.stream_of(q))
    _count(flash_attention_fwd, d, window, dropout_p, attn_mask, seg_q,
           alibi_slopes)
    _build.check(err, "flash_attention_fwd")
    return out, lse


_counters(flash_attention_fwd, FWD_DIMS)


def _bwd_args(what, part, q, k, v, dout, lse, delta, is_causal, scale,
              kv_lens, causal_offset, window, dropout_p, key, attn_mask,
              bounds, seg_q, seg_k, slopes, keep_words=None):
    """The K3 (`part` "dq") and K4 ("dkv") calls' checked arguments: (head
    pointers, kv_lens' pointer, the tail after the outputs, d, the tensors
    to keep alive over the launch). Both read the keep words, made from
    `key` when `keep_words` is None."""
    window = _check_window(window, is_causal)
    dropout_p = _check_dropout(dropout_p, key, keep_words)
    b, sq, sk, h, nkv, d = _check_kernel_inputs(what, q, k, v,
                                                ("dout", dout))
    general = _general(attn_mask, seg_q, slopes)
    _refuse_d256_modes(what, d, window, dropout_p, "rows 2-3", general)
    red = None
    if general:
        bounds = _bounds_for(what, bounds, q, k, attn_mask, is_causal,
                             kv_lens, causal_offset, window, seg_q, seg_k,
                             dropout_p)
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    _check_rows(what, b, h, sq, q, general, lse=lse, delta=delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_off = (sk - sq) if causal_offset is None else int(causal_offset)
    kl = _kv_lens_arg(kv_lens, b, q.device)
    head = [_build.ptr(t) for t in (q, k, v, dout, lse, delta)]
    if part == "dkv" and general and _has_dead_rows(bounds):
        # the dead rows' dv: their dO summed over the kv head's query heads
        red = dead_row_sums(dout, nkv, 1.0, bounds["dead"],
                            bounds["dead_bits"])
    marg, keep = _mod_arg(what, attn_mask, seg_q, seg_k, slopes, window,
                          bounds, part, q, b, h, sq, sk, red)
    # K3 and K4 read the forward's keep words
    words, drop = _keep_args(what, dropout_p, key, keep_words, q, b, h, sq,
                             sk, is_causal, causal_offset, kv_lens, window,
                             general)
    # window 0: the windowless kernels; a window takes the windowed ones
    # (beyond 2^30 it masks nothing and stays a C int), as K1's wrapper
    tail = [b, sq, sk, h, nkv, d, int(bool(is_causal)), q_off,
            min(window or 0, 1 << 30), float(scale), marg, *drop,
            _build.stream_of(q)]
    return (head, _build.ptr(kl) if kl is not None else None, tail, d,
            [keep, words])


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, is_causal=False,
                           scale=None, kv_lens=None, causal_offset=None,
                           window=None, dropout_p=0.0, key=None,
                           attn_mask=None, bounds=None, seg_q=None,
                           seg_k=None, alibi_slopes=None, keep_words=None):
    """dq (bf16, q's shape) by the K3 kernel of ``csrc/flash_attention_bwd.cu``
    from the forward's lse and Δ = rowsum(dO∘O), both fp32 (b, h, sq);
    head_dim a multiple of 8 up to 256 (as K1's); ``window`` (with
    ``is_causal``) launches its
    windowed instantiation, ``dropout_p`` its dropout one, reading the
    forward's `keep_words` (``ops.dropout.attention_keep_words``; made here
    from `key` when None, one more launch), ``attn_mask``, segment ids or
    ``alibi_slopes`` (with the forward's (m, log l) pairs as `lse`; `bounds`
    as K1's) its general one (each at head_dim up to 128 only). CUDA
    tensors only
    (the CPU path is ``flash_attention_bwd_plain``)."""
    head, kl, tail, d, keep = _bwd_args(
        "flash_attention_bwd_dq", "dq", q, k, v, dout, lse, delta, is_causal,
        scale, kv_lens, causal_offset, window, dropout_p, key, attn_mask,
        bounds, seg_q, seg_k, alibi_slopes, keep_words)
    dq = torch.empty_like(q)
    lib = _kernel_lib("flash_attention_bwd", "flash_attention_bwd_dq", 8, 9)
    err = lib.flash_attention_bwd_dq(*head, _build.ptr(dq), kl, *tail)
    _count(flash_attention_bwd_dq, d, window, dropout_p, attn_mask, seg_q,
           alibi_slopes)
    _build.check(err, "flash_attention_bwd_dq")
    return dq


_counters(flash_attention_bwd_dq, FWD_DIMS)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, is_causal=False,
                            scale=None, kv_lens=None, causal_offset=None,
                            window=None, dropout_p=0.0, key=None,
                            attn_mask=None, bounds=None, seg_q=None,
                            seg_k=None, alibi_slopes=None, keep_words=None):
    """(dk, dv) (bf16, k's shape) by the K4 kernel of
    ``csrc/flash_attention_bwd.cu``; GQA groups are summed in fp32 inside the
    kernel; head dims and modes, the keep words among them, as in
    ``flash_attention_bwd_dq``. CUDA tensors only."""
    head, kl, tail, d, keep = _bwd_args(
        "flash_attention_bwd_dkv", "dkv", q, k, v, dout, lse, delta,
        is_causal, scale, kv_lens, causal_offset, window, dropout_p, key,
        attn_mask, bounds, seg_q, seg_k, alibi_slopes, keep_words)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib("flash_attention_bwd", "flash_attention_bwd_dkv", 9, 9)
    err = lib.flash_attention_bwd_dkv(*head, _build.ptr(dk), _build.ptr(dv),
                                      kl, *tail)
    _count(flash_attention_bwd_dkv, d, window, dropout_p, attn_mask, seg_q,
           alibi_slopes)
    _build.check(err, "flash_attention_bwd_dkv")
    return dk, dv


_counters(flash_attention_bwd_dkv, FWD_DIMS)


def flash_attention_bwd(q, k, v, out, lse, dout, is_causal=False, scale=None,
                        kv_lens=None, causal_offset=None, window=None,
                        dropout_p=0.0, key=None, attn_mask=None,
                        bounds=None, seg_q=None, seg_k=None,
                        alibi_slopes=None, g_lse=None, keep_words=None):
    """Gradients (dq, dk, dv) of the attention whose forward gave (out,
    lse), in the dtypes of q, k, v. CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors compute Δ = rowsum(dO∘O)
    in fp32 (as the reference does outside its kernels, :1059), minus
    ``g_lse`` (the cotangent of ``flash_fwd_lse``'s lse, :1061-1062), and
    launch K3 and K4 (their windowed, dropout and general instantiations
    under a window, a dropout and a dense mask, segment ids or ALiBi). With
    dropout both read the forward's `keep_words`, made here once from `key`
    when None."""
    mods = dict(attn_mask=attn_mask, seg_q=seg_q, seg_k=seg_k,
                alibi_slopes=alibi_slopes)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out, lse, dout, is_causal, scale, kv_lens,
            causal_offset, window, dropout_p, key, g_lse=g_lse,
            keep_words=keep_words, **mods)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    if dropout_p > 0.0 and keep_words is None and key is not None:
        # one launch of kernel W for both kernels (every key of a row in
        # the general mode, whose dead rows weigh every key)
        keep_words = drop_ops.attention_keep_words(
            key, dropout_p, q.shape[0], q.shape[2], q.shape[1], k.shape[1],
            is_causal, causal_offset, kv_lens, window,
            everything=_general(attn_mask, seg_q, alibi_slopes),
            device=q.device)
    kw = dict(is_causal=is_causal, scale=scale, kv_lens=kv_lens,
              causal_offset=causal_offset, window=window,
              dropout_p=dropout_p, key=key, bounds=bounds,
              keep_words=keep_words, **mods)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


def _kernel_lib(lib_name, fn_name, n_ptrs, n_ints):
    """The ctypes entry `fn_name` of csrc/<lib_name>.cu: n_ptrs pointers,
    n_ints ints, the float scale, the general-mode argument (a pointer to
    _ModArg, or null), the dropout arguments (the keep words' pointer or
    null, words a row, 1/keep) and the stream; returns cudaError."""
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([vp] * n_ptrs + [ci] * n_ints + [cf]
                       + [ctypes.POINTER(_ModArg)] + [vp, ci, cf] + [vp])
        fn.restype = ctypes.c_int
    return lib


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: K1 forward, K3/K4 backward on CUDA
    tensors; the plain forward and backward on CPU tensors. Port of the
    reference's ``_flash_vjp_entry`` / ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``.

    The kernels take contiguous tensors and raise on anything else, so the
    Function makes q, k, v (GPT's qkv split gives strided views) and the
    incoming gradient contiguous itself, and saves those copies. Under
    dropout it hashes the mask once into keep words
    (``ops.dropout.attention_keep_words``: kernel W on the card, the plain
    twin on the CPU), which K1 reads, and saves them beside q, k, v for K3
    and K4 (sq·sk/8 bytes a (b, h)). Under recompute the replayed forward
    makes them again.
    A dense mask, segment ids and ALiBi slopes are carried with their
    bounds (computed once for K1, K3 and K4) and get no gradient, as the
    reference's VJP gives the mask a zero cotangent (:1108-1112) and
    stops the slopes' gradient (:212)."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale, kv_lens, causal_offset,
                window=None, dropout_p=0.0, key=None, attn_mask=None,
                seg_q=None, seg_k=None, alibi_slopes=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(is_causal=is_causal, scale=scale, kv_lens=kv_lens,
                  causal_offset=causal_offset, window=window,
                  dropout_p=dropout_p, key=key, attn_mask=attn_mask,
                  seg_q=seg_q, seg_k=seg_k, alibi_slopes=alibi_slopes)
        general = _general(attn_mask, seg_q, alibi_slopes)
        if general and q.device.type != "cpu":
            kw["bounds"] = _call_bounds(q, k, attn_mask, is_causal, kv_lens,
                                        causal_offset, window, seg_q, seg_k,
                                        dropout_p)
        words = None
        if dropout_p > 0.0:   # the call's keep words, for K1, K3 and K4
            words = drop_ops.attention_keep_words(
                key, dropout_p, q.shape[0], q.shape[2], q.shape[1],
                k.shape[1], is_causal, causal_offset, kv_lens, window,
                everything=general, device=q.device)
        out, lse = flash_attention_fwd(q, k, v, keep_words=words, **kw)
        ctx.save_for_backward(q, k, v, out, lse, words)
        ctx.kw = kw
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, words = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), keep_words=words,
                                         **ctx.kw)
        return (dq, dk, dv) + (None,) * 11


class FlashFwdLse(torch.autograd.Function):
    """``flash_fwd_lse``'s Function: (out, lse) by K1 (the plain twin on
    CPU tensors), and a backward that takes both cotangents, g_lse folded
    into Δ for K3 and K4 (the reference's ``_fwd_lse_vjp_bwd``,
    :1195-1212)."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, is_causal=is_causal,
                                       scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(is_causal=is_causal, scale=scale)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), g_lse=g_lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None


def flash_fwd_lse(q, k, v, is_causal=False, scale=None):
    """Attention forward returning (out (b, s, h, d), lse (b, h, s) fp32),
    the pieces a caller merges blockwise (ring attention). Differentiable,
    the lse included: its cotangent folds into Δ. On the card K1 and K3/K4
    whatever the shape (the reference's ``_pallas_lse_ok`` sends short
    sequences to XLA; here the device decides), at the head dim's own width
    or, for a d the kernels do not read in place, zero-padded as in
    ``scaled_dot_product_attention``; on CPU tensors the plain twins."""
    d = q.shape[-1]
    if q.device.type != "cpu":
        q, k, v, scale, d = _pad_head_dim(q, k, v, scale)
    out, lse = FlashFwdLse.apply(q, k, v, is_causal, scale)
    return (out if out.shape[-1] == d else out[..., :d]), lse


def _pad_head_dim(q, k, v, scale):
    """The head-dim half of the reference's ``_pad_for_kernel`` (:339-369),
    where the kernels still need it. A head dim that is a multiple of 8 up
    to 256 (SD-1.5's 40, 80, 160 among them) goes to them as it is: they
    read it at its own width, the columns up to their kernel width arriving
    as TMA's zero fill (``kernel_width``). Any other d <= 256, whose row of
    d·2 bytes is no TMA stride, is zero-padded to the next of FWD_DIMS (36
    to 64, 100 to 128). Exact: the zero lanes of q and k add 0 to every
    score, and the caller slices the value's pad lanes off the output. The
    scale is 1/√d of the original d, fixed before the pad. Returns (q, k,
    v, scale, d). The reference's short-KV pad (sk to the next 128 with
    kv_lens) is a TPU tiling device: K1 reads a ragged sk through TMA's
    zero fill and masks past it."""
    d = q.shape[-1]
    if d > 256:
        raise ValueError(
            f"scaled_dot_product_attention: head_dim {d} > 256 has no kernel "
            "on the card (the reference takes it to XLA; ROADMAP Queue B "
            "row 1)")
    if kernel_width(d) is not None:
        return q, k, v, scale, d
    dt = next(t for t in FWD_DIMS if t >= d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pad = (0, dt - d)
    return (torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), scale, d)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 kv_lens=None, segment_ids=None,
                                 kv_segment_ids=None,
                                 window_size: Optional[int] = None,
                                 alibi_slopes=None,
                                 causal_offset: Optional[int] = None):
    """Attention with the device dispatch (see the module docstring); the
    reference's signature, and ``causal_offset``.

    ``window_size`` is the causal sliding window (needs ``is_causal``);
    ``segment_ids`` / ``kv_segment_ids`` the packed-sequence ids and
    ``alibi_slopes`` the ALiBi slopes (needs ``is_causal``), validated as
    the reference validates them. ``dropout_p`` in training draws one key
    from stream "dropout" on every path. On the kernels' device K1 (and
    K3/K4 for a gradient) run every mode: the window and dropout in their
    own instantiations, a dense ``attn_mask``, segment ids and ALiBi in
    the general one, with the window and dropout beside them. A head dim
    that is a multiple of 8 up to 256 reaches K1, K3 and K4 at its own
    width, no copy made (SD-1.5's 160 on their kernel width 256); any other
    d up to 256 is zero-padded for the kernels (``_pad_head_dim``) and the
    output sliced back, so its gradient runs K3/K4 at the padded d through
    torch's autograd of the pad and the slice. Every mode but the plain one
    raises at kernel width 256 (ROADMAP Queue B rows 1-3), and no call
    falls back. On the
    CPU a call that needs a gradient runs the Function over the plain
    twins, any other ``_xla_attention``."""
    window = _check_window(window_size, is_causal)
    seg_q, seg_k = _check_segments(segment_ids, kv_segment_ids, q.shape[1],
                                   k.shape[1])
    slopes = _check_alibi(alibi_slopes, is_causal, q.shape[2], q.device)
    dropout_p = float(dropout_p) if training else 0.0
    key = rng.next_rng_key("dropout") if dropout_p > 0.0 else None
    _check_dropout(dropout_p, key)
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    mods = dict(seg_q=seg_q, seg_k=seg_k, alibi_slopes=slopes)
    if q.device.type == "cpu" and not needs_grad:
        return _xla_attention(q, k, v, attn_mask=attn_mask,
                              is_causal=is_causal, scale=scale,
                              kv_lens=kv_lens, causal_offset=causal_offset,
                              window=window, dropout_p=dropout_p, key=key,
                              **mods)
    if attn_mask is not None:
        attn_mask = dense_mask(attn_mask, q.shape[0], q.shape[2], q.shape[1],
                               k.shape[1], q.device)
    d = q.shape[-1]
    if q.device.type != "cpu":   # the plain versions take any head dim
        q, k, v, scale, d = _pad_head_dim(q, k, v, scale)
        _refuse_d256_modes("scaled_dot_product_attention", q.shape[-1],
                           window, dropout_p, "rows 1-3",
                           _general(attn_mask, seg_q, slopes))
    if needs_grad:
        out = FlashAttention.apply(q, k, v, is_causal, scale, kv_lens,
                                   causal_offset, window, dropout_p, key,
                                   attn_mask, seg_q, seg_k, slopes)
    else:
        # the kernel takes contiguous tensors: GPT's qkv split gives
        # strided views (a no-op copy for the rest, as in FlashAttention)
        out = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), is_causal=is_causal,
                                  scale=scale, kv_lens=kv_lens,
                                  causal_offset=causal_offset, window=window,
                                  dropout_p=dropout_p, key=key,
                                  attn_mask=attn_mask, **mods)[0]
    return out if out.shape[-1] == d else out[..., :d]


def flash_attention(q, k, v, dropout=0.0, causal=False, attn_mask=None,
                    training=True, scale=None, kv_lens=None,
                    segment_ids=None, kv_segment_ids=None, window_size=None,
                    alibi_slopes=None):
    """``paddle.nn.functional.flash_attention``: (out, None) of
    ``scaled_dot_product_attention`` (the reference's :144-154)."""
    out = scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout, is_causal=causal,
        training=training, scale=scale, kv_lens=kv_lens,
        segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        window_size=window_size, alibi_slopes=alibi_slopes)
    return out, None
