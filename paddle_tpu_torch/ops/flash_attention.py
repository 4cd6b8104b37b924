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
  goes to the kernels, and what they do not take raises. There a head dim
  other than the kernels' 64, 128 and 256 is zero-padded to the next of
  them first, with the scale of the original d (the reference's
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
K1 drops the probabilities after its softmax statistics took them
undropped (the lse stays the undropped one, as in the reference, ``:533``);
K3 and K4 regenerate the mask from the same index: dS = P∘(dP̃∘Z/keep − Δ)
with Δ = rowsum(dO∘O) over the dropped O, dv = (P∘Z/keep)ᵀ·dO. Each
kernel drops in an instantiation of its own (``DROP``), so the kernels
without dropout run the code they ran before. ``scaled_dot_product_
attention`` draws one key a call from ``next_rng_key("dropout")`` on
every path, as the reference does on both of its paths (``:137``,
``:995``), so the streams advance alike on the CPU and on the card.

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
K1, K3 and K4 compute it in their mask instantiations (``MASK``, d 64 and
128; csrc/attn_mask.cuh), reading the mask in place through four element
strides, each block walking the tiles of ``mask_bounds`` (the device-side
port of the reference's ``_mask_block_bounds``). The mask mode keeps a
row's statistics as the pair (m, log l), shape (b, h, sq, 2), in place of
the lse: a float mask can put a whole row at −1e10 and a bool mask at
−1e30, where an fp32 lse m + log l loses log l, and with it the backward's
1/l. A dense mask with the window, with dropout, or at kernel d 256 raises
(ROADMAP Queue B rows 1-3).
"""

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import dropout as drop_ops

NEG_INF = -1e30
# the device type whose tensors the kernels take (a test sets "meta" to run
# the wrappers' checks and argument marshalling up to the C call)
KERNEL_DEVICE = "cuda"
# the head dims K1, K3 and K4 are built for (the reference's kernel widths,
# :351); at 256 only their windowless, dropout-free kernels. The dispatch
# zero-pads any other d <= 256 to the next of them (_pad_head_dim)
FWD_DIMS = (64, 128, 256)
BWD_DIMS = (64, 128, 256)
# the kernels' tiles, which the mask bounds count in: K1 and K3 walk 128-
# (K1) or 64-key (K3) tiles for blocks of 128 query rows, K4 64-row query
# tiles for blocks of 128 keys
BLOCK_ROWS, K1_KEYS, K3_KEYS = 128, 128, 64
K4_KEYS, K4_ROWS = 128, 64


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


def _structured_mask(sq, sk, is_causal, kv_lens, causal_offset, device,
                     window=None):
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


def mask_bounds(mask, b, h, nkv, sq, sk, is_causal=False, kv_lens=None,
                causal_offset=None):
    """The tiles each block of K1, K3 and K4 walks under a dense mask: the
    reference's ``_mask_block_bounds`` (:445, all-masked prefix and suffix
    blocks skipped, per row block or, ``axis_q=False``, per key block) at
    the port kernels' own tiles, computed on the mask's device with no host
    sync. `mask` is ``dense_mask``'s view. Returns int32 [lo, hi) pairs:
    ``fwd`` (b, h, ceil(sq/128), 2) of K1's 128-key tiles, ``dq`` the same
    of K3's 64-key tiles, ``dkv`` (b, nkv, ceil(sk/128), 2) of K4's 64-row
    query tiles, the union over a kv head's query heads.

    A tile is left out only when no entry can change a row: every entry
    bool False or float −inf, or hidden by the structured masks (kv_lens,
    causal), which are folded in. A "dead" row, some key visible to the
    structured masks but none of them valid (bool True, or a float entry
    above NEG_INF / 2), takes the softmax over every key (the uniform one
    for a bool mask: the mean of v), so its row block walks every key tile
    and its query tile lies in every key block's range."""
    dev = mask.device
    mb, mh, mq = mask.shape[:3]
    if mask.dtype == torch.bool:
        skip_ok, live = mask, mask
    else:
        skip_ok = mask != float("-inf")   # NaN stays in
        live = mask > NEG_INF * 0.5
    skip_ok = skip_ok.expand(mb, mh, mq, sk)
    live = live.expand(mb, mh, mq, sk)
    vis = _visible_keys(b, sq, sk, is_causal, kv_lens, causal_offset, dev)
    first = torch.where(live.any(-1), live.to(torch.uint8).argmax(-1), sk)
    dead = (vis[:, None] > 0) & (first >= vis[:, None])    # (B, mh, sq)

    nqb = -(-sq // BLOCK_ROWS)
    nk3 = -(-sk // K3_KEYS)
    nk1 = -(-sk // K1_KEYS)
    dead_b = _tiles_any(dead, nqb, BLOCK_ROWS)              # (B, mh, nqb)
    tiles = _tiles_any(skip_ok, nk3, K3_KEYS)               # (mb, mh, mq, nk3)
    if mq != 1:
        tiles = _tiles_any(tiles.transpose(2, 3), nqb,
                           BLOCK_ROWS).transpose(2, 3)      # (mb, mh, nqb, nk3)
    lo3, hi3 = _first_last(tiles, nk3)
    # the structured limit of each block: its last row's visible keys
    last = torch.clamp(torch.arange(nqb, device=dev) * BLOCK_ROWS
                       + BLOCK_ROWS - 1, max=sq - 1)
    kend = vis[:, last][:, None]                           # (vb, 1, nqb)
    hi3 = torch.minimum(hi3, -(-kend // K3_KEYS))
    lo1, hi1 = lo3 // 2, (hi3 + 1) // 2
    lo3, hi3 = torch.where(dead_b, 0, lo3), torch.where(dead_b, nk3, hi3)
    lo1, hi1 = torch.where(dead_b, 0, lo1), torch.where(dead_b, nk1, hi1)

    nkb = -(-sk // K4_KEYS)
    nqt = -(-sq // K4_ROWS)
    keys = _tiles_any(skip_ok, nkb, K4_KEYS)                # (mb, mh, mq, nkb)
    if mq == 1:
        rows = keys.expand(mb, mh, nqt, nkb)
    else:
        rows = _tiles_any(keys.transpose(2, 3), nqt,
                          K4_ROWS).transpose(2, 3)          # (mb, mh, nqt, nkb)
    dead_t = _tiles_any(dead, nqt, K4_ROWS)                 # (B, mh, nqt)
    if mh == h and nkv < h:   # a kv head walks its query heads' union
        rows = rows.reshape(mb, nkv, h // nkv, nqt, nkb).any(2)
        dead_t = dead_t.reshape(dead_t.shape[0], nkv, h // nkv, nqt).any(2)
    lo4, hi4 = _first_last(rows.transpose(2, 3), nqt)       # (mb, mh', nkb)
    # the structured lower limit: no row sees a key past its kv_len; under
    # causal the first row that sees key k0 is k0 - offset (K4's qt0)
    k0 = torch.arange(nkb, device=dev) * K4_KEYS
    kvlen = _visible_keys(b, 1, sk, False, kv_lens, None, dev)   # (vb, 1)
    off = sk - sq if causal_offset is None else int(causal_offset)
    qs0 = ((k0 - off).clamp(min=0) // K4_ROWS if is_causal
           else torch.zeros_like(k0))[None]
    qs0 = torch.where(k0[None] >= kvlen, nqt, qs0)          # (vb, nkb)
    lo4 = torch.maximum(lo4, qs0[:, None])
    empty4 = lo4 >= hi4
    lo4, hi4 = torch.where(empty4, nqt, lo4), torch.where(empty4, 0, hi4)
    lox, hix = _first_last(dead_t, nqt)                     # (B, mh')
    lo4 = torch.minimum(lo4, lox[..., None])
    hi4 = torch.maximum(hi4, hix[..., None])
    return {"fwd": _pairs(lo1, hi1, (b, h, nqb)),
            "dq": _pairs(lo3, hi3, (b, h, nqb)),
            "dkv": _pairs(lo4, hi4, (b, nkv, nkb))}


def _call_bounds(q, k, attn_mask, is_causal, kv_lens, causal_offset):
    """``mask_bounds`` of a call's mask on (b, sq, h, d) q and (b, sk,
    nkv, d) k."""
    b, sq, h, _ = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    return mask_bounds(dense_mask(attn_mask, b, h, sq, sk), b, h, nkv, sq,
                       sk, is_causal, kv_lens, causal_offset)


def _masked_scores(s, mask, structured):
    """The scores of ``_xla_attention`` under a dense mask (s scaled, fp32):
    t = where(structured, s, NEG_INF), then where(mask, t, NEG_INF) for a
    bool mask or t + mask for a float one; and g, where t depends on s."""
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    t = s if structured is None else torch.where(structured, s, neg)
    g = torch.ones((), dtype=torch.bool, device=s.device) \
        if structured is None else structured
    if mask.dtype == torch.bool:
        return torch.where(mask, t, neg), g & mask
    return t + mask.to(s.dtype), g


def _check_dropout(dropout_p, key):
    """The dropout arguments of the kernels' wrappers and plain versions:
    p in [0, 1], and a key (2,) whenever p > 0."""
    if not 0.0 <= dropout_p <= 1.0:
        raise ValueError(f"dropout_p must be in [0, 1], got {dropout_p}")
    if dropout_p > 0.0 and key is None:
        raise ValueError("attention dropout needs the draw's key")
    return float(dropout_p)


def _drop_probs(probs, z, dropout_p):
    """where(z, probs / keep, 0), keep = 1 - p in probs' dtype (the
    reference's ``probs / keep``)."""
    return torch.where(z, drop_ops.divide_by_keep(probs, dropout_p),
                       torch.zeros((), dtype=probs.dtype, device=probs.device))


def _xla_attention(q, k, v, attn_mask=None, is_causal=False, scale=None,
                   kv_lens=None, causal_offset=None, window=None,
                   dropout_p=0.0, training=True, key=None):
    """The plain version: scores in fp32 (fp64 for fp64 inputs). With
    ``dropout_p`` in training the probabilities are dropped by the draw
    `key` (by default the next key of stream "dropout", as the
    reference's ``_xla_attention`` draws it)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    structured = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                                  q.device, window)
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


def flash_attention_fwd_plain(q, k, v, is_causal=False, scale=None,
                              kv_lens=None, causal_offset=None, window=None,
                              dropout_p=0.0, key=None, attn_mask=None):
    """Plain twin of the kernel: (out (b, sq, h, d) in q's dtype, lse
    (b, h, sq) fp32), computed in fp32. Fully-masked rows give out 0 and
    lse NEG_INF, as the kernel does. With ``dropout_p`` the normalised
    probabilities are dropped by ``attention_keep_mask(key)``; the lse
    stays the undropped one. With ``attn_mask`` the scores are
    ``_xla_attention``'s and the lse is the pair (m, log l), (b, h, sq, 2)
    (``_masked_fwd_plain``)."""
    dropout_p = _check_dropout(dropout_p, key)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                            q.device, window)
    if attn_mask is not None:
        _refuse_mask_modes("flash_attention_fwd_plain", window, dropout_p)
        return _masked_fwd_plain(s, vf, mask, dense_mask(
            attn_mask, b, h, sq, sk, q.device), q.dtype)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    l = p.sum(-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    pn = p / lsafe
    if dropout_p > 0.0:
        pn = _drop_probs(pn, drop_ops.attention_keep_mask(
            key, dropout_p, b, h, sq, sk, q.device), dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", pn, vf).to(q.dtype)
    lse = (m + torch.log(lsafe))[..., 0]
    return out, lse


def _masked_fwd_plain(s, vf, structured, mask, dtype):
    """The mask mode of the forward twin: out = softmax(t)·v over every key
    with t ``_masked_scores``'s, and the pair (m, log l); a row the
    structured masks hide wholly gives 0 and (NEG_INF, −inf), a float row
    at −inf everywhere NaN (as ``_xla_attention``'s softmax)."""
    t, _ = _masked_scores(s, mask, structured)
    m = t.amax(-1, keepdim=True)
    p = torch.exp(t - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    stats = torch.cat([m, torch.log(l)], -1)
    if structured is not None:
        live = structured.any(-1, keepdim=True)                # (., 1, sq, 1)
        out = torch.where(live[..., 0].transpose(1, 2)[..., None], out,
                          torch.zeros((), device=out.device))
        stats = torch.where(live, stats, torch.tensor(
            [NEG_INF, -math.inf], device=out.device))
    return out.to(dtype), stats.expand(t.shape[:3] + (2,)).contiguous()


def _masked_bwd_plain(s, qf, kf, vf, of, out, stats, structured, mask,
                      scale):
    """The mask mode of the backward twin: P = exp(t − m − log l) from the
    forward's pair (0 where l = 0), dS = P∘(dP − Δ) where t depends on s
    and 0 elsewhere, dv = Pᵀ·dO over every element."""
    t, g = _masked_scores(s, mask, structured)
    m, logl = stats.float()[..., :1], stats.float()[..., 1:]
    p = torch.exp(t - m - torch.where(logl == -math.inf, math.inf, logl))
    delta = (of * out.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    ds = torch.where(g, p * (dp - delta), torch.zeros((), device=s.device))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, of))


def flash_attention_bwd_plain(q, k, v, out, lse, dout, is_causal=False,
                              scale=None, kv_lens=None, causal_offset=None,
                              window=None, dropout_p=0.0, key=None,
                              attn_mask=None):
    """Plain twin of the backward kernels: (dq, dk, dv) in fp32 from the
    forward's (out, lse), with the kernels' contract: P = exp(S·scale − lse)
    on visible keys and 0 on a row whose lse is NEG_INF, Δ = rowsum(dO∘O),
    dS = P∘(dP − Δ), dq = scale·dS·K, dk = scale·dSᵀ·Q, dv = Pᵀ·dO, and the
    GQA groups summed into their kv head. With ``dropout_p`` (Z the keep
    mask of `key`): dS = P∘(dP∘Z/keep − Δ) and dv = (P∘Z/keep)ᵀ·dO. With
    ``attn_mask`` `lse` is the forward's pair (m, log l)
    (``_masked_bwd_plain``)."""
    dropout_p = _check_dropout(dropout_p, key)
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    n_rep = h // nkv
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    qf, of = q.float(), dout.float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if attn_mask is not None:
        _refuse_mask_modes("flash_attention_bwd_plain", window, dropout_p)
        dq, dk, dv = _masked_bwd_plain(
            s, qf, kf, vf, of, out, lse, _structured_mask(
                sq, sk, is_causal, kv_lens, causal_offset, q.device),
            dense_mask(attn_mask, b, h, sq, sk, q.device), scale)
        if n_rep != 1:
            dk = dk.reshape(b, sk, nkv, n_rep, d).sum(3)
            dv = dv.reshape(b, sk, nkv, n_rep, d).sum(3)
        return dq, dk, dv
    lse = lse.float()[..., None]
    p = torch.exp(s - lse)
    keep = (lse > NEG_INF * 0.5).expand_as(p)
    mask = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                            q.device, window)
    if mask is not None:
        keep = keep & mask
    p = torch.where(keep, p, torch.zeros((), device=q.device))
    delta = (of * out.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    pd = p
    if dropout_p > 0.0:
        z = drop_ops.attention_keep_mask(key, dropout_p, b, h, sq, sk,
                                         q.device)
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


def _check_kernel_inputs(what, q, k, v, *more, dims=BWD_DIMS):
    """Raise on what the CUDA kernels do not take: q/k/v and the bf16
    tensors in `more` on q's CUDA device, bf16, contiguous, 16-byte aligned
    (K1 and K4 read them through TMA tensor maps), head_dim in `dims`, kv
    heads dividing the heads. Returns (b, sq, sk, h, nkv, d)."""
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
    if d not in dims or k.shape != (b, sk, nkv, d) or v.shape != k.shape:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (head_dim "
                         f"{' or '.join(map(str, dims))})")
    if nkv == 0 or h % nkv:
        raise ValueError(f"{what}: {h} heads not a multiple of {nkv} kv "
                         "heads")
    if sq == 0 or b == 0:
        raise ValueError(f"{what}: empty q")
    return b, sq, sk, h, nkv, d


def _check_rows(what, b, h, sq, q, masked=False, **rows):
    """lse / delta: fp32 (b, h, sq), contiguous, on q's device; a masked
    call's lse the (b, h, sq, 2) pairs."""
    for name, t in rows.items():
        shape = (b, h, sq, 2) if masked and name == "lse" else (b, h, sq)
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


def _drop_args(dropout_p, key):
    """The kernels' dropout arguments: (drop, k1, k2, thr, 1/keep)."""
    if dropout_p <= 0.0:
        return [0, 0, 0, 0, 1.0]
    keep = float(np.float32(1.0 - dropout_p))
    k1, k2 = rng.key_words(key)
    return [1, k1, k2, drop_ops.keep_threshold(dropout_p),
            float(np.float32(1.0) / np.float32(keep)) if keep > 0 else 0.0]


def _refuse_mask_modes(what, window, dropout_p, d=None):
    """A dense mask runs without the window and dropout, at kernel d 64 and
    128: the rest raises, naming ROADMAP Queue B rows 1-3."""
    if window is not None or dropout_p > 0.0 or d == 256:
        raise NotImplementedError(
            f"{what}: a dense attn_mask with the sliding window, with "
            "dropout or at head_dim 256 is not ported yet (ROADMAP Queue B "
            "rows 1-3); the mask runs alone at head_dim 64 and 128")


class _MaskArg(ctypes.Structure):
    """csrc/attn_mask.cuh's am::Mask: the mask's pointer, its element
    strides (b, h, q, k; 0 on a broadcast dim), fp32 or bool, and the
    block bounds."""
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("sq", ctypes.c_longlong),
                ("sk", ctypes.c_longlong), ("f32", ctypes.c_int),
                ("bounds", ctypes.c_void_p)]


def _mask_arg(what, attn_mask, bounds, part, q, b, h, sq, sk):
    """The kernels' mask argument (a pointer to _MaskArg, None without a
    mask) and the tensors it points into, which the caller keeps alive
    over the launch. `part` is the kernel's entry of ``mask_bounds``'s
    dict `bounds`."""
    if attn_mask is None:
        return None, None
    m = dense_mask(attn_mask, b, h, sq, sk)
    if m.device != q.device:
        raise ValueError(f"{what}: attn_mask on {m.device}, expected "
                         f"{q.device}")
    bd = bounds[part]
    arg = _MaskArg(m.data_ptr(), *(0 if m.shape[i] == 1 else m.stride(i)
                                   for i in range(4)),
                   int(m.dtype != torch.bool), bd.data_ptr())
    return ctypes.pointer(arg), (m, bd, arg)


def _refuse_d256_modes(what, d, window, dropout_p, rows):
    """At head dim 256 the kernels are built windowless and without dropout
    only: those modes raise, naming their ROADMAP Queue B rows."""
    if d == 256 and (window is not None or dropout_p > 0.0):
        raise NotImplementedError(
            f"{what}: the sliding window and dropout at head_dim 256 are not "
            f"ported yet (ROADMAP Queue B {rows}); d 256 runs windowless and "
            "without dropout")


def flash_attention_fwd(q, k, v, is_causal=False, scale=None, kv_lens=None,
                        causal_offset=None, window=None, dropout_p=0.0,
                        key=None, attn_mask=None, bounds=None):
    """Flash-attention forward: (out, lse) as flash_attention_fwd_plain.

    CUDA tensors launch ``csrc/flash_attention.cu`` (bf16, head_dim 64, 128
    or 256, contiguous; with ``dropout_p`` its dropout instantiation, keyed
    by `key`; with ``attn_mask`` its mask instantiation, walking `bounds`
    (``mask_bounds``, computed here when None); the window, dropout and
    mask modes at d 64 and 128 only); anything else on CUDA raises. CPU
    tensors take the plain twin. Inputs that require grad, with grad mode
    on, raise: the output of a raw kernel carries no gradient."""
    _refuse_grad("flash_attention_fwd", q, k, v)
    window = _check_window(window, is_causal)
    dropout_p = _check_dropout(dropout_p, key)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, is_causal, scale, kv_lens,
                                         causal_offset, window, dropout_p,
                                         key, attn_mask)
    b, sq, sk, h, nkv, d = _check_kernel_inputs("flash_attention_fwd",
                                                q, k, v, dims=FWD_DIMS)
    if attn_mask is not None:
        _refuse_mask_modes("flash_attention_fwd", window, dropout_p, d)
        if bounds is None:
            bounds = _call_bounds(q, k, attn_mask, is_causal, kv_lens,
                                  causal_offset)
    _refuse_d256_modes("flash_attention_fwd", d, window, dropout_p, "row 1")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_off = (sk - sq) if causal_offset is None else int(causal_offset)
    kl = _kv_lens_arg(kv_lens, b, q.device)
    out = torch.empty_like(q)
    marg, keep = _mask_arg("flash_attention_fwd", attn_mask, bounds, "fwd",
                           q, b, h, sq, sk)
    lse = torch.empty((b, h, sq) + ((2,) if keep else ()),
                      dtype=torch.float32, device=q.device)
    lib = _kernel_lib("flash_attention", "flash_attention_fwd", 6, 9)
    # window 0: the windowless kernel; a window takes the windowed one
    # (beyond 2^30 it masks nothing and stays a C int)
    err = lib.flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _build.ptr(kl) if kl is not None else None,
        b, sq, sk, h, nkv, d, int(bool(is_causal)), q_off,
        min(window or 0, 1 << 30), float(scale), marg,
        *_drop_args(dropout_p, key), _build.stream_of(q))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.windowed += window is not None
    flash_attention_fwd.dropout += dropout_p > 0.0
    flash_attention_fwd.masked += keep is not None
    flash_attention_fwd.by_d[d] += 1
    _build.check(err, "flash_attention_fwd")
    return out, lse


# launches, and of them those of the windowed, the dropout and the mask
# instantiations, and those at each head dim
flash_attention_fwd.launches = 0
flash_attention_fwd.windowed = 0
flash_attention_fwd.dropout = 0
flash_attention_fwd.masked = 0
flash_attention_fwd.by_d = dict.fromkeys(FWD_DIMS, 0)


def _bwd_args(what, part, q, k, v, dout, lse, delta, is_causal, scale,
              kv_lens, causal_offset, window, dropout_p, key, attn_mask,
              bounds):
    window = _check_window(window, is_causal)
    dropout_p = _check_dropout(dropout_p, key)
    b, sq, sk, h, nkv, d = _check_kernel_inputs(what, q, k, v,
                                                ("dout", dout))
    if attn_mask is not None:
        _refuse_mask_modes(what, window, dropout_p, d)
        if bounds is None:
            bounds = _call_bounds(q, k, attn_mask, is_causal, kv_lens,
                                  causal_offset)
    _refuse_d256_modes(what, d, window, dropout_p, "rows 2-3")
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    _check_rows(what, b, h, sq, q, attn_mask is not None, lse=lse,
                delta=delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_off = (sk - sq) if causal_offset is None else int(causal_offset)
    kl = _kv_lens_arg(kv_lens, b, q.device)
    head = [_build.ptr(t) for t in (q, k, v, dout, lse, delta)]
    marg, keep = _mask_arg(what, attn_mask, bounds, part, q, b, h, sq, sk)
    # window 0: the windowless kernels; a window takes the windowed ones
    # (beyond 2^30 it masks nothing and stays a C int), as K1's wrapper
    tail = [b, sq, sk, h, nkv, d, int(bool(is_causal)), q_off,
            min(window or 0, 1 << 30), float(scale), marg,
            *_drop_args(dropout_p, key), _build.stream_of(q)]
    return head, _build.ptr(kl) if kl is not None else None, tail, d, keep


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, is_causal=False,
                           scale=None, kv_lens=None, causal_offset=None,
                           window=None, dropout_p=0.0, key=None,
                           attn_mask=None, bounds=None):
    """dq (bf16, q's shape) by the K3 kernel of ``csrc/flash_attention_bwd.cu``
    from the forward's lse and Δ = rowsum(dO∘O), both fp32 (b, h, sq);
    head_dim 64, 128 or 256; ``window`` (with ``is_causal``) launches its
    windowed instantiation, ``dropout_p`` (with the forward's `key`) its
    dropout one, ``attn_mask`` (with the forward's (m, log l) pairs as
    `lse`; `bounds` as K1's) its mask one (each at d 64 and 128 only).
    CUDA tensors only (the CPU path is ``flash_attention_bwd_plain``)."""
    head, kl, tail, d, keep = _bwd_args(
        "flash_attention_bwd_dq", "dq", q, k, v, dout, lse, delta, is_causal,
        scale, kv_lens, causal_offset, window, dropout_p, key, attn_mask,
        bounds)
    dq = torch.empty_like(q)
    lib = _kernel_lib("flash_attention_bwd", "flash_attention_bwd_dq", 8, 9)
    err = lib.flash_attention_bwd_dq(*head, _build.ptr(dq), kl, *tail)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.windowed += window is not None
    flash_attention_bwd_dq.dropout += dropout_p > 0.0
    flash_attention_bwd_dq.masked += keep is not None
    flash_attention_bwd_dq.by_d[d] += 1
    _build.check(err, "flash_attention_bwd_dq")
    return dq


# launches, and of them those of the windowed, the dropout and the mask
# instantiations, and those at each head dim (as flash_attention_fwd's)
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.windowed = 0
flash_attention_bwd_dq.dropout = 0
flash_attention_bwd_dq.masked = 0
flash_attention_bwd_dq.by_d = dict.fromkeys(BWD_DIMS, 0)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, is_causal=False,
                            scale=None, kv_lens=None, causal_offset=None,
                            window=None, dropout_p=0.0, key=None,
                            attn_mask=None, bounds=None):
    """(dk, dv) (bf16, k's shape) by the K4 kernel of
    ``csrc/flash_attention_bwd.cu``; GQA groups are summed in fp32 inside the
    kernel; head dims, ``window``, ``dropout_p`` and ``attn_mask`` as in
    ``flash_attention_bwd_dq``. CUDA tensors only."""
    head, kl, tail, d, keep = _bwd_args(
        "flash_attention_bwd_dkv", "dkv", q, k, v, dout, lse, delta,
        is_causal, scale, kv_lens, causal_offset, window, dropout_p, key,
        attn_mask, bounds)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib("flash_attention_bwd", "flash_attention_bwd_dkv", 9, 9)
    err = lib.flash_attention_bwd_dkv(*head, _build.ptr(dk), _build.ptr(dv),
                                      kl, *tail)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.windowed += window is not None
    flash_attention_bwd_dkv.dropout += dropout_p > 0.0
    flash_attention_bwd_dkv.masked += keep is not None
    flash_attention_bwd_dkv.by_d[d] += 1
    _build.check(err, "flash_attention_bwd_dkv")
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.windowed = 0
flash_attention_bwd_dkv.dropout = 0
flash_attention_bwd_dkv.masked = 0
flash_attention_bwd_dkv.by_d = dict.fromkeys(BWD_DIMS, 0)


def flash_attention_bwd(q, k, v, out, lse, dout, is_causal=False, scale=None,
                        kv_lens=None, causal_offset=None, window=None,
                        dropout_p=0.0, key=None, attn_mask=None,
                        bounds=None):
    """Gradients (dq, dk, dv) of the attention whose forward gave (out,
    lse), in the dtypes of q, k, v. CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors compute Δ = rowsum(dO∘O) in
    fp32 (as the reference does outside its kernels, :1059) and launch K3
    and K4 (their windowed, dropout and mask instantiations under a
    window, a dropout and a dense mask)."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               is_causal, scale, kv_lens,
                                               causal_offset, window,
                                               dropout_p, key, attn_mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(is_causal=is_causal, scale=scale, kv_lens=kv_lens,
              causal_offset=causal_offset, window=window,
              dropout_p=dropout_p, key=key, attn_mask=attn_mask,
              bounds=bounds)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


def _kernel_lib(lib_name, fn_name, n_ptrs, n_ints):
    """The ctypes entry `fn_name` of csrc/<lib_name>.cu: n_ptrs pointers,
    n_ints ints, the float scale, the mask (a pointer to _MaskArg, or
    null), the dropout arguments (drop, the key's two words, the keep
    threshold, 1/keep) and the stream; returns cudaError."""
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        fn.argtypes = ([vp] * n_ptrs + [ci] * n_ints + [cf]
                       + [ctypes.POINTER(_MaskArg)]
                       + [ci, cu, cu, cu, cf] + [vp])
        fn.restype = ctypes.c_int
    return lib


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: K1 forward, K3/K4 backward on CUDA
    tensors; the plain forward and backward on CPU tensors. Port of the
    reference's ``_flash_vjp_entry`` / ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``.

    The kernels take contiguous tensors and raise on anything else, so the
    Function makes q, k, v (GPT's qkv split gives strided views) and the
    incoming gradient contiguous itself, and saves those copies. Under
    dropout it saves the key, not the mask: the backward regenerates it.
    A dense mask is carried with its bounds (computed once for K1, K3 and
    K4) and gets no gradient, as the reference's VJP gives it a zero
    cotangent (:1108-1112)."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale, kv_lens, causal_offset,
                window=None, dropout_p=0.0, key=None, attn_mask=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(is_causal=is_causal, scale=scale, kv_lens=kv_lens,
                  causal_offset=causal_offset, window=window,
                  dropout_p=dropout_p, key=key, attn_mask=attn_mask)
        if attn_mask is not None and q.device.type != "cpu":
            kw["bounds"] = _call_bounds(q, k, attn_mask, is_causal, kv_lens,
                                        causal_offset)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _pad_head_dim(q, k, v, scale):
    """The head-dim half of the reference's ``_pad_for_kernel`` (:339-369):
    a head dim d that K1 is not built for, d <= 256, is zero-padded to the
    next of FWD_DIMS (SD-1.5's 40, 80, 160 to 64, 128, 256). Exact: the
    zero lanes of q and k add 0 to every score, and the caller slices the
    value's pad lanes off the output. The scale is 1/√d of the original d,
    fixed before the pad. Returns (q, k, v, scale, d). The reference's
    short-KV pad (sk to the next 128 with kv_lens) is a TPU tiling device:
    K1 reads a ragged sk through TMA's zero fill and masks past it."""
    d = q.shape[-1]
    if d in FWD_DIMS:
        return q, k, v, scale, d
    dt = next((t for t in FWD_DIMS if t >= d), None)
    if dt is None:
        raise ValueError(
            f"scaled_dot_product_attention: head_dim {d} > 256 has no kernel "
            "on the card (the reference takes it to XLA; ROADMAP Queue B "
            "row 1)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pad = (0, dt - d)
    return (torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), scale, d)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 kv_lens=None, causal_offset: Optional[int] = None,
                                 window_size: Optional[int] = None):
    """Attention with the device dispatch (see the module docstring).

    ``window_size`` is the causal sliding window (needs ``is_causal``): K1
    computes it, and K3/K4 its backward. ``dropout_p`` in training draws
    one key from stream "dropout" on every path: K1 (and K3/K4) drop in
    their dropout instantiations on the card, the plain versions on the
    CPU. On the kernels' device a head dim other than 64, 128 and 256 (up
    to 256) is zero-padded for the kernels (``_pad_head_dim``) and the
    output sliced back, so its gradient runs K3/K4 at the padded d through
    torch's autograd of the pad and the slice (SD-1.5's 160 on K3/K4 at
    256). The window and dropout at kernel d 256 raise (ROADMAP Queue B
    rows 1-3). A dense ``attn_mask`` runs on the card through K1, K3 and
    K4's mask instantiations (d 64 and 128, the padded 40 and 80
    included); with the window, with dropout or at kernel d 256 it raises
    (ROADMAP Queue B rows 1-3), and it never falls back. Segment ids and
    ALiBi are not ported (ROADMAP Queue B row 1). The plain versions take
    any head dim; on the CPU a masked call that needs a gradient runs the
    Function over the plain twins, as an unmasked one does (with the
    window or dropout beside the mask, torch's autograd of the plain
    version)."""
    window = _check_window(window_size, is_causal)
    dropout_p = float(dropout_p) if training else 0.0
    key = rng.next_rng_key("dropout") if dropout_p > 0.0 else None
    _check_dropout(dropout_p, key)
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cpu" and (not needs_grad or (
            attn_mask is not None and (window is not None
                                       or dropout_p > 0.0))):
        return _xla_attention(q, k, v, attn_mask=attn_mask,
                              is_causal=is_causal, scale=scale,
                              kv_lens=kv_lens, causal_offset=causal_offset,
                              window=window, dropout_p=dropout_p, key=key)
    if attn_mask is not None:
        attn_mask = dense_mask(attn_mask, q.shape[0], q.shape[2], q.shape[1],
                               k.shape[1], q.device)
    d = q.shape[-1]
    if q.device.type != "cpu":   # the plain versions take any head dim
        q, k, v, scale, d = _pad_head_dim(q, k, v, scale)
        if attn_mask is not None:
            _refuse_mask_modes("scaled_dot_product_attention", window,
                               dropout_p, q.shape[-1])
    if needs_grad:
        out = FlashAttention.apply(q, k, v, is_causal, scale, kv_lens,
                                   causal_offset, window, dropout_p, key,
                                   attn_mask)
    else:
        # the kernel takes contiguous tensors: GPT's qkv split gives
        # strided views (a no-op copy for the rest, as in FlashAttention)
        out = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), is_causal=is_causal,
                                  scale=scale, kv_lens=kv_lens,
                                  causal_offset=causal_offset, window=window,
                                  dropout_p=dropout_p, key=key,
                                  attn_mask=attn_mask)[0]
    return out if out.shape[-1] == d else out[..., :d]
