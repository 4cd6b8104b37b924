"""Segment ids, ALiBi, the dense mask beside the window, these beside
dropout, and ``flash_fwd_lse`` of paddle_tpu_torch against paddle_tpu.

The contract is the JAX package's ``_xla_attention`` (its CPU path) and
its ``flash_fwd_lse``: segment ids hide a key of another segment at
NEG_INF (a row that no key reaches gives 0), ALiBi adds
slope_h · (k_pos − q_pos − (sk − sq)) to the scaled score before every
mask, and a dense mask beside the window keeps the mask's rules (a row
that a bool mask hides at every key the structured masks leave it is the
mean of v over all sk keys). The port's ``scaled_dot_product_attention``
with a gradient runs ``FlashAttention`` over the plain twins on the CPU
(the kernels' general instantiations on the card), so its output and
gradients are held here to the reference's output and ``jax.vjp`` in fp32
at atol 1e-5, on the same numpy inputs. Dropout beside these is held to
the port's own plain version under the same key (the keep mask the
kernels hash is the reference's, bit for bit). The bounds the kernels
walk (``mask_bounds`` with the window and segment ids) are held to a
brute-force scan, and a forward and a backward that walk only those
bounds' tiles, as the kernels do, to the plain twins.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.ops import dropout as tdrop
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
B = 2


def _inputs(seed, b, sq, sk, h, nkv, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sq, h, d).astype(np.float32))


def _segments(r, b, s, n):
    """(b, s) int32 ids of n packed documents a row, lengths drawn."""
    cuts = np.sort(r.choice(np.arange(1, s), (b, n - 1), replace=True), 1)
    ids = np.zeros((b, s), np.int32)
    for bi in range(b):
        for c in cuts[bi]:
            ids[bi, c:] += 1
    return ids


def _slopes(h):
    """ALiBi's geometric slopes 2^(-8i/h), i = 1 … h."""
    return np.array([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                    np.float32)


def _left_padded(b, s, pads):
    """(b, 1, 1, s) bool key mask: row i hides its first pads[i] keys."""
    m = np.ones((b, 1, 1, s), bool)
    for bi, p in enumerate(pads):
        m[bi, ..., :p] = False
    return m


# name: (sq, sk, h, nkv, d, causal, extra); extra builds the modes from a
# RandomState: seg (self), seg_cross, alibi, window, kv_lens, mask
CASES = {
    "seg_self_causal": (160, 160, 4, 2, 64, True, ("seg",)),
    "seg_self_full_odd_d": (144, 144, 4, 4, 40, False, ("seg",)),
    "seg_cross_unmatched_row": (128, 192, 4, 2, 64, False, ("seg_cross",)),
    "seg_kv_lens": (150, 150, 4, 2, 64, True, ("seg", "kv_lens")),
    "seg_window": (200, 200, 4, 2, 64, True, ("seg", "window")),
    "alibi": (160, 160, 4, 2, 64, True, ("alibi",)),
    "alibi_window": (200, 200, 4, 4, 64, True, ("alibi", "window")),
    "alibi_kv_lens": (176, 176, 4, 2, 64, True, ("alibi", "kv_lens")),
    "alibi_cross_odd_d": (128, 200, 4, 2, 40, True, ("alibi",)),
    "mask_window_left_pad": (256, 256, 4, 2, 64, True, ("pad", "window")),
    "mask_window_float": (192, 192, 4, 2, 64, True, ("float", "window")),
    "mask_seg_alibi_window": (224, 224, 4, 2, 64, True,
                              ("pad", "seg", "alibi", "window")),
}


def _modes(name, seed=0):
    """The case's inputs (numpy) and modes: dict of the reference's keyword
    arguments (numpy values) beside q, k, v, dO."""
    sq, sk, h, nkv, d, causal, extra = CASES[name]
    r = np.random.RandomState(seed + 100)
    q, k, v, do = _inputs(seed, B, sq, sk, h, nkv, d)
    kw = {"is_causal": causal}
    if "seg" in extra:
        kw["segment_ids"] = _segments(r, B, sq, 3)
    if "seg_cross" in extra:
        kw["segment_ids"] = _segments(r, B, sq, 3)
        kw["kv_segment_ids"] = _segments(r, B, sk, 3)
        kw["segment_ids"][1, 40:45] = 7        # no key of segment 7
    if "alibi" in extra:
        kw["alibi_slopes"] = _slopes(h)
    if "window" in extra:
        kw["window_size"] = 48
    if "kv_lens" in extra:
        kw["kv_lens"] = np.array([sk, sk - 37], np.int32)
    if "pad" in extra:
        kw["attn_mask"] = _left_padded(B, sk, (0, 77))
    if "float" in extra:
        m = (r.randn(B, 1, sq, sk) * 2).astype(np.float32)
        m[:, :, 9] = -1e4
        m[1, :, 100:110, :120] = -np.inf
        kw["attn_mask"] = m
    return (q, k, v, do), kw


def _torch_kw(kw):
    return {n: torch.from_numpy(np.ascontiguousarray(a))
            if isinstance(a, np.ndarray) else a for n, a in kw.items()}


def _jax_kw(kw):
    return {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for n, a in kw.items()}


def _reference(arrays, kw):
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    jkw = _jax_kw(kw)
    ref, pull = jax.vjp(lambda *t: jfa.scaled_dot_product_attention(
        *t, **jkw), q, k, v)
    return np.asarray(ref), [np.asarray(g) for g in pull(do)]


@pytest.mark.parametrize("name", list(CASES))
def test_modes_match_reference(name):
    """The dispatch with a gradient (FlashAttention over the plain twins)
    and without one (``_xla_attention``): out and dq, dk, dv within
    1e-5 of the reference's out and jax.vjp."""
    arrays, kw = _modes(name)
    ref, gref = _reference(arrays, kw)
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    out = tfa.scaled_dot_product_attention(*t, **_torch_kw(kw))
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(arrays[3]))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    for n, g, r in zip("qkv", t, gref):
        np.testing.assert_allclose(g.grad.numpy(), r, atol=ATOL,
                                   err_msg=f"d{n}")
    with torch.no_grad():
        plain = tfa.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in arrays[:3]), **_torch_kw(kw))
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL)
    if name == "seg_cross_unmatched_row":
        assert float(out.detach()[1, 40:45].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["seg_self_causal", "alibi_window",
                                  "mask_window_left_pad"])
def test_entry_points_agree(name):
    """``nn.functional.flash_attention`` and ``ops.flash_attn`` return
    (out, None) with the dispatch's out; ``nn.functional.
    scaled_dot_product_attention`` takes the reference's arguments."""
    arrays, kw = _modes(name)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays[:3])
    tkw = _torch_kw(kw)
    want = tfa.scaled_dot_product_attention(tq, tk, tv, **tkw)
    fkw = dict(tkw)
    fkw["causal"] = fkw.pop("is_causal")
    for fn in (tnn.functional.flash_attention, tops.flash_attn):
        out, none = fn(tq, tk, tv, **fkw)
        assert none is None and torch.equal(out, want)
    assert torch.equal(tnn.functional.scaled_dot_product_attention(
        tq, tk, tv, **tkw), want)


@pytest.mark.parametrize("name", ["seg_self_causal", "alibi_kv_lens",
                                  "mask_window_float"])
def test_plain_twins_give_the_pairs(name):
    """flash_attention_fwd_plain in the general mode gives the reference's
    output and the pairs (m, log l), whose sum is the log-sum-exp of the
    reference's scores; flash_attention_bwd_plain from them gives jax.vjp's
    gradients."""
    arrays, kw = _modes(name)
    ref, gref = _reference(arrays, kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    tkw = _torch_kw(kw)
    pkw = dict(is_causal=tkw["is_causal"], kv_lens=tkw.get("kv_lens"),
               window=tkw.get("window_size"),
               attn_mask=tkw.get("attn_mask"),
               seg_q=tkw.get("segment_ids"),
               seg_k=tkw.get("kv_segment_ids", tkw.get("segment_ids")),
               alibi_slopes=tkw.get("alibi_slopes"))
    out, stats = tfa.flash_attention_fwd_plain(tq, tk, tv, **pkw)
    b, sq, h, d = arrays[0].shape
    assert stats.shape == (b, h, sq, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # the reference's scores in float64, their log-sum-exp
    sk = arrays[1].shape[1]
    kr = np.repeat(arrays[1], h // arrays[1].shape[2], axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", arrays[0].astype(np.float64),
                  kr) / math.sqrt(d)
    if "alibi_slopes" in kw:
        dist = np.arange(sk)[None] - (np.arange(sq)[:, None] + sk - sq)
        s = s + kw["alibi_slopes"][None, :, None, None] * dist
    st = tfa._structured_mask(sq, sk, pkw["is_causal"], pkw["kv_lens"],
                              None, "cpu", pkw["window"], pkw["seg_q"],
                              pkw["seg_k"]).numpy()
    s = np.where(st, s, -1e30)
    if "attn_mask" in kw:
        s = s + kw["attn_mask"]
    mx = s.max(-1)
    lse = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    got = (stats[..., 0].double() + stats[..., 1].double()).numpy()
    live = st.any(-1).repeat(h // st.shape[1], 1) if st.shape[1] == 1 \
        else st.any(-1)
    live = np.broadcast_to(live, got.shape)
    np.testing.assert_allclose(got[live], lse[live], atol=ATOL)
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, out, stats, tdo, **pkw)
    for g, r in zip(grads, gref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL)


DROP_CASES = ["seg_self_causal", "alibi_window", "mask_window_left_pad",
              "mask_window_float", "mask_seg_alibi_window"]


@pytest.mark.parametrize("name", DROP_CASES)
def test_modes_with_dropout(name):
    """Dropout 0.1 beside each mode: FlashAttention over the plain twins
    (the kernels' flat-index keep mask, regenerated in the backward)
    against the port's plain version (``_xla_attention``, autograd) under
    the same draw: out and every gradient within 1e-5, and the two keep
    masks equal bit for bit; the output also within 1e-5 of the
    reference's under the same key."""
    arrays, kw = _modes(name, seed=3)
    tkw = _torch_kw(kw)
    key = jax.random.PRNGKey(5)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    b, sq, h, _ = arrays[0].shape
    sk = arrays[1].shape[1]
    drawn = trng.fold_in(tkey, 0)      # the stream's first key
    assert torch.equal(tdrop.attention_keep_mask(drawn, 0.1, b, h, sq, sk),
                       tdrop.keep_mask(drawn, 0.1, (b, h, sq, sk)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    with trng.rng_guard(dropout=tkey):
        out = tfa.scaled_dot_product_attention(*t, dropout_p=0.1, **tkw)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(arrays[3]))
    p = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    seg_q, seg_k = tfa._check_segments(tkw.get("segment_ids"),
                                       tkw.get("kv_segment_ids"), sq, sk)
    ref = tfa._xla_attention(
        *p, attn_mask=tkw.get("attn_mask"), is_causal=tkw["is_causal"],
        kv_lens=tkw.get("kv_lens"), window=tkw.get("window_size"),
        dropout_p=0.1, key=drawn, seg_q=seg_q, seg_k=seg_k,
        alibi_slopes=tkw.get("alibi_slopes"))
    ref.backward(torch.from_numpy(arrays[3]))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL)
    for n, g, r in zip("qkv", t, p):
        np.testing.assert_allclose(g.grad.numpy(), r.grad.numpy(),
                                   atol=ATOL, err_msg=f"d{n}")
    jkw = _jax_kw(kw)
    from paddle_tpu.core import rng as jrng
    with jrng.rng_guard(dropout=key):
        jref = jfa.scaled_dot_product_attention(
            *(jnp.asarray(a) for a in arrays[:3]), dropout_p=0.1, **jkw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jref),
                               atol=ATOL)


@pytest.mark.parametrize("sq,h,nkv,d,causal", [
    (128, 4, 4, 64, True), (192, 4, 2, 64, False), (160, 4, 2, 40, True)])
def test_flash_fwd_lse_matches_reference(sq, h, nkv, d, causal):
    """out and lse of ``flash_fwd_lse`` and the gradients under a random
    g_lse beside dO, against the reference's ``flash_fwd_lse`` and
    jax.vjp of its two outputs."""
    q, k, v, do = _inputs(sq + d, B, sq, sq, h, nkv, d)
    g_lse = np.random.RandomState(1).randn(B, h, sq).astype(np.float32)
    (ref, ref_lse), pull = jax.vjp(
        lambda *t: jfa.flash_fwd_lse(*t, causal, None),
        *(jnp.asarray(a) for a in (q, k, v)))
    gref = pull((jnp.asarray(do), jnp.asarray(g_lse)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = tfa.flash_fwd_lse(*t, is_causal=causal)
    assert lse.shape == (B, h, sq) and lse.dtype == torch.float32
    torch.autograd.backward([out, lse], [torch.from_numpy(do),
                                         torch.from_numpy(g_lse)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_lse),
                               atol=ATOL)
    for n, g, r in zip("qkv", t, gref):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("bad", ["segment_ids_alone_cross",
                                 "kv_segment_ids_alone", "alibi_not_causal",
                                 "alibi_wrong_shape"])
def test_reference_value_errors(bad):
    """The reference's ValueErrors, raised by the port's dispatch (and by
    the reference on the same arguments)."""
    q, k, v, _ = _inputs(0, 1, 8, 12, 2, 2, 16)
    sq_ids, sk_ids = np.zeros((1, 8), np.int32), np.zeros((1, 12), np.int32)
    kw = {"segment_ids_alone_cross": dict(segment_ids=sq_ids),
          "kv_segment_ids_alone": dict(kv_segment_ids=sk_ids),
          "alibi_not_causal": dict(alibi_slopes=_slopes(2)),
          "alibi_wrong_shape": dict(alibi_slopes=_slopes(3),
                                    is_causal=True)}[bad]
    with pytest.raises(ValueError) as ref_err:
        jfa.scaled_dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), **_jax_kw(kw))
    with pytest.raises(ValueError) as err:
        tfa.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), **_torch_kw(kw))
    assert str(err.value) == str(ref_err.value)


# ---- the bounds the kernels walk ----------------------------------------------


def _structure(b, sq, sk, causal, kv_lens, off, window, seg_q, seg_k):
    """(reach (b, sq, sk), lo (b, sq), hi (b, sq)): the keys the structured
    masks leave each row, and the range [lo, hi) kv_lens, causal and the
    window cut."""
    lo = np.zeros((b, sq), np.int64)
    hi = np.full((b, sq), sk)
    if kv_lens is not None:
        hi = np.minimum(hi, np.clip(np.array(kv_lens), 0, sk)[:, None])
    if causal:
        hi = np.minimum(hi, np.clip(np.arange(sq) + off + 1, 0, None))
    if window is not None:
        lo = np.maximum(lo, np.clip(np.arange(sq) + off - window + 1, 0,
                                    sk))
    keys = np.arange(sk)
    reach = (keys >= lo[..., None]) & (keys < hi[..., None])
    if seg_q is not None:
        reach &= seg_q[:, :, None] == seg_k[:, None, :]
    return reach, lo, hi


def _brute_bounds(m, b, h, nkv, sq, sk, causal, kv_lens, off, window,
                  seg_q, seg_k):
    """mask_bounds by loops: each block's hull of the tiles holding an
    entry that is not skippable (bool True, float not -inf), cut by the
    row range's limits (the block's last row's end, its first row's window
    start; segment ids cut nothing), and every tile for a block that holds
    a dead row (some key the structured masks leave, none of them live)."""
    m = np.broadcast_to(m, (b, h, sq, sk))
    ok = m if m.dtype == bool else m != -np.inf
    live = m if m.dtype == bool else m > -5e29
    reach, lo_r, hi_r = _structure(b, sq, sk, causal, kv_lens, off, window,
                                   seg_q, seg_k)
    dead = reach.any(-1)[:, None] & ~(reach[:, None] & live).any(-1)

    def hull(flags):
        idx = np.nonzero(flags)[0]
        return (idx[0], idx[-1] + 1) if len(idx) else (None, 0)

    def rows_side(tk):
        nqb, nk = -(-sq // 128), -(-sk // tk)
        out = np.zeros((b, h, nqb, 2), np.int32)
        for bi in range(b):
            for hi in range(h):
                for qb in range(nqb):
                    rs = slice(qb * 128, min(sq, qb * 128 + 128))
                    if dead[bi, hi, rs].any():
                        out[bi, hi, qb] = (0, nk)
                        continue
                    lo, hi_ = hull([ok[bi, hi, rs, t * tk:(t + 1) * tk].any()
                                    for t in range(nk)])
                    hi_ = min(hi_, -(-hi_r[bi, rs].max() // tk))
                    lo = None if lo is None else max(lo,
                                                     lo_r[bi, rs].min() // tk)
                    if lo is not None and lo < hi_:
                        out[bi, hi, qb] = (lo, hi_)
        return out

    nkb, nqt, rep = -(-sk // 128), -(-sq // 64), h // nkv
    dkv = np.zeros((b, nkv, nkb, 2), np.int32)
    for bi in range(b):
        kl = sk if kv_lens is None else min(max(kv_lens[bi], 0), sk)
        for kh in range(nkv):
            hs = slice(kh * rep, (kh + 1) * rep)
            dlo, dhi = hull([dead[bi, hs, t * 64:(t + 1) * 64].any()
                             for t in range(nqt)])
            for kb in range(nkb):
                k0 = kb * 128
                lo, hi_ = hull([ok[bi, hs, t * 64:(t + 1) * 64,
                                   k0:k0 + 128].any() for t in range(nqt)])
                qs0 = nqt if k0 >= kl else (
                    max(0, k0 - off) // 64 if causal else 0)
                lo = None if lo is None else max(lo, qs0)
                if window is not None:
                    last = k0 + 127 - off + window - 1
                    hi_ = min(hi_, 0 if last < 0 else last // 64 + 1)
                if lo is None or lo >= hi_:
                    lo, hi_ = None, 0
                if dlo is not None:
                    lo = dlo if lo is None else min(lo, dlo)
                    hi_ = max(hi_, dhi)
                if lo is not None and lo < hi_:
                    dkv[bi, kh, kb] = (lo, hi_)
    return {"fwd": rows_side(128), "dq": rows_side(64), "dkv": dkv}


# (mask form, sq, sk, h, nkv, causal, kv_lens, causal_offset, window, seg)
BOUND_CASES = {
    "left_pad_window": ("pad", 640, 640, 4, 2, True, None, None, 200, False),
    "left_pad_window_gqa4": ("pad", 520, 520, 4, 1, True, None, None, 129,
                             False),
    "float_window_kv_lens": ("float", 400, 400, 2, 2, True, [400, 260],
                             None, 150, False),
    "pad_segments": ("pad", 384, 384, 4, 2, True, None, None, None, True),
    "bool4d_segments_window": ("bool4d", 300, 300, 2, 2, True, None, None,
                               90, True),
    "no_mask_window_segments": (None, 600, 600, 4, 2, True, [600, 333],
                                None, 256, True),
    "no_mask_offset_window": (None, 200, 500, 2, 2, True, None, 250, 130,
                              False),
    "cross_segments": ("pad", 256, 384, 2, 1, False, None, None, None, True),
}


def _bound_inputs(name):
    form, sq, sk, h, nkv, causal, kv_lens, coff, window, seg = \
        BOUND_CASES[name]
    r = np.random.RandomState(sq + sk)
    mask = None
    if form == "pad":
        mask = _left_padded(B, sk, (0, sk // 3))
    elif form == "float":
        mask = np.where(r.rand(B, 1, sq, sk) < 0.3, -np.inf,
                        r.randn(B, 1, sq, sk)).astype(np.float32)
        mask[1, :, 50:60] = -1e30          # dead rows
    elif form == "bool4d":
        mask = r.rand(B, h, sq, sk) > 0.9
        mask[0, 1, 200:210] = False        # dead rows
    seg_q = _segments(r, B, sq, 4) if seg else None
    seg_k = (seg_q if sq == sk else _segments(r, B, sk, 4)) if seg else None
    return (mask, sq, sk, h, nkv, causal, kv_lens, coff, window, seg_q,
            seg_k)


@pytest.mark.parametrize("name", list(BOUND_CASES))
def test_mask_bounds_with_window_and_segments(name):
    """``mask_bounds`` with the window and segment ids (and without a dense
    mask) equals a brute-force scan, for K1's, K3's and K4's tiles."""
    mask, sq, sk, h, nkv, causal, kv_lens, coff, window, seg_q, seg_k = \
        _bound_inputs(name)
    m4 = None if mask is None else tfa.dense_mask(torch.from_numpy(mask), B,
                                                  h, sq, sk)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tfa.mask_bounds(m4, B, h, nkv, sq, sk, causal, kv_lens, coff,
                          window, t(seg_q), t(seg_k), device="cpu")
    off = sk - sq if coff is None else coff
    want = _brute_bounds(np.ones((1, 1, 1, sk), bool) if mask is None
                         else mask, B, h, nkv, sq, sk, causal, kv_lens, off,
                         window, seg_q, seg_k)
    for part in ("fwd", "dq", "dkv"):
        np.testing.assert_array_equal(got[part].numpy(), want[part],
                                      err_msg=part)


def _walked(bounds, part, b, h, sq, sk, nkv):
    """(b, h, sq, sk) bool: the (row, key) elements a kernel's walk of its
    bounds touches (K1, K3: each 128-row block's key tiles; K4: each
    128-key block's 64-row query tiles, for every query head of its kv
    head)."""
    bd = bounds[part].numpy()
    w = np.zeros((b, h, sq, sk), bool)
    if part in ("fwd", "dq"):
        tk = 128 if part == "fwd" else 64
        for bi, hi, qb in np.ndindex(*bd.shape[:3]):
            lo, hi_ = bd[bi, hi, qb]
            w[bi, hi, qb * 128:qb * 128 + 128, lo * tk:hi_ * tk] = True
        return w
    rep = h // nkv
    for bi, kh, kb in np.ndindex(*bd.shape[:3]):
        lo, hi_ = bd[bi, kh, kb]
        w[bi, kh * rep:(kh + 1) * rep, lo * 64:hi_ * 64,
          kb * 128:kb * 128 + 128] = True
    return w


@pytest.mark.parametrize("name", ["left_pad_window", "pad_segments",
                                  "float_window_kv_lens",
                                  "bool4d_segments_window",
                                  "no_mask_window_segments"])
def test_walking_the_bounds_gives_the_plain_result(name):
    """The kernels see only the elements of the tiles their bounds name
    (the rest scores -inf for them, as a tile never loaded). A forward
    over K1's walk, and dq over K3's and dk, dv over K4's, in fp32, equal
    the plain twins: no tile that a row needs (a dead row needs every key)
    is left out."""
    mask, sq, sk, h, nkv, causal, kv_lens, coff, window, seg_q, seg_k = \
        _bound_inputs(name)
    d = 16
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(9, B, sq, sk, h, nkv,
                                                        d))
    t = lambda a: None if a is None else torch.from_numpy(a)
    kw = dict(is_causal=causal, kv_lens=kv_lens, causal_offset=coff,
              window=window, seg_q=t(seg_q), seg_k=t(seg_k),
              attn_mask=t(mask), alibi_slopes=torch.from_numpy(_slopes(h)))
    out, stats = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    grads = tfa.flash_attention_bwd_plain(q, k, v, out, stats, do, **kw)
    m4 = None if mask is None else tfa.dense_mask(t(mask), B, h, sq, sk)
    bounds = tfa.mask_bounds(m4, B, h, nkv, sq, sk, causal, kv_lens, coff,
                             window, t(seg_q), t(seg_k), device="cpu")
    # the scores as the kernels take them, -inf off the walk
    s = tfa._plain_scores(q, k, 1 / math.sqrt(d), sq, sk, coff,
                          kw["alibi_slopes"])
    st = tfa._structured_mask(sq, sk, causal, kv_lens, coff, "cpu", window,
                              kw["seg_q"], kw["seg_k"])
    tm, g = tfa._masked_scores(s, m4, st)
    if m4 is None:       # without a mask a hidden key is -inf in the kernel
        tm = torch.where(st, tm, -math.inf)
    walk = torch.from_numpy(_walked(bounds, "fwd", B, h, sq, sk, nkv))
    tw = torch.where(walk, tm, -math.inf)
    mx = tw.amax(-1, keepdim=True)
    p = torch.exp(tw - torch.where(mx == -math.inf, 0.0, mx))
    lsum = p.sum(-1, keepdim=True)
    seen = (st & walk).any(-1, keepdim=True)
    pn = torch.where(seen, p / lsum.clamp_min(1e-38), 0.0)
    vf = tfa._repeat_kv(v, h // nkv)
    out_w = torch.einsum("bhqk,bkhd->bqhd", pn, vf)
    np.testing.assert_allclose(out_w.numpy(), out.numpy(), atol=ATOL)
    # the backward from the twin's pairs, each kernel over its own walk
    mm, logl = stats[..., :1], stats[..., 1:]
    pb = torch.exp(tm - mm - torch.where(logl == -math.inf, math.inf, logl))
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = torch.where(g, pb * (dp - delta), 0.0)
    kf = tfa._repeat_kv(k, h // nkv)
    wq = torch.from_numpy(_walked(bounds, "dq", B, h, sq, sk, nkv))
    dq = torch.einsum("bhqk,bkhd->bqhd", torch.where(wq, ds, 0.0), kf) / \
        math.sqrt(d)
    wk = torch.from_numpy(_walked(bounds, "dkv", B, h, sq, sk, nkv))
    sum_kv = lambda x: x.reshape(B, sk, nkv, h // nkv, d).sum(3)
    dk = sum_kv(torch.einsum("bhqk,bqhd->bkhd", torch.where(wk, ds, 0.0),
                             q)) / math.sqrt(d)
    dv = sum_kv(torch.einsum("bhqk,bqhd->bkhd", torch.where(wk, pb, 0.0),
                             do))
    for n, got, want in zip("qkv", (dq, dk, dv), grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   err_msg=f"d{n}")


# ---- the kernels' dispatch (meta tensors stand for CUDA tensors) ------------


class _Captured(Exception):
    pass


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernels' C entries replaced by a recorder of their general-mode
    argument (None, or its fields) that returns success; meta tensors taken
    as the kernels' device; the wrappers' counters restored afterwards."""
    got = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                # the argument after the scale, the first float
                mod = args[1 + next(i for i, a in enumerate(args)
                                    if isinstance(a, float))]
                got[name] = None if mod is None else {
                    f: getattr(mod.contents, f)
                    for f, _ in tfa._ModArg._fields_}
                return 0
            return entry

    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: None)
    for w in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv):
        for count in ("launches",) + tfa.MODE_COUNTERS:
            monkeypatch.setattr(w, count, 0)
        monkeypatch.setattr(w, "by_d", dict.fromkeys(w.by_d, 0))
    return got


def _meta(*shape, grad=False, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype, device="meta",
                       requires_grad=grad)


META_MODES = {
    "segments": dict(segment_ids=_meta(2, 256, dtype=torch.int32),
                     is_causal=True),
    "alibi": dict(alibi_slopes=_meta(4, dtype=torch.float32),
                  is_causal=True),
    "mask_window": dict(attn_mask=_meta(2, 1, 1, 256, dtype=torch.bool),
                        is_causal=True, window_size=100),
    "mask_dropout": dict(attn_mask=_meta(2, 1, 1, 256, dtype=torch.bool),
                         dropout_p=0.1),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", list(META_MODES))
def test_general_mode_reaches_the_kernels(kernel_calls, mode, d):
    """A gradient through each new mode at head dim 64 and 128 reaches K1,
    K3 and K4's C entries with the general argument (the window in it),
    and counts one launch each on the mode's counter; nothing raises."""
    kw = META_MODES[mode]
    leaves = [_meta(2, 256, 4, d, grad=True), _meta(2, 256, 2, d, grad=True),
              _meta(2, 256, 2, d, grad=True)]
    out = tfa.scaled_dot_product_attention(*leaves, **kw)
    out.backward(torch.empty_like(out))
    wraps = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
             tfa.flash_attention_bwd_dkv)
    for w in wraps:
        name = w.__name__
        assert kernel_calls[name] is not None, name
        assert kernel_calls[name]["window"] == kw.get("window_size", 0)
        assert w.launches == w.general == 1 and w.by_d[d] == 1
        assert w.segmented == (mode == "segments")
        assert w.alibi == (mode == "alibi")
        assert w.mask_window == (mode == "mask_window")
        assert w.masked == mode.startswith("mask")
        assert w.dropout == (mode == "mask_dropout")


@pytest.mark.parametrize("mode", list(META_MODES) + ["window", "dropout"])
def test_each_modifier_at_d256_raises(kernel_calls, mode):
    """At kernel head dim 256 (native or 160 padded) each mode raises
    NotImplementedError naming ROADMAP Queue B rows 1-3, at the dispatch
    and at each kernel's wrapper, before any C entry."""
    kw = dict(META_MODES.get(mode, {}))
    if mode == "window":
        kw = dict(is_causal=True, window_size=100)
    elif mode == "dropout":
        kw = dict(dropout_p=0.1)
    for d in (256, 160):
        with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
            tfa.scaled_dot_product_attention(
                _meta(2, 256, 4, d), _meta(2, 256, 2, d),
                _meta(2, 256, 2, d), **kw)
    q, k = _meta(2, 256, 4, 256), _meta(2, 256, 2, 256)
    wkw = dict(is_causal=kw.get("is_causal", False),
               window=kw.get("window_size"), attn_mask=kw.get("attn_mask"),
               alibi_slopes=kw.get("alibi_slopes"))
    if "segment_ids" in kw:
        wkw.update(seg_q=kw["segment_ids"], seg_k=kw["segment_ids"])
    if kw.get("dropout_p"):
        wkw.update(dropout_p=0.1, key=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
        tfa.flash_attention_fwd(q, k, k, **wkw)
    lse = _meta(2, 4, 256, 2, dtype=torch.float32)
    for bwd in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
            bwd(q, k, k, q, lse, lse[..., 0], **wkw)
    assert kernel_calls == {}


def test_flash_fwd_lse_on_the_kernel_path(kernel_calls, monkeypatch):
    """On the kernels' device ``flash_fwd_lse`` runs K1 without the general
    argument (an lse (b, h, s), not pairs), and its backward, given both
    cotangents, K3 and K4 with a (b, h, s) Δ and that lse (the values Δ
    takes under g_lse are held on the CPU above and on the card in
    tests/test_torch_attn_modes_cuda.py)."""
    deltas = []
    real = tfa._check_rows

    def spy(what, b, h, sq, q, general=False, **rows):
        deltas.append((general, rows["delta"].shape))
        return real(what, b, h, sq, q, general, **rows)
    monkeypatch.setattr(tfa, "_check_rows", spy)
    leaves = [_meta(1, 128, 2, 64, grad=True) for _ in range(3)]
    out, lse = tfa.flash_fwd_lse(*leaves, is_causal=True)
    assert lse.shape == (1, 2, 128) and lse.dtype == torch.float32
    torch.autograd.backward([out, lse], [torch.empty_like(out),
                                         torch.empty_like(lse)])
    assert kernel_calls["flash_attention_fwd"] is None
    assert kernel_calls["flash_attention_bwd_dkv"] is None
    assert deltas == [(False, (1, 2, 128))] * 2
