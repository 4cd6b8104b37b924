"""Dense attention masks of paddle_tpu_torch against paddle_tpu.

The contract is the JAX package's ``_xla_attention`` (its CPU path): a
bool mask puts NEG_INF on the keys it hides, a float mask is added to the
scaled score in fp32 after the structured masks (causal, kv_lens) put
NEG_INF on theirs, and the mask broadcasts right-aligned against
(b, h, sq, sk). The port's ``scaled_dot_product_attention`` with a mask
that needs a gradient runs ``FlashAttention`` over the plain twins on the
CPU (K1, K3 and K4's mask instantiations on the card), so its output and
``torch.autograd`` gradients are held here to the reference's output and
``jax.vjp`` in fp32 at atol 1e-5, on the same numpy inputs, for every mask
form with causal, kv_lens, GQA and cross-attention. The bounds the kernels
walk (``mask_bounds``) are held to a brute-force scan.

Corner rows, named in the kernels (csrc/attn_mask.cuh):
* a row that a bool mask hides at every key gives the mean of v over all
  sk keys (every score is the same NEG_INF), not 0 as the reference's
  Pallas kernel gives;
* a float row at -inf everywhere gives NaN, as the reference's CPU path;
* a row at -1e10 everywhere is the softmax of its true scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
B, H = 2, 4


def _mask(form, b, h, sq, sk, seed):
    """A mask of the named form (numpy), every row with a live key."""
    r = np.random.RandomState(seed)
    if form == "2d_bool":
        m = r.rand(sq, sk) > 0.4
    elif form == "3d_bool":
        m = r.rand(h, sq, sk) > 0.4
    elif form == "3d_float_h1":
        m = (r.randn(1, sq, sk) * 2).astype(np.float32)
    elif form == "key_padding":                    # (b, 1, 1, s) bool
        lens = np.array([sk, max(1, sk // 2)])[:b]
        m = (np.arange(sk)[None, :] < lens[:, None])[:, None, None, :]
    elif form == "4d_bool":
        m = r.rand(b, h, sq, sk) > 0.4
    elif form == "4d_fp32":
        m = (r.randn(b, h, sq, sk) * 2).astype(np.float32)
    elif form == "bf16":
        return torch.from_numpy((r.randn(b, 1, sq, sk) * 2).astype(
            np.float32)).to(torch.bfloat16)
    elif form == "neg1e4":                         # PaddleNLP's padding
        lens = np.array([sk, max(1, sk - 3)])[:b]
        m = np.where(np.arange(sk)[None, :] < lens[:, None], 0.0,
                     -1e4).astype(np.float32)[:, None, None, :]
    elif form == "neg1e10":                        # whole rows at -1e10
        m = (r.randn(b, 1, sq, sk)).astype(np.float32)
        m[:, :, ::3] = -1e10
    elif form == "neginf_tiles":                   # -inf blocks, a live
        m = np.zeros((b, h, sq, sk), np.float32)   # column left per row
        m[:, :, : sq // 2, sk // 2:] = -np.inf
        m[:, :, sq // 2:, 1: sk // 2] = -np.inf
    else:
        raise ValueError(form)
    if m.dtype == bool:
        m[..., 0] = True      # every row keeps key 0 (causal sees it)
    return torch.from_numpy(np.ascontiguousarray(m))


FORMS = ["2d_bool", "3d_bool", "3d_float_h1", "key_padding", "4d_bool",
         "4d_fp32", "bf16", "neg1e4", "neg1e10", "neginf_tiles"]
# (sq, sk, nkv, causal, kv_lens)
VARIANTS = {"causal": (9, 9, 4, True, None),
            "kv_lens": (7, 10, 4, False, [10, 6]),
            "gqa": (8, 8, 2, True, None),
            "cross": (6, 11, 1, False, None)}


def _inputs(seed, b, sq, sk, h, nkv, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sq, h, d).astype(np.float32))


def _jax_mask(m):
    if m.dtype == torch.bfloat16:
        return jnp.asarray(m.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(m.numpy())


def _check(q, k, v, do, mask, causal, kv_lens, atol=ATOL):
    """Output and dq, dk, dv of the port's dispatch (the Function over the
    plain twins) against the reference's output and jax.vjp."""
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    kl_t = None if kv_lens is None else torch.tensor(kv_lens)
    out = tfa.scaled_dot_product_attention(*t, attn_mask=mask,
                                           is_causal=causal, kv_lens=kl_t)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    kl_j = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    f = lambda q_, k_, v_: jfa.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=_jax_mask(mask), is_causal=causal,
        kv_lens=kl_j)
    ref, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol)
    for g, r in zip((t[0].grad, t[1].grad, t[2].grad),
                    pull(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("form", FORMS)
def test_masked_attention_matches_reference(form, variant):
    sq, sk, nkv, causal, kv_lens = VARIANTS[variant]
    q, k, v, do = _inputs(FORMS.index(form), B, sq, sk, H, nkv, 16)
    _check(q, k, v, do, _mask(form, B, H, sq, sk, 7), causal, kv_lens)


@pytest.mark.parametrize("form", ["4d_bool", "neg1e10", "key_padding"])
def test_plain_twins_take_the_mask(form):
    """flash_attention_fwd_plain gives the reference's output and the pair
    (m, log l) whose sum is the log-sum-exp of the masked scores;
    flash_attention_bwd_plain from them gives jax.vjp's gradients."""
    sq, sk, nkv = 7, 12, 2
    q, k, v, do = _inputs(3, B, sq, sk, H, nkv, 16)
    mask = _mask(form, B, H, sq, sk, 5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, stats = tfa.flash_attention_fwd_plain(tq, tk, tv, is_causal=True,
                                               attn_mask=mask)
    assert stats.shape == (B, H, sq, 2)
    f = lambda q_, k_, v_: jfa.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=_jax_mask(mask), is_causal=True)
    ref, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the log-sum-exp of _xla_attention's scores, in float64
    kr = np.repeat(k, H // nkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr).astype(np.float64) / 4.0
    s = np.where(np.tril(np.ones((sq, sk), bool), sk - sq), s, -1e30)
    m = mask.float().numpy()
    s = np.where(m, s, -1e30) if mask.dtype == torch.bool else s + m
    mx = s.max(-1)
    lse = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    np.testing.assert_allclose((stats[..., 0].double() + stats[..., 1]
                                .double()).numpy(), lse, rtol=1e-6)
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, out, stats, tdo,
                                          is_causal=True, attn_mask=mask)
    for g, r in zip(grads, pull(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_row_hidden_by_a_bool_mask_is_the_mean_of_v():
    """Every key of row 2 hidden by a bool mask, under causal: every score
    is NEG_INF, the softmax is uniform over all sk keys (future keys
    included), the row gives the mean of v, and dv gets dO/sk at every key
    (the reference's CPU path; its Pallas kernel gives 0 there). The pair
    (m, log l) keeps log sk beside -1e30."""
    sq = sk = 6
    q, k, v, do = _inputs(9, 1, sq, sk, 2, 2, 8)
    m = np.ones((1, 1, sq, sk), bool)
    m[..., 2, :] = False
    mask = torch.from_numpy(m)
    out, stats = tfa.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        attn_mask=mask)
    np.testing.assert_allclose(out[0, 2].numpy(), v[0].mean(0), atol=ATOL)
    np.testing.assert_allclose(stats[0, :, 2].numpy(),
                               [[-1e30, np.log(sk)]] * 2, rtol=1e-6)
    _check(q, k, v, do, mask, True, None)


def test_float_row_at_minus_inf_is_nan():
    """A float row at -inf at every key gives NaN, in the reference's CPU
    path and in the port's plain versions alike; the other rows are
    untouched."""
    q, k, v, _ = _inputs(4, 1, 5, 5, 2, 2, 8)
    m = np.zeros((1, 1, 5, 5), np.float32)
    m[..., 1, :] = -np.inf
    ref = np.asarray(jfa.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), attn_mask=jnp.asarray(m)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = tfa.scaled_dot_product_attention(*t, attn_mask=torch.from_numpy(m))
    twin, stats = tfa.flash_attention_fwd_plain(*t,
                                                attn_mask=torch.from_numpy(m))
    assert np.isnan(ref[0, 1]).all() and np.isnan(out[0, 1].numpy()).all()
    assert np.isnan(twin[0, 1].numpy()).all()
    assert np.isnan(stats[0, :, 1, 1].numpy()).all()
    np.testing.assert_allclose(twin.numpy(), ref, atol=ATOL)


def test_row_at_minus_1e10_is_the_softmax_of_its_scores():
    """A row at -1e10 at every key is not a masked row: its softmax is that
    of s - 1e10, here uniform (fp32 rounds every s - 1e10 to -1e10), and
    the gradients flow through it. The pair (m, log l) keeps log l, which
    an fp32 lse beside -1e10 drops."""
    q, k, v, do = _inputs(6, 1, 6, 6, 2, 1, 8)
    m = np.zeros((1, 1, 6, 6), np.float32)
    m[..., 4, :] = -1e10
    mask = torch.from_numpy(m)
    out, stats = tfa.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), attn_mask=mask)
    np.testing.assert_allclose(out[0, 4].numpy(),
                               np.repeat(v[0].mean(0), 2, 0), atol=ATOL)
    np.testing.assert_allclose(stats[0, :, 4, 1].numpy(), np.log(6),
                               rtol=1e-6)
    _check(q, k, v, do, mask, False, None)


def test_mask_with_window_or_dropout_or_d256_raises_on_the_kernel_path():
    """The mask at kernel head dim 256 (native, or 160 padded) raises by
    name (ROADMAP Queue B rows 1-3) on the kernels' dispatch (a meta tensor
    takes it). The mask beside the window and beside dropout, which raised
    before the general instantiations, now run: beside the window the
    dispatch's output and gradients equal the reference's (atol 1e-5), and
    beside dropout the plain twin equals the plain version under the same
    key."""
    m = torch.ones(1, 1, 4, 4, dtype=torch.bool, device="meta")
    q256 = torch.zeros(1, 4, 2, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
        tfa.scaled_dot_product_attention(q256, q256, q256, attn_mask=m)
    q160 = torch.zeros(1, 4, 2, 160, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
        tfa.scaled_dot_product_attention(q160, q160, q160, attn_mask=m)
    # the mask beside the window: parity with the reference
    q, k, v, do = _inputs(8, B, 12, 12, H, 2, 16)
    mask = _mask("key_padding", B, H, 12, 12, 3)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.scaled_dot_product_attention(*t, attn_mask=mask,
                                           is_causal=True, window_size=3)
    out.backward(torch.from_numpy(do))
    ref, pull = jax.vjp(lambda *a: jfa.scaled_dot_product_attention(
        *a, attn_mask=_jax_mask(mask), is_causal=True, window_size=3),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    for g, r in zip(t, pull(jnp.asarray(do))):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), atol=ATOL)
    # the mask beside dropout: the plain twin against the plain version
    key = torch.tensor([3, 9], dtype=torch.int64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    twin, _ = tfa.flash_attention_fwd_plain(tq, tk, tv, dropout_p=0.1,
                                            key=key, attn_mask=mask)
    plain = tfa._xla_attention(tq, tk, tv, attn_mask=tfa.dense_mask(
        mask, B, H, 12, 12), dropout_p=0.1, key=key)
    np.testing.assert_allclose(twin.numpy(), plain.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="does not broadcast"):
        tfa.dense_mask(torch.ones(3, 4), 1, 2, 4, 4)


# ---- the bounds the kernels walk --------------------------------------------


def _brute_bounds(mask, b, h, nkv, sq, sk, causal, kv_lens, off):
    """mask_bounds by loops over the expanded mask: each block's hull of
    the tiles holding an entry that is not skippable (bool True, float not
    -inf), cut by the structured limits, and every tile for a block that
    holds a dead row (some key visible to the structured masks, none of
    them live: bool True or float above -5e29)."""
    m = np.broadcast_to(mask.numpy(), (b, h, sq, sk))
    ok = m if m.dtype == bool else m != -np.inf
    live = m if m.dtype == bool else m > -5e29
    vis = np.full((b, sq), sk)
    if kv_lens is not None:
        vis = np.minimum(vis, np.clip(np.array(kv_lens), 0, sk)[:, None])
    if causal:
        vis = np.minimum(vis, np.clip(np.arange(sq) + off + 1, 0, None))
    dead = np.zeros((b, h, sq), bool)
    for bi in range(b):
        for hi in range(h):
            for r in range(sq):
                n = vis[bi, r]
                dead[bi, hi, r] = n > 0 and not live[bi, hi, r, :n].any()

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
                    hi_ = min(hi_, -(-vis[bi, rs].max() // tk))
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
                if lo is None or lo >= hi_:
                    lo, hi_ = None, 0
                if dlo is not None:
                    lo = dlo if lo is None else min(lo, dlo)
                    hi_ = max(hi_, dhi)
                if lo is not None and lo < hi_:
                    dkv[bi, kh, kb] = (lo, hi_)
    return {"fwd": rows_side(128), "dq": rows_side(64), "dkv": dkv}, ok, vis


@pytest.mark.parametrize("case", [
    # (form, sq, sk, h, nkv, causal, kv_lens, causal_offset)
    ("4d_bool", 300, 200, 4, 2, False, None, None),
    ("4d_bool", 300, 300, 4, 1, True, None, None),
    ("key_padding", 260, 260, 4, 4, True, [260, 70], None),
    ("neginf_tiles", 280, 390, 2, 2, False, [390, 130], None),
    ("block_sparse", 384, 384, 2, 2, False, None, None),
    ("dead_rows", 200, 330, 4, 2, True, None, 100),
])
def test_mask_bounds_match_a_brute_force_scan(case):
    form, sq, sk, h, nkv, causal, kv_lens, coff = case
    b = 2
    r = np.random.RandomState(sq + sk)
    if form == "block_sparse":        # 2-D: whole 64 x 64 blocks hidden
        blk = r.rand(6, 6) > 0.5
        blk[np.arange(6), np.arange(6)] = True
        mask = torch.from_numpy(np.kron(blk, np.ones((64, 64), bool))
                                .astype(bool))
    elif form == "dead_rows":         # rows hidden at every key, and rows
        m = np.ones((b, h, sq, sk), np.float32)   # live only past causal
        m[:, :, 10] = -1e30
        m[0, 1, 150] = -np.inf
        m[1, :, 170, :] = -np.inf
        m[1, :, 170, sk - 5:] = 0.0
        mask = torch.from_numpy(m)
    else:
        mask = _mask(form, b, h, sq, sk, 11)
        if form == "4d_bool":
            mask = torch.from_numpy(r.rand(b, h, sq, sk) > 0.97)
    m4 = tfa.dense_mask(mask, b, h, sq, sk)
    got = tfa.mask_bounds(m4, b, h, nkv, sq, sk, causal, kv_lens, coff)
    off = sk - sq if coff is None else coff
    want, ok, vis = _brute_bounds(m4, b, h, nkv, sq, sk, causal, kv_lens,
                                  off)
    for part in ("fwd", "dq", "dkv"):
        np.testing.assert_array_equal(got[part].numpy(), want[part],
                                      err_msg=part)
    # every tile holding a visible, unskippable entry lies in its range
    lo, hi = got["dq"][..., 0].numpy(), got["dq"][..., 1].numpy()
    vis_ok = ok & (np.arange(sk)[None, None, None, :]
                   < vis[:, None, :, None])
    for bi, hi_, r_, k_ in zip(*np.nonzero(vis_ok)):
        t = k_ // 64
        assert lo[bi, hi_, r_ // 128] <= t < hi[bi, hi_, r_ // 128]
