"""The attention's keep words (``ops.dropout.attention_keep_words``): the
dropout mask of K1, K3 and K4 hashed once a call and packed 32 keys a word.

The contract is the JAX package's CPU mask, ``jax.random.bernoulli(key,
1 - p, (b, h, sq, sk))`` (``paddle_tpu/ops/flash_attention.py:139``), its
bits kept where the structured limits (the causal limit with its offset,
kv_lens, the window's lower edge) leave a key, every key below sk in the
general mode. The plain forward and backward twins given the words equal
the same calls given the key bit for bit; ``FlashAttention`` (which makes
the words in its forward and hands them to its backward) equals the
reference's ``_xla_attention`` and its ``jax.vjp`` gradients; on the
kernels' device K1's, K3's and K4's C entries get the words, which
``FlashAttention`` makes once a forward and hands to K3 and K4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import rng as jrng
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import dropout as tdrop
from paddle_tpu_torch.ops import flash_attention as tfa

# fp32 forward / gradient tolerances against the reference (the plain
# twins' fp32 sums in another order than XLA's)
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed, n):
    """The JAX key fold_in(PRNGKey(seed), n) and the port's copy of it."""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _visible(b, sq, sk, causal, off, kv_lens, window):
    """(b, 1, sq, sk) bool in numpy: the structured limits, written out."""
    q = np.arange(sq)[:, None] + (sk - sq if off is None else off)
    k = np.arange(sk)[None, :]
    vis = np.ones((b, 1, sq, sk), bool)
    if causal:
        vis &= (k <= q)[None, None]
        if window is not None:
            vis &= (k > q - window)[None, None]
    if kv_lens is not None:
        vis &= (k[None] < np.asarray(kv_lens)[:, None, None])[:, None]
    return vis


def _packed(z):
    """(…, sk) bool packed as the kernels read it: int32 words, bit i of
    word w the entry at 32w + i, rows padded to ceil(sk / 128)·4 words."""
    sk = z.shape[-1]
    pad = -(-sk // 128) * 128 - sk
    z = np.concatenate([z, np.zeros(z.shape[:-1] + (pad,), bool)], -1)
    return np.packbits(z, axis=-1, bitorder="little").view("<i4")


# (b, h, sq, sk, causal, causal_offset, kv_lens, window, everything)
WORD_CASES = [
    (2, 4, 9, 9, True, None, None, None, False),          # causal
    (2, 3, 6, 13, False, None, None, None, False),        # sk % 32 != 0
    (3, 8, 6, 70, False, None, [70, 33, 0], None, False),  # kv_lens, a row 0
    (2, 4, 17, 40, True, 20, None, 5, False),             # offset, window
    (2, 6, 5, 300, True, 290, [300, 150], None, False),   # GQA width, 3 rows
    (2, 4, 33, 129, True, None, [129, 64], 7, False),     # every limit
    (1, 2, 40, 160, True, None, [100], 9, True),          # everything
]
WORD_IDS = [f"b{c[0]}-h{c[1]}-sq{c[2]}-sk{c[3]}-{'causal' if c[4] else 'full'}"
            f"-off{c[5]}-{'lens' if c[6] else 'nolens'}-w{c[7]}"
            f"{'-all' if c[8] else ''}" for c in WORD_CASES]


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("case", WORD_CASES, ids=WORD_IDS)
def test_keep_words_plain_are_the_reference_mask(case, p):
    """attention_keep_words_plain (and attention_keep_words on CPU tensors)
    equal jax.random.bernoulli(key, 1 - p, (b, h, sq, sk)) kept inside the
    structured limits (every key with `everything`) and packed little-end
    first, bit for bit; keep_words_mask unpacks them."""
    b, h, sq, sk, causal, off, kv_lens, window, every = case
    jk, tk = _keys(31, sq)
    z = np.asarray(jax.random.bernoulli(jk, 1.0 - p, (b, h, sq, sk)))
    if not every:
        z = z & _visible(b, sq, sk, causal, off, kv_lens, window)
    kw = dict(is_causal=causal, causal_offset=off, window=window,
              kv_lens=None if kv_lens is None else torch.tensor(kv_lens),
              everything=every)
    words = tdrop.attention_keep_words_plain(tk, p, b, h, sq, sk, **kw)
    assert words.dtype == torch.int32
    assert words.shape == (b, h, sq, tdrop.keep_words_width(sk))
    np.testing.assert_array_equal(words.numpy(), _packed(z))
    assert torch.equal(tdrop.attention_keep_words(tk, p, b, h, sq, sk, **kw),
                       words)
    np.testing.assert_array_equal(
        tdrop.keep_words_mask(words, sk).numpy(), z)


@pytest.mark.parametrize("case", WORD_CASES, ids=WORD_IDS)
def test_keep_words_partition_hashes_each_visible_word_once(case):
    """Kernel W's work partition (keep_words_partition, a warp a pair of
    rows): every word that holds a key the limits leave is hashed by
    exactly one warp, no other word is hashed, every row is taken, and no
    warp's words exceed the mean of its batch's two-row warps by more than
    KEEP_WORDS_SLACK (these cases: the triangle, rows alike, windows of a
    few keys)."""
    b, h, sq, sk, causal, off, kv_lens, window, every = case
    rows, wa, wb = tdrop.keep_words_partition(
        b, h, sq, sk, causal, off, kv_lens, window, every)
    ww = tdrop.keep_words_width(sk)
    vis = np.ones((b, 1, sq, sk), bool) if every else \
        _visible(b, sq, sk, causal, off, kv_lens, window)
    vis = np.concatenate([vis, np.zeros((b, 1, sq, ww * 32 - sk), bool)], -1)
    want = np.broadcast_to(vis.reshape(b, 1, sq, ww, 32).any(-1),
                           (b, h, sq, ww))
    count = np.zeros((b, h, sq, ww), int)
    taken = np.zeros((b, h, sq), int)
    for bi, hi, p, r in np.ndindex(rows.shape):
        q = rows[bi, hi, p, r]
        if q >= 0:
            taken[bi, hi, q] += 1
            count[bi, hi, q, wa[bi, hi, p, r]:wb[bi, hi, p, r]] += 1
    assert (taken == 1).all()
    np.testing.assert_array_equal(count, want.astype(int))
    share = (wb - wa).sum(-1)
    for bi in range(b):
        two = share[bi, :, :sq // 2]
        assert share[bi].max() <= two.mean() + tdrop.KEEP_WORDS_SLACK


@pytest.mark.parametrize("shape", [(8, 16, 1024, 1024), (1, 32, 8192, 8192),
                                   (2, 16, 512, 640)],
                         ids=["gpt2-train", "mistral", "offset"])
def test_keep_words_partition_balances_the_causal_triangle(shape):
    """In the causal triangle every two-row warp of kernel W hashes the
    same words to one word, where one warp a 32-word chunk of a row in a
    grid-stride loop gave some warps 2.7× others'."""
    b, h, sq, sk = shape
    _, wa, wb = tdrop.keep_words_partition(b, h, sq, sk, True)
    share = (wb - wa).sum(-1)[..., :sq // 2]
    assert share.max() - share.min() <= 1


def test_keep_words_width_and_pack_bits_are_shared():
    """One width and one packing: the bool mask's words (mask_words) and
    the keep words pad a row alike, and ops.flash_attention takes
    _pack_bits from ops.dropout."""
    assert tfa._pack_bits is tdrop._pack_bits
    for sk, w in ((1, 4), (128, 4), (129, 8), (1024, 32), (1025, 36)):
        assert tdrop.keep_words_width(sk) == w
        assert tfa.mask_words(torch.ones(1, 1, 1, sk, dtype=torch.bool)) \
            .shape[-1] == w


# (b, sq, sk, h, nkv, d, mode kwargs)
TWIN_CASES = {
    "plain_causal": (2, 9, 9, 4, 2, 16, dict(is_causal=True)),
    "plain_lens": (3, 6, 10, 4, 2, 16, dict(kv_lens=[10, 4, 0])),
    "window_offset": (2, 12, 20, 4, 1, 16,
                      dict(is_causal=True, window=5, causal_offset=9)),
    "mask_dead_row": (2, 8, 8, 4, 2, 16, dict(is_causal=True,
                                              attn_mask="pad")),
    "segments": (2, 8, 8, 4, 4, 16, dict(is_causal=True, seg_q="docs")),
    "alibi": (1, 6, 9, 2, 2, 32, dict(is_causal=True, alibi_slopes=[0.5,
                                                                    0.25])),
}


def _twin_inputs(b, sq, sk, h, nkv, d, mode, seed=0):
    """q, k, v, dO from numpy, and the mode's arguments as tensors: "pad"
    a (b, 1, 1, sk) bool mask that left-pads batch 1 by 3 keys (its first
    rows are dead: no key of theirs left), "docs" two segments a row."""
    r = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))
    q, k, v, do = t(b, sq, h, d), t(b, sk, nkv, d), t(b, sk, nkv, d), \
        t(b, sq, h, d)
    kw = dict(mode)
    if kw.get("attn_mask") == "pad":
        m = torch.ones(b, 1, 1, sk, dtype=torch.bool)
        m[1, ..., :3] = False
        kw["attn_mask"] = m
    if kw.get("seg_q") == "docs":
        ids = torch.tensor([[0] * 3 + [1] * (sq - 3), [0] * 5 + [1] * (sq - 5)],
                           dtype=torch.int32)
        kw["seg_q"] = kw["seg_k"] = ids
    if "alibi_slopes" in kw:
        kw["alibi_slopes"] = torch.tensor(kw["alibi_slopes"])
    if "kv_lens" in kw:
        kw["kv_lens"] = torch.tensor(kw["kv_lens"])
    return q, k, v, do, kw


@pytest.mark.parametrize("name", list(TWIN_CASES))
def test_plain_twins_take_the_words(name):
    """flash_attention_fwd_plain and flash_attention_bwd_plain given
    keep_words (attention_keep_words of the call, every key in the general
    mode) equal the same calls given the key, bit for bit, and need no key;
    the wrappers on CPU tensors pass the words through."""
    b, sq, sk, h, nkv, d, mode = TWIN_CASES[name]
    q, k, v, do, kw = _twin_inputs(b, sq, sk, h, nkv, d, mode)
    _, key = _keys(5, 1)
    general = tfa._general(kw.get("attn_mask"), kw.get("seg_q"),
                           kw.get("alibi_slopes"))
    words = tdrop.attention_keep_words(
        key, 0.3, b, h, sq, sk, kw.get("is_causal", False),
        kw.get("causal_offset"), kw.get("kv_lens"), kw.get("window"),
        everything=general)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, dropout_p=0.3, key=key,
                                             **kw)
    out_w, lse_w = tfa.flash_attention_fwd_plain(q, k, v, dropout_p=0.3,
                                                 keep_words=words, **kw)
    assert torch.equal(out, out_w) and torch.equal(lse, lse_w)
    assert torch.equal(tfa.flash_attention_fwd(q, k, v, dropout_p=0.3,
                                               keep_words=words, **kw)[0],
                       out)
    grads = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                          dropout_p=0.3, key=key, **kw)
    grads_w = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            dropout_p=0.3, keep_words=words,
                                            **kw)
    for g, gw in zip(grads, grads_w):
        assert torch.equal(g, gw)
    with pytest.raises(ValueError, match="key"):
        tfa.flash_attention_fwd_plain(q, k, v, dropout_p=0.3, **kw)


# (b, sq, sk, h, nkv, d, causal, left pad of batch 1 or None)
FA_CASES = {"causal_gqa": (2, 9, 9, 4, 2, 16, True, None),
            "left_padded_mask": (2, 10, 10, 4, 2, 16, True, 4)}


def _mask(b, sk, pad):
    m = np.ones((b, 1, 1, sk), bool)
    m[1, ..., :pad] = False
    return m


@pytest.mark.parametrize("name", list(FA_CASES))
def test_flash_attention_function_with_words_matches_jax(name):
    """FlashAttention on CPU tensors with dropout 0.1 (its forward makes
    the keep words once, every key under a mask, and hands them to the
    backward's K4 twin) against the reference's scaled_dot_product_attention
    (_xla_attention) and its jax.vjp under the same key: out within 1e-5,
    dq, dk, dv within 1e-4. The left-padded case has dead rows, whose
    uniform softmax is dropped key by key past their causal limit."""
    b, sq, sk, h, nkv, d, causal, pad = FA_CASES[name]
    r = np.random.RandomState(3)
    q, do = (r.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (r.randn(b, sk, nkv, d).astype(np.float32) for _ in range(2))
    mask = None if pad is None else _mask(b, sk, pad)
    key = jax.random.PRNGKey(41)

    def ref(*a):
        with jrng.rng_guard(dropout=key):
            return jfa.scaled_dot_product_attention(
                *a, is_causal=causal, dropout_p=0.1,
                attn_mask=None if mask is None else jnp.asarray(mask))

    out_ref, pull = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    g_ref = pull(jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    made = tdrop.attention_keep_words.launches
    with trng.rng_guard(dropout=torch.from_numpy(
            np.asarray(key).astype(np.int64))):
        out = tfa.scaled_dot_product_attention(
            *t, is_causal=causal, dropout_p=0.1,
            attn_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    assert tdrop.attention_keep_words.launches == made   # CPU: no launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=OUT_ATOL)
    for n, g, gr in zip("qkv", t, g_ref):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(gr),
                                   atol=GRAD_ATOL, err_msg=f"d{n}")


class _Lib:
    """A kernel library whose C entries record their arguments in `got`
    (by name) and then raise _Captured, or return 0 (no error) with
    `ok`."""

    def __init__(self, got, ok=False):
        self.got, self.ok = got, ok

    def __getattr__(self, name):
        def entry(*args):
            self.got[name] = args
            if not self.ok:
                raise _Captured
            return 0
        return entry


class _Captured(Exception):
    pass


def _on_meta(monkeypatch, lib):
    """The kernels' device made "meta" (meta tensors stand for CUDA
    tensors) with `lib` for every kernel library, pointers passed as the
    tensors themselves; the wrappers' counters restored afterwards."""
    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    for w in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv):
        for name in ("launches",) + tfa.MODE_COUNTERS:
            monkeypatch.setattr(w, name, getattr(w, name))
        monkeypatch.setattr(w, "by_d", dict(w.by_d))


def test_function_saves_the_words_for_k4(monkeypatch):
    """FlashAttention makes the words once a forward (everything in the
    general mode) and its backward hands those same words to the K4 twin;
    a call without dropout makes none. On the kernels' device the same
    words reach K1's, K3's and K4's C entries, made once (one
    attention_keep_words call, the structured limits only), and a raw
    flash_attention_bwd given the key makes one set for both of its
    kernels."""
    made, seen = [], []
    real_make = tdrop.attention_keep_words
    real_bwd = tfa.flash_attention_bwd_plain

    def make(*a, **kw):
        made.append(kw)
        words = real_make(*a, **kw)
        made.append(words)
        return words

    def bwd(*a, keep_words=None, **kw):
        seen.append(keep_words)
        return real_bwd(*a, keep_words=keep_words, **kw)

    monkeypatch.setattr(tdrop, "attention_keep_words", make)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", bwd)
    q, k, v, do, kw = _twin_inputs(*TWIN_CASES["mask_dead_row"][:6],
                                   TWIN_CASES["mask_dead_row"][6])
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    for p, every in ((0.2, True), (0.0, None)):
        made.clear()
        seen.clear()
        with trng.rng_guard(dropout=trng.PRNGKey(3)):
            out = tfa.scaled_dot_product_attention(
                *leaves, is_causal=True, dropout_p=p,
                attn_mask=kw["attn_mask"])
        out.backward(do)
        if p:
            assert len(made) == 2 and made[0]["everything"] is every
            assert seen == [made[1]]
        else:
            assert made == [] and seen == [None]
    got = {}
    _on_meta(monkeypatch, _Lib(got, ok=True))
    b, sq, sk, h, nkv, d = 2, 65, 333, 8, 2, 64
    meta = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device="meta")
    leaves = [meta(b, sq, h, d), meta(b, sk, nkv, d), meta(b, sk, nkv, d)]
    leaves = [t.requires_grad_(True) for t in leaves]
    made.clear()
    out = tfa.FlashAttention.apply(*leaves, True, None, None, None, None,
                                   0.1, trng.PRNGKey(3))
    out.backward(meta(b, sq, h, d))
    assert len(made) == 2 and made[0]["everything"] is False
    words = made[1]
    assert words.shape == (b, h, sq, tdrop.keep_words_width(sk))
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert got[name][-4] is words, name
    # a raw backward given the key makes one set for K3 and K4
    made.clear()
    q, k, v = (t.detach() for t in leaves)
    rows = torch.empty(b, h, sq, device="meta")
    tfa.flash_attention_bwd(q, k, v, meta(b, sq, h, d), rows,
                            meta(b, sq, h, d), is_causal=True, dropout_p=0.1,
                            key=trng.PRNGKey(4))
    assert len(made) == 2 and made[0]["everything"] is False
    assert got["flash_attention_bwd_dq"][-4] is made[1]
    assert got["flash_attention_bwd_dkv"][-4] is made[1]


def test_kernel_entry_points_get_words_and_k3_the_key(monkeypatch):
    """On the kernels' device (meta tensors stand for CUDA tensors; the C
    entries record and raise): K1's, K3's and K4's entries get the keep
    words' pointer, ceil(sk / 128)·4 words a row and 1/keep after the
    general argument, the words given or made from the key by one
    attention_keep_words call (the structured limits only, no launch on
    meta). Words of the wrong shape, dtype or device raise; K3 given
    neither key nor words raises."""
    got = {}
    made = []
    real = tdrop.attention_keep_words

    def spy(*a, **kw):
        made.append((a, kw))
        return real(*a, **kw)

    _on_meta(monkeypatch, _Lib(got))
    monkeypatch.setattr(tdrop, "attention_keep_words", spy)
    b, sq, sk, h, nkv, d = 2, 65, 333, 8, 2, 64
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt,
                                                     device="meta")
    q, do, k, v = meta(b, sq, h, d), meta(b, sq, h, d), meta(b, sk, nkv, d), \
        meta(b, sk, nkv, d)
    rows = meta(b, h, sq, dt=torch.float32)
    ww = tdrop.keep_words_width(sk)
    words = meta(b, h, sq, ww, dt=torch.int32)
    key = trng.fold_in(trng.PRNGKey(7), 3)
    inv = float(np.float32(1) / np.float32(0.9))
    for fn, args in ((tfa.flash_attention_fwd, (q, k, v)),
                     (tfa.flash_attention_bwd_dq, (q, k, v, do, rows, rows)),
                     (tfa.flash_attention_bwd_dkv, (q, k, v, do, rows,
                                                    rows))):
        made.clear()
        with pytest.raises(_Captured):
            fn(*args, is_causal=True, dropout_p=0.1, keep_words=words)
        assert got[fn.__name__][-4] is words and made == []
        assert got[fn.__name__][-3:-1] == (ww, inv)
        with pytest.raises(_Captured):
            fn(*args, is_causal=True, dropout_p=0.1, key=key, window=40)
        (a, kw), = made
        assert a[:6] == (key, 0.1, b, h, sq, sk) and kw["everything"] is False
        assert kw["device"] == q.device and a[9] == 40
        assert got[fn.__name__][-4].shape == (b, h, sq, ww)
        for bad in (meta(b, h, sq, ww - 4, dt=torch.int32),
                    meta(b, h, sq, ww, dt=torch.int64),
                    torch.zeros(b, h, sq, ww, dtype=torch.int32)):
            with pytest.raises(ValueError, match="keep_words"):
                fn(*args, is_causal=True, dropout_p=0.1, keep_words=bad)
    with pytest.raises(ValueError, match="key"):   # neither key nor words
        tfa.flash_attention_bwd_dq(q, k, v, do, rows, rows, is_causal=True,
                                   dropout_p=0.1)
