"""The tile walks of K1, K3 and K4's general mode, against brute force and
the JAX package.

``mask_bounds`` gives K1 (each 128-row block's 128-key tiles), K3 (each
128-row block's 64-key tiles) and K4 (each 128-key block's 64-row query
tiles, the union over a kv head's query heads) compact lists of their
non-EMPTY tiles, each FULL (every entry True at the keys the structured
masks leave, or every fp32 entry one value c: no mask load) or MIXED (a
bool tile's entries read from its packed words, an fp32 tile's in place);
the bool mask packed 32 keys a uint32; and the dead rows, flagged and
packed 64 rows a word. With a bool mask and no dropout a dead row leaves
K1's and K4's walks: K1 writes it as the mean of v with the pair (NEG_INF,
log sk), K4 gives its dO / sk to every key's dv (dsum, the row sums of
``dead_row_sums``); otherwise its block walks every tile of theirs as
MIXED. A bool mask's dead row is off K3's walk with
or without dropout (its dq is 0: K3 gives it P = 0); a float mask's dead
row keeps its block on every tile of K3's walk too, as MIXED.

Held here on the CPU: the lists, classes, c values, packed words and dead
flags against a brute-force scan; a walk of only the lists' tiles with
their classes' arithmetic (and the dead rows' closed forms) against the
plain twins in fp32; K3's walked dq and the closed forms themselves
against the reference's ``_xla_attention`` and ``jax.vjp`` at atol 1e-5;
K3's argument on the kernels' device (meta tensors); the row sums' plain
version against numpy; and the one-entry cache of a call's bounds.
"""

import math

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
B = 2
NEG = -1e30


def _padding(r, b, sk, lo):
    """(b, 1, 1, sk) bool key padding, lengths from `lo` to sk."""
    lens = r.randint(lo, sk + 1, size=b)
    return (np.arange(sk)[None, :] < lens[:, None])[:, None, None, :]


def _left_pad(b, sk, pad):
    """(b, 1, 1, sk) bool: batch row 0 whole, the others left-padded."""
    m = np.ones((b, 1, 1, sk), bool)
    m[1:, ..., :pad] = False
    return m


def _mask(form, b, h, sq, sk, seed):
    r = np.random.RandomState(seed)
    if form == "key_padding":                      # mq = 1, mh = 1
        return _padding(r, b, sk, sk // 3)
    if form == "left_pad":                         # dead causal rows
        return _left_pad(b, sk, sk // 3)
    if form == "neg1e4":                           # PaddleNLP's additive
        return np.where(_padding(r, b, sk, sk // 2), 0.0,
                        -1e4).astype(np.float32)
    if form == "bool_4d":                          # mh = h, mq = sq
        m = r.rand(b, h, sq, sk) > 0.3
        m[0, 1, 30:40] = False                     # dead rows
        m[1, :, :, 150:290] = False                # EMPTY and FULL tiles
        m[1, :, 200:, :] = True
        return m
    if form == "rows_dead":                        # (b, 1, sq, sk): all
        m = np.ones((b, 1, sq, sk), bool)          # True but dead rows in
        m[0, :, [5, 77, 200]] = False              # FULL tiles beside live
        m[1, :, 130:140] = False                   # ones
        return m
    if form == "bool_3d_sparse":                   # (h, sq, sk), blocks
        blk = r.rand(h, -(-sq // 64), -(-sk // 64)) > 0.5
        m = np.kron(blk, np.ones((64, 64), bool))[:, :sq, :sk]
        m[..., 0] = True
        return m
    if form == "fp32_4d":                          # soft entries, -inf
        m = np.where(r.rand(b, 1, sq, sk) < 0.2, -1e4, 0.0)
        m[:, :, :, 128:256] = -np.inf              # a tile of -inf
        m[:, :, 200:] = 0.0                        # uniform: FULL, c 0
        m[0, :, 17] = -1e30                        # a float dead row
        return m.astype(np.float32)
    raise ValueError(form)


# (form, sq, sk, h, nkv, causal, kv_lens, causal_offset, window, dropout)
CASES = {
    "key_padding_ragged": ("key_padding", 300, 333, 4, 2, False, None, None,
                           None, False),
    "key_padding_causal_gqa": ("key_padding", 260, 260, 4, 1, True,
                               [260, 150], None, None, False),
    "left_pad_window_gqa": ("left_pad", 400, 400, 4, 2, True, None, None,
                            90, False),
    "left_pad_window_dropout": ("left_pad", 400, 400, 4, 2, True, None, None,
                                90, True),
    "neg1e4_padding": ("neg1e4", 270, 270, 4, 4, False, None, None, None,
                       False),
    "bool_4d_gqa": ("bool_4d", 300, 300, 4, 2, False, None, None, None,
                    False),
    "bool_4d_gqa_dropout": ("bool_4d", 300, 300, 4, 2, False, None, None,
                            None, True),
    "rows_dead_full_tiles": ("rows_dead", 260, 200, 4, 2, False, None, None,
                             None, False),
    "rows_dead_full_tiles_dropout": ("rows_dead", 260, 200, 4, 2, False, None,
                                     None, None, True),
    "bool_3d_sparse_causal_offset": ("bool_3d_sparse", 200, 330, 2, 2, True,
                                     None, 100, None, False),
    "fp32_4d_window": ("fp32_4d", 300, 300, 2, 1, True, [300, 200], None,
                       150, False),
}


def _case(name):
    form, sq, sk, h, nkv, causal, kv_lens, coff, window, drop = CASES[name]
    mask = _mask(form, B, h, sq, sk, sq + sk)
    return mask, sq, sk, h, nkv, causal, kv_lens, coff, window, drop


def _structure(sq, sk, causal, kv_lens, off, window):
    """(b, sq) [lo, hi): the keys kv_lens, causal and the window leave each
    row, by loops."""
    lo = np.zeros((B, sq), int)
    hi = np.full((B, sq), sk)
    for bi in range(B):
        kl = sk if kv_lens is None else min(max(kv_lens[bi], 0), sk)
        for r in range(sq):
            h_ = kl
            if causal:
                h_ = min(h_, max(r + off + 1, 0))
            lo[bi, r] = 0 if window is None else min(max(r + off - window + 1,
                                                         0), sk)
            hi[bi, r] = h_
    return lo, hi


def _brute(mask, b, h, nkv, sq, sk, causal, kv_lens, off, window, dropout):
    """Classes (and c) of K1's, K4's and K3's grids, the dead rows and
    whether they leave K1's and K4's walks, by loops over the expanded
    mask. K3 walks no bool mask's dead row, with or without dropout."""
    m = np.broadcast_to(mask, (b, h, sq, sk))
    f32 = m.dtype != bool
    ok = m if not f32 else m != -np.inf
    live = m if not f32 else m > -5e29
    lo, hi = _structure(sq, sk, causal, kv_lens, off, window)
    keys = np.arange(sk)
    reach = (keys[None, None] >= lo[..., None]) & (keys[None, None]
                                                   < hi[..., None])
    dead = reach.any(-1)[:, None] & ~(reach[:, None] & live).any(-1)
    count = reach.any(-1)[:, None] & ~dead                    # (b, h, sq)
    dead_off = not f32 and not dropout

    def cls_of(bi, heads, rows, kt, kw=128, walk_dead=not dead_off):
        """The class and c of rows × the kw keys of tile kt over heads."""
        ks = slice(kt * kw, min(sk, kt * kw + kw))
        ne, full = False, True
        for hi_ in heads:
            for r in rows:
                vis = reach[bi, r, ks]
                if count[bi, hi_, r]:
                    ne |= bool((ok[bi, hi_, r, ks] & vis).any())
                    if not f32:
                        full &= bool(m[bi, hi_, r, ks][vis].all())
        c = 0.0
        if f32:
            vals = np.concatenate([m[bi, hi_, r, ks] for hi_ in heads
                                   for r in rows])
            full = bool((vals == vals[0]).all())
            c = float(vals[0]) if full else 0.0
        if walk_dead and any(dead[bi, hi_, r] for hi_ in heads
                             for r in rows):
            return 2, 0.0
        if not ne:
            return 0, 0.0
        return (1, c) if full else (2, 0.0)

    nk, nqb, nqt, rep = -(-sk // 128), -(-sq // 128), -(-sq // 64), h // nkv
    k1 = np.zeros((b, h, nqb, nk), int)
    c1 = np.zeros((b, h, nqb, nk), np.float32)
    for bi, hi_, qb, kt in np.ndindex(b, h, nqb, nk):
        rows = range(qb * 128, min(sq, qb * 128 + 128))
        k1[bi, hi_, qb, kt], c1[bi, hi_, qb, kt] = cls_of(bi, [hi_], rows, kt)
    k4 = np.zeros((b, nkv, nk, nqt), int)
    c4 = np.zeros((b, nkv, nk, nqt), np.float32)
    for bi, kh, kb, qt in np.ndindex(b, nkv, nk, nqt):
        rows = range(qt * 64, min(sq, qt * 64 + 64))
        heads = range(kh * rep, (kh + 1) * rep)
        k4[bi, kh, kb, qt], c4[bi, kh, kb, qt] = cls_of(bi, heads, rows, kb)
    nk3 = -(-sk // 64)
    k3 = np.zeros((b, h, nqb, nk3), int)
    c3 = np.zeros((b, h, nqb, nk3), np.float32)
    for bi, hi_, qb, kt in np.ndindex(b, h, nqb, nk3):
        rows = range(qb * 128, min(sq, qb * 128 + 128))
        k3[bi, hi_, qb, kt], c3[bi, hi_, qb, kt] = cls_of(
            bi, [hi_], rows, kt, 64, f32)
    return k1, c1, k4, c4, k3, c3, dead, dead_off


def _bounds(mask, b, h, nkv, sq, sk, causal, kv_lens, coff, window, drop):
    m4 = tfa.dense_mask(torch.from_numpy(np.ascontiguousarray(mask)), b, h,
                        sq, sk)
    return m4, tfa.mask_bounds(m4, b, h, nkv, sq, sk, causal, kv_lens, coff,
                               window, dropout=drop)


def _expand(t, *shape):
    return t.expand(*shape).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_tile_walks_match_a_brute_force_scan(name):
    """Every block's classes, c values and compact list in K1's, K4's and
    K3's grids, the packed words and the dead flags and bits equal a
    brute-force scan."""
    mask, sq, sk, h, nkv, causal, kv_lens, coff, window, drop = _case(name)
    off = sk - sq if coff is None else coff
    m4, got = _bounds(mask, B, h, nkv, sq, sk, causal, kv_lens, coff, window,
                      drop)
    k1, c1, k4, c4, k3, c3, dead, dead_off = _brute(
        mask, B, h, nkv, sq, sk, causal, kv_lens, off, window, drop)
    assert got["dead_off"] == dead_off
    np.testing.assert_array_equal(_expand(got["dead"], B, h, sq), dead)
    assert bool(got["dead_any"]) == bool(dead.any())
    nq, nk = k1.shape[2], k1.shape[3]
    np.testing.assert_array_equal(_expand(got["fwd_cls"], B, h, nq, nk), k1)
    np.testing.assert_array_equal(
        _expand(got["dkv_cls"], B, nkv, *k4.shape[2:]), k4)
    np.testing.assert_array_equal(
        _expand(got["dq_cls"], B, h, *k3.shape[2:]), k3)
    # K3's walk: a bool mask's dead rows never on it (their blocks walk
    # nothing when all rows are dead), a float mask's keep their blocks
    # MIXED on every tile
    dead_blocks = np.zeros(k3.shape[:3], bool)
    for bi, hi_, r in zip(*np.nonzero(dead)):
        dead_blocks[bi, hi_, r // 128] = True
    if mask.dtype == bool:
        live_rows = np.zeros(k3.shape[:3], bool)
        for bi, hi_, r in np.ndindex(B, h, sq):
            live_rows[bi, hi_, r // 128] |= not dead[bi, hi_, r]
        assert not k3[dead_blocks & ~live_rows].any()
        if not dead_off:     # dropout: the same blocks on all of K1's walk
            assert (k1[dead_blocks] == tfa.TILE_MIXED).all()
    else:
        assert (k3[dead_blocks] == tfa.TILE_MIXED).all()
    # the c of each FULL entry of the lists, and the lists themselves
    for part, cls, cv, heads in (("fwd", k1, c1, h), ("dkv", k4, c4, nkv),
                                 ("dq", k3, c3, h)):
        lst = _expand(got[part + "_list"], B, heads, *cls.shape[2:3],
                      cls.shape[3] + 1)
        lc = _expand(got[part + "_c"], B, heads, *cls.shape[2:3],
                     cls.shape[3] + 1)
        for idx in np.ndindex(*cls.shape[:3]):
            tiles = np.nonzero(cls[idx])[0]
            n = lst[idx][0]
            assert n == len(tiles), (part, idx)
            ent = lst[idx][1:1 + n]
            np.testing.assert_array_equal(ent & 0xFFFFFF, tiles)
            np.testing.assert_array_equal(ent >> 24, cls[idx][tiles])
            np.testing.assert_array_equal(lc[idx][1:1 + n], cv[idx][tiles])
    # dead bits: 64 rows a word, bit r % 64 of word r // 64
    bits = got["dead_bits"].numpy().view(np.uint64)
    want = np.zeros(bits.shape, np.uint64)
    d = got["dead"].numpy()
    for idx in zip(*np.nonzero(d)):
        want[idx[0], idx[1], idx[2] // 64] |= np.uint64(1) << np.uint64(
            idx[2] % 64)
    np.testing.assert_array_equal(bits, want)
    # the packed words: bit k % 32 of word k // 32, rows 16-byte aligned
    if mask.dtype != bool:
        assert got["words"] is None
        return
    words = got["words"].numpy().view(np.uint32)
    assert words.shape[-1] % 4 == 0 and words.shape[:3] == m4.shape[:3]
    keys = np.arange(words.shape[-1] * 32)
    unpacked = (words[..., keys // 32] >> (keys % 32).astype(np.uint32)) & 1
    full = np.broadcast_to(m4.numpy(), tuple(m4.shape[:3]) + (sk,))
    np.testing.assert_array_equal(unpacked[..., :sk], full)
    assert not unpacked[..., sk:].any()


def _walk_grid(bounds, part, b, h, nkv, sq, sk):
    """(b, h, sq, sk) of what a kernel's walk makes of each element: 0 off
    the walk (a tile never loaded), 1 in a FULL tile, 2 in a MIXED one; and
    the FULL tiles' c."""
    lst = bounds[part + "_list"]
    cv = bounds[part + "_c"]
    heads = nkv if part == "dkv" else h
    lst = lst.expand(b, heads, *lst.shape[2:])
    cv = cv.expand(b, heads, *cv.shape[2:])
    cls = torch.zeros((b, h, sq, sk), dtype=torch.int64)
    c = torch.zeros((b, h, sq, sk))
    rep = h // nkv
    for idx in np.ndindex(*lst.shape[:3]):
        n = int(lst[idx][0])
        for e, v in zip(lst[idx][1:1 + n].tolist(), cv[idx][1:1 + n].tolist()):
            t, k = e & 0xFFFFFF, e >> 24
            if part != "dkv":
                kw = 128 if part == "fwd" else 64
                at = (idx[0], idx[1], slice(idx[2] * 128, idx[2] * 128 + 128),
                      slice(t * kw, t * kw + kw))
            else:
                at = (idx[0], slice(idx[1] * rep, (idx[1] + 1) * rep),
                      slice(t * 64, t * 64 + 64),
                      slice(idx[2] * 128, idx[2] * 128 + 128))
            cls[at] = k
            c[at] = v
    return cls, c


def _tile_scores(s, m4, st, cls, c):
    """The scores a walk computes: a FULL tile's entries True (bool) or c
    (fp32) with no mask read, a MIXED tile's the mask's own, -inf off the
    walk."""
    b, h, sq, sk = cls.shape
    m = m4.expand(b, h, sq, sk)
    full = cls == tfa.TILE_FULL
    m = torch.where(full, True, m) if m.dtype == torch.bool else \
        torch.where(full, c, m)
    t, g = tfa._masked_scores(s, m, st)
    return torch.where(cls > 0, t, -math.inf), g & (cls > 0)


def _walked_dq(bounds, m4, s, st, stats, do, kf, vf, delta):
    """dq from K3's walk (FULL tiles True or c, MIXED ones the mask, tiles
    off the list never loaded) on the forward's pairs (m, log l), a bool
    mask's dead rows at P = 0 with or without dropout; kf, vf repeated to
    the query heads, Δ (b, h, sq, 1)."""
    b, sq, h, d = do.shape
    t3, g3 = _tile_scores(s, m4, st, *_walk_grid(bounds, "dq", b, h, h, sq,
                                                 kf.shape[1]))
    mm, logl = stats[..., :1], stats[..., 1:]
    p = torch.exp(t3 - mm - torch.where(logl == -math.inf, math.inf, logl))
    if m4.dtype == torch.bool:
        p = torch.where(bounds["dead"].expand(b, h, sq)[..., None], 0.0, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = torch.where(g3, p * (dp - delta), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf) / math.sqrt(d)


@pytest.mark.parametrize("name", list(CASES))
def test_walking_the_lists_gives_the_plain_result(name):
    """A forward over K1's lists, dk, dv over K4's and dq over K3's, each
    tile taken as its class says (FULL: True or c, no mask read; MIXED: the
    mask; off the list: never loaded), the dead rows off the walk by their
    closed forms (the mean of v and the pair (NEG_INF, log sk); dv += dsum
    / sk; K3: P = 0), equal the plain twins in fp32. Under dropout the walks
    are checked without it: the lists are the ones a dropout call takes
    (dead rows on K1's and K4's, off K3's)."""
    mask, sq, sk, h, nkv, causal, kv_lens, coff, window, drop = _case(name)
    d = 16
    r = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(r.randn(*s).astype(np.float32)) for s in (
        (B, sq, h, d), (B, sk, nkv, d), (B, sk, nkv, d), (B, sq, h, d)))
    kw = dict(is_causal=causal, kv_lens=kv_lens, causal_offset=coff,
              window=window, attn_mask=torch.from_numpy(mask))
    out, stats = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    grads = tfa.flash_attention_bwd_plain(q, k, v, out, stats, do, **kw)
    m4, bounds = _bounds(mask, B, h, nkv, sq, sk, causal, kv_lens, coff,
                         window, drop)
    s = tfa._plain_scores(q, k, 1 / math.sqrt(d), sq, sk, coff, None)
    st = tfa._structured_mask(sq, sk, causal, kv_lens, coff, "cpu", window)
    rep = h // nkv
    vf, kf = tfa._repeat_kv(v, rep), tfa._repeat_kv(k, rep)
    dead = bounds["dead"].expand(B, h, sq) & bounds["dead_off"]
    # K1's walk
    tw, _ = _tile_scores(s, m4, st, *_walk_grid(bounds, "fwd", B, h, nkv, sq,
                                                sk))
    mx = tw.amax(-1, keepdim=True)
    p = torch.exp(tw - torch.where(mx == -math.inf, 0.0, mx))
    lsum = p.sum(-1, keepdim=True)
    out_w = torch.einsum("bhqk,bkhd->bqhd", p / lsum.clamp_min(1e-38), vf)
    vmean = tfa.dead_row_sums(v, nkv, 1.0 / sk)                # (b, nkv, d)
    vm = vmean.repeat_interleave(rep, 1)[:, None]               # (b, 1, h, d)
    out_w = torch.where(dead.transpose(1, 2)[..., None], vm, out_w)
    rows = (st.expand(B, 1, sq, sk).any(-1).transpose(1, 2)[..., None]
            if st is not None else torch.ones((), dtype=torch.bool))
    live = rows & ~dead.transpose(1, 2)[..., None]
    np.testing.assert_allclose(torch.where(live | dead.transpose(1, 2)[
        ..., None], out_w, 0.0).numpy(), torch.where(
        live | dead.transpose(1, 2)[..., None], out, 0.0).numpy(), atol=ATOL)
    lse_w = (mx + torch.log(lsum))[..., 0]
    lse_w = torch.where(dead, NEG + math.log(sk), lse_w)
    keep = live[..., 0].transpose(1, 2) | dead
    np.testing.assert_allclose(lse_w[keep].numpy(),
                               (stats[..., 0] + stats[..., 1])[keep].numpy(),
                               rtol=1e-6, atol=ATOL)
    # K4's walk, from the twin's pairs; dead rows off it give P = dS = 0
    t4, g4 = _tile_scores(s, m4, st, *_walk_grid(bounds, "dkv", B, h, nkv,
                                                 sq, sk))
    mm, logl = stats[..., :1], stats[..., 1:]
    pb = torch.exp(t4 - mm - torch.where(logl == -math.inf, math.inf, logl))
    pb = torch.where(dead[..., None], 0.0, pb)
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = torch.where(g4, pb * (dp - delta), 0.0)
    sum_kv = lambda x: x.reshape(B, sk, nkv, rep, d).sum(3)
    dk = sum_kv(torch.einsum("bhqk,bqhd->bkhd", ds, q)) / math.sqrt(d)
    dv = sum_kv(torch.einsum("bhqk,bqhd->bkhd", pb, do))
    if bounds["dead_off"]:
        dsum = tfa.dead_row_sums(do, nkv, 1.0, bounds["dead"])
        dv = dv + dsum[:, None] / sk
    np.testing.assert_allclose(dk.numpy(), grads[1].numpy(), atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), grads[2].numpy(), atol=ATOL)
    if bounds["dead_off"]:       # a dead row's dq is 0: K3 gives it so
        assert (grads[0].transpose(1, 2)[dead] == 0).all()
    # K3's walk, from the twin's pairs
    dq = _walked_dq(bounds, m4, s, st, stats, do, kf, vf, delta)
    np.testing.assert_allclose(dq.numpy(), grads[0].numpy(), atol=ATOL)


@pytest.mark.parametrize("name", ["key_padding_causal_gqa",
                                  "left_pad_window_gqa", "bool_4d_gqa"])
def test_walked_dq_matches_the_reference_gradient(name):
    """dq from K3's walk (its tiles by class, a bool mask's dead rows at
    P = 0), on the plain forward's pairs, against jax.vjp of the JAX
    package's ``_xla_attention`` on the same numpy inputs, fp32, atol 1e-5
    (ATOL: fp32 sums of a few hundred terms, as the closed-form test
    below)."""
    mask, sq, sk, h, nkv, causal, kv_lens, coff, window, drop = _case(name)
    assert coff is None and not drop
    d = 16
    r = np.random.RandomState(7)
    q, k, v, do = (r.randn(*shape).astype(np.float32) for shape in (
        (B, sq, h, d), (B, sk, nkv, d), (B, sk, nkv, d), (B, sq, h, d)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(is_causal=causal, kv_lens=kv_lens, window=window,
              attn_mask=torch.from_numpy(mask))
    out, stats = tfa.flash_attention_fwd_plain(tq, tk, tv, **kw)
    m4, bounds = _bounds(mask, B, h, nkv, sq, sk, causal, kv_lens, None,
                         window, False)
    s = tfa._plain_scores(tq, tk, 1 / math.sqrt(d), sq, sk, None, None)
    st = tfa._structured_mask(sq, sk, causal, kv_lens, None, "cpu", window)
    rep = h // nkv
    delta = (tdo * out).sum(-1).transpose(1, 2)[..., None]
    dq = _walked_dq(bounds, m4, s, st, stats, tdo, tfa._repeat_kv(tk, rep),
                    tfa._repeat_kv(tv, rep), delta)
    f = lambda q_: jfa._xla_attention(
        q_, jnp.asarray(k), jnp.asarray(v), attn_mask=jnp.asarray(mask),
        is_causal=causal, window=window,
        kv_lens=None if kv_lens is None else jnp.asarray(kv_lens))
    _, pull = jax.vjp(f, jnp.asarray(q))
    np.testing.assert_allclose(dq.numpy(), np.asarray(pull(jnp.asarray(
        do))[0]), atol=ATOL)


def test_dead_rows_closed_form_matches_the_reference():
    """The decomposition K1 and K4 implement, on a left-padded causal +
    window bool mask under GQA (batch row 1's first rows dead): the plain
    twins over the live rows (their dO zeroed on the dead ones), plus the
    row sums' plain version for the dead rows (out = the mean of v, the
    pair (NEG_INF, log sk), dq = 0, nothing to dk, dv += dsum / sk), give
    the reference's output, log-sum-exp and jax.vjp's gradients in fp32."""
    b, sq, sk, h, nkv, d, window, pad = 2, 48, 48, 4, 2, 16, 10, 20
    r = np.random.RandomState(12)
    q, k, v, do = (r.randn(*s).astype(np.float32) for s in (
        (b, sq, h, d), (b, sk, nkv, d), (b, sk, nkv, d), (b, sq, h, d)))
    mask = _left_pad(b, sk, pad)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = torch.from_numpy(mask)
    kw = dict(is_causal=True, window=window, attn_mask=tm)
    bounds = tfa.mask_bounds(tfa.dense_mask(tm, b, h, sq, sk), b, h, nkv, sq,
                             sk, True, window=window)
    dead = bounds["dead"].expand(b, h, sq)
    assert bounds["dead_off"] and int(dead.sum()) == pad * h
    dead_q = dead.transpose(1, 2)[..., None]                # (b, sq, h, 1)
    out, stats = tfa.flash_attention_fwd_plain(tq, tk, tv, **kw)
    vm = tfa.dead_row_sums_plain(tv, nkv, 1.0 / sk).repeat_interleave(
        h // nkv, 1)[:, None]
    out = torch.where(dead_q, vm, out)
    stats = torch.where(dead[..., None], torch.tensor([NEG, math.log(sk)]),
                        stats)
    do_live = torch.where(dead_q, 0.0, tdo)
    dq, dk, dv = tfa.flash_attention_bwd_plain(tq, tk, tv, out, stats,
                                               do_live, **kw)
    dsum = tfa.dead_row_sums_plain(tdo, nkv, 1.0, bounds["dead"])
    dv = dv + dsum[:, None] / sk
    f = lambda q_, k_, v_: jfa.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=jnp.asarray(mask), is_causal=True,
        window_size=window)
    ref, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    for got, want in zip((dq, dk, dv), pull(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the pairs' m + log l: the log-sum-exp of the reference's scores
    # (fp32 statistics: an absolute 1e-6 where the sum is near 0)
    kr = np.repeat(k, h // nkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr).astype(np.float64) / 4.0
    qp, kp = np.arange(sq)[:, None], np.arange(sk)[None, :]
    s = np.where((kp <= qp) & (kp > qp - window), s, NEG)
    s = np.where(mask, s, NEG)
    mx = s.max(-1)
    lse = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
    np.testing.assert_allclose((stats[..., 0].double() + stats[..., 1]
                                .double()).numpy(), lse, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 1)])
def test_dead_row_sums_plain_matches_numpy(heads):
    """The row sums' plain version (CPU tensors) against numpy: the mean of
    v over every row of each kv head, and the sum of dO over the rows a
    (b|1, h|1, sq) flag selects, over each kv head's query heads."""
    h, nkv = heads
    r = np.random.RandomState(h + nkv)
    v = r.randn(2, 37, nkv, 16).astype(np.float32)
    do = r.randn(2, 45, h, 16).astype(np.float32)
    got = tfa.dead_row_sums(torch.from_numpy(v), nkv, 1.0 / 37)
    np.testing.assert_allclose(got.numpy(), v.mean(1), rtol=1e-6, atol=1e-7)
    for shape in ((2, 1, 45), (1, h, 45)):
        sel = r.rand(*shape) < 0.3
        got = tfa.dead_row_sums(torch.from_numpy(do), nkv, 1.0,
                                torch.from_numpy(sel))
        want = np.zeros((2, nkv, 16), np.float32)
        selb = np.broadcast_to(sel, (2, h, 45))
        for bi, hq, row in zip(*np.nonzero(selb)):
            want[bi, hq // (h // nkv)] += do[bi, row, hq]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_call_bounds_are_cached_per_mask():
    """The layers of a step share one mask: ``_call_bounds`` computes the
    bounds once for the same mask, structure and dropout, and anew when
    the mask is written in place, another mask comes, or the dropout
    setting changes."""
    q = torch.zeros(2, 64, 4, 16)
    k = torch.zeros(2, 64, 2, 16)
    m = torch.ones(2, 1, 1, 64, dtype=torch.bool)
    m[1, ..., :10] = False
    first = tfa._call_bounds(q, k, m, True, None, None)
    assert tfa._call_bounds(q, k, m, True, None, None) is first
    assert tfa._call_bounds(q, k, m, True, None, None, dropout_p=0.1) \
        is not first
    again = tfa._call_bounds(q, k, m, True, None, None)
    assert again is not first and again["dead_off"]
    m[0, ..., :3] = False                        # in place: a new version
    fresh = tfa._call_bounds(q, k, m, True, None, None)
    assert fresh is not again
    assert tfa._call_bounds(q, k, m.clone(), True, None, None) is not fresh
    assert tfa._call_bounds(q, k, m, False, None, None) is not fresh


@pytest.mark.parametrize("mask_dtype,dropout", [(torch.bool, 0.0),
                                                (torch.bool, 0.1),
                                                (torch.float32, 0.0)])
def test_k3_argument_carries_its_walk(monkeypatch, mask_dtype, dropout):
    """On the kernels' device (meta tensors stand for CUDA ones) K3's
    general-mode argument carries ``dq_list``, ``dq_c``, the packed words
    and the dead rows' bits (a bool mask, with or without dropout; none
    for an fp32 mask), and no ``red`` and no hull bounds, which the call
    never computes (``mask_bounds`` makes them at their first read)."""
    seen = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                mod = args[1 + next(i for i, a in enumerate(args)
                                    if isinstance(a, float))]
                seen["arg"] = {f: getattr(mod.contents, f)
                               for f, _ in tfa._ModArg._fields_}
                return 0
            return entry

    real = tfa._mod_arg

    def spy(what, *args, **kw):
        arg, keep = real(what, *args, **kw)
        seen["bounds"], seen["part"], seen["keep"] = args[5], args[6], keep
        return arg, keep

    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(tfa, "_mod_arg", spy)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: None)
    w = tfa.flash_attention_bwd_dq
    for count in ("launches",) + tfa.MODE_COUNTERS:
        monkeypatch.setattr(w, count, 0)
    monkeypatch.setattr(w, "by_d", dict.fromkeys(w.by_d, 0))
    b, sq, h, nkv, d = 2, 300, 4, 2, 64
    meta = lambda *s, dtype=torch.bfloat16: torch.zeros(*s, dtype=dtype,
                                                         device="meta")
    q, k = meta(b, sq, h, d), meta(b, sq, nkv, d)
    mask = meta(b, 1, sq, sq, dtype=mask_dtype)
    key = torch.zeros(2, dtype=torch.int64) if dropout else None
    w(q, k, k, q, meta(b, h, sq, 2, dtype=torch.float32),
      meta(b, h, sq, dtype=torch.float32), is_causal=True, attn_mask=mask,
      dropout_p=dropout, key=key)
    bounds, arg, keep = seen["bounds"], seen["arg"], seen["keep"]
    assert seen["part"] == "dq" and w.launches == w.general == 1
    lst, cv = bounds["dq_list"], bounds["dq_c"]
    assert lst.shape == (b, 1, -(-sq // 128), 1 + -(-sq // 64))
    assert cv.shape == lst.shape and cv.dtype == torch.float32
    assert arg["ln"] == lst.shape[-1]
    assert (arg["lsb"], arg["lsh"]) == (lst.stride(0), 0)
    assert arg["red"] is None and arg["bounds"] is None
    # the hull pairs, which no kernel reads, were not computed on the way
    assert not {"fwd", "dq", "dkv"} & set(bounds.keys())
    assert bounds["dq"].shape == (b, h, -(-sq // 128), 2)
    assert any(t is lst for t in keep) and any(t is cv for t in keep)
    words, dead = bounds["words"], bounds["dead_bits"]
    if mask_dtype == torch.bool:
        assert (arg["wb"], arg["wh"], arg["wq"], arg["ww"]) == tuple(
            words.shape) == (b, 1, sq, 12)
        assert (arg["dsb"], arg["dsh"]) == (dead.stride(0), 0)
        assert any(t is words for t in keep) and any(t is dead for t in keep)
    else:
        assert words is None and arg["ww"] == 0
        assert arg["dead"] is None and (arg["dsb"], arg["dsh"]) == (0, 0)
