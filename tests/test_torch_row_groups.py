"""Row groups: a decode step wider than one kernel launch.

On the card K2, K5 and K7 take at most ``GROUP_ROWS`` (64) rows a launch
and K6 at most ``MOE_MAX_ROWS`` rows and ``MOE_MAX_PAIRS`` (row, choice)
pairs; their wrappers run a wider step as consecutive launches over
``row_groups`` of rows through ``in_row_groups``. The reference takes any
batch, so grouping must not change what a row computes. Here, on the CPU,
the helper runs the plain versions per group, in fp32, and the grouped step
equals the ungrouped one bit for bit, cache or pool included:

* K2 at b = 65 (groups 33 + 32), K5 at b = 65 over a shuffled pool with an
  idle row, K7 at b = 16 slots x K1 = 5 (80 tail rows: whole slots, 8 + 8),
  K6 at b = 16 with top-2 of 8 experts (8 + 8 rows; the fused MoE step
  holds only with no drops, a capacity wide enough for every row) and a
  routing dict;
* ``row_groups`` covers the rows in order with groups of at most the cap,
  as even as possible.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_decode as fd
from paddle_tpu_torch.ops.rope import rope_cos_sin

L, H, NH, NKV, HD, FFN = 2, 64, 4, 2, 16, 96
BT, MB = 8, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(r, *shape, sc=0.1):
    return torch.from_numpy((r.randn(*shape) * sc).astype(np.float32))


def _llama(r):
    dq, dkv = NH * HD, NKV * HD
    return {"ln1": 1 + _f(r, L, H), "wqkv": _f(r, L, H, dq + 2 * dkv),
            "wo": _f(r, L, dq, H), "ln2": 1 + _f(r, L, H),
            "wg": _f(r, L, H, FFN), "wu": _f(r, L, H, FFN),
            "wd": _f(r, L, FFN, H)}


def _paged(r, b, tail):
    """A pool with b rows' shuffled private blocks (the last row idle),
    positions that leave room for `tail` tokens, their rope rows."""
    nb = 1 + b * MB
    pool = _f(r, L, nb, BT, 2 * NKV * HD, sc=1.0)
    perm = r.permutation(nb - 1) + 1
    tables = torch.from_numpy(perm[:b * MB].reshape(b, MB).astype(np.int32))
    tables[-1] = 0
    pos = torch.from_numpy(r.randint(0, MB * BT - tail, b).astype(np.int32))
    cos, sin = rope_cos_sin(MB * BT, HD)
    idx = (pos.long()[:, None] + torch.arange(max(tail, 1))[None])
    return pool, tables, pos, cos[idx], sin[idx]


def _k2(r):
    b, S, pos = 65, 24, 17
    p = _llama(r)
    x = _f(r, b, H, sc=1.0)
    kv = _f(r, L, b, S, 2 * NKV * HD, sc=1.0)
    cos, sin = rope_cos_sin(S, HD)
    kw = dict(num_heads=NH, num_kv_heads=NKV)
    whole = lambda: fd.fused_decode_reference(
        x, p, kv.clone(), pos, cos[pos:pos + 1], sin[pos:pos + 1], **kw)

    def grouped():
        cache = kv.clone()
        out = fd.in_row_groups(lambda rows: fd.fused_decode_reference(
            x[rows], p, cache[:, rows], pos, cos[pos:pos + 1],
            sin[pos:pos + 1], **kw)[0], b, fd.GROUP_ROWS)
        return out, cache
    return whole, grouped, fd.row_groups(b, fd.GROUP_ROWS)


def _k5(r):
    b = 65
    p = _llama(r)
    x = _f(r, b, H, sc=1.0)
    pool, tab, pos, cos, sin = _paged(r, b, 0)
    cos, sin = cos[:, 0], sin[:, 0]
    kw = dict(num_heads=NH, num_kv_heads=NKV)
    whole = lambda: fd.fused_paged_decode_reference(
        x, p, pool.clone(), tab, pos, cos, sin, **kw)

    def grouped():
        pl = pool.clone()
        out = fd.in_row_groups(lambda rows: fd.fused_paged_decode_reference(
            x[rows], p, pl, tab[rows], pos[rows], cos[rows], sin[rows],
            **kw)[0], b, fd.GROUP_ROWS)
        return out, pl
    return whole, grouped, fd.row_groups(b, fd.GROUP_ROWS)


def _k7(r):
    b, K1 = 16, 5
    p = _llama(r)
    x = _f(r, b, K1, H, sc=1.0)
    pool, tab, pos, cos, sin = _paged(r, b, K1)
    kw = dict(num_heads=NH, num_kv_heads=NKV)
    whole = lambda: fd.fused_paged_verify_reference(
        x, p, pool.clone(), tab, pos, cos, sin, **kw)

    def grouped():
        pl = pool.clone()
        out = fd.in_row_groups(lambda s: fd.fused_paged_verify_reference(
            x[s], p, pl, tab[s], pos[s], cos[s], sin[s], **kw)[0], b,
            fd.GROUP_ROWS // K1)
        return out, pl
    return whole, grouped, fd.row_groups(b, fd.GROUP_ROWS // K1)


def _k6(r):
    b, S, pos, E, k, f, fs = 16, 24, 13, 8, 2, 32, 48
    dq, dkv = NH * HD, NKV * HD
    p = {"ln1": 1 + _f(r, L, H), "wqkv": _f(r, L, H, dq + 2 * dkv),
         "wo": _f(r, L, dq, H), "ln2": 1 + _f(r, L, H),
         "gate": _f(r, L, E, H, sc=1.0), "weg": _f(r, L, E, H, f),
         "weu": _f(r, L, E, H, f), "wed": _f(r, L, E, f, H),
         "wsg": _f(r, L, H, fs), "wsu": _f(r, L, H, fs),
         "wsd": _f(r, L, fs, H)}
    x = _f(r, b, H, sc=1.0)
    kv = _f(r, L, b, S, 2 * dkv, sc=1.0)
    cos, sin = rope_cos_sin(S, HD)
    kw = dict(num_heads=NH, num_kv_heads=NKV, arch="moe", top_k=k)
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]

    def whole():
        routing = {}
        out = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s,
                                        routing=routing, **kw)
        return out + (routing["ids"],)

    def grouped():
        cache, ids = kv.clone(), []

        def step(rows):
            routing = {}
            out = fd.fused_decode_reference(x[rows], p, cache[:, rows], pos,
                                            c, s, routing=routing, **kw)[0]
            ids.append(routing["ids"])
            return out
        out = fd.in_row_groups(step, b, cap)
        return out, cache, torch.cat(ids, 1)
    cap = min(fd.MOE_MAX_ROWS, fd.MOE_MAX_PAIRS // k)
    return whole, grouped, fd.row_groups(b, cap)


@pytest.mark.parametrize("case", ["k2_b65", "k5_b65", "k7_b16x5", "k6_b16"])
def test_row_groups_leave_the_plain_step_bitwise(case):
    make = {"k2_b65": _k2, "k5_b65": _k5, "k7_b16x5": _k7, "k6_b16": _k6}
    whole, grouped, groups = make[case](np.random.RandomState(len(case)))
    assert len(groups) == 2          # the step is wider than one launch
    want, got = whole(), grouped()
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert torch.equal(w, g)


@pytest.mark.parametrize("n,cap,want", [
    (65, 64, [(0, 33), (33, 65)]), (64, 64, [(0, 64)]), (1, 64, [(0, 1)]),
    (16, 12, [(0, 8), (8, 16)]), (130, 64, [(0, 44), (44, 87), (87, 130)]),
    (16, 8, [(0, 8), (8, 16)])])
def test_row_groups_cover_the_rows_in_even_groups(n, cap, want):
    got = fd.row_groups(n, cap)
    assert got == want
    sizes = [b - a for a, b in got]
    assert max(sizes) <= cap and max(sizes) - min(sizes) <= 1
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(x[1] == y[0] for x, y in zip(got, got[1:]))
