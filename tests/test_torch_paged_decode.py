"""The paged decode step of paddle_tpu_torch against paddle_tpu's.

* fused_paged_decode_reference (the plain version a CPU tensor runs) against
  the JAX ``fused_paged_decode_reference`` in fp32, MHA and GQA: three (and
  twelve) rows at different positions, and five rows at the card
  attention's chunk edges (511, 512, 513, 1024 over a 1040-position table),
  the last idle (its table all scratch), over a shuffled block table. x_out and the whole pool after the appends agree
  within atol 2e-5 (sums in another order).
* The same against the TPU kernel itself, run as the JAX package runs it on
  the CPU (``_fused_paged_decode_pallas(..., interpret=True)``), bf16,
  nkv·hd = 128: atol 2e-2, rtol 2^-6, as for K2 — one or two bf16 ulp of the
  output plus bf16 intermediates rounded on either side of a boundary, and
  the kernel's in-kernel rope angles.
* The paged plain version over a pool holding a contiguous cache's rows
  equals the contiguous plain version, bit for bit.
* The int8 modes (reference :1824-1846) — llama int8 weights, an int8 pool
  with per-row scales, both, and the gpt int8 pool — against the JAX
  reference in fp32 (MHA and GQA; three rows, and the five chunk-edge
  rows): x_out atol 2e-5, rtol 1e-5, the appended int8 rows within one
  int8 step (round(kv / scale) of values a few fp32 ulp apart can land on
  either side of a .5), the rest of the pool equal; against the TPU
  kernel in interpret mode in bf16 at K2's int8 tolerance (atol 2e-2, rtol
  2^-6); and the paged int8 plain step over a pool holding an int8
  contiguous cache's rows, with every row's scales equal to the cache's,
  equals the contiguous int8 plain step bit for bit.
* Block gather/scatter round-trip; what is still unported raises naming
  ROADMAP, a kv_scales that does not match the pool's dtype raises
  ValueError, and the int8 modes run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.ops.rope import rope_cos_sin as trope_cos_sin


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# rows 0 and 1 active at their own positions through private shuffled
# blocks; row 2 idle (table all scratch) at a position inside block 0
BT, MB, NB = 8, 4, 12
TABLES = np.array([[7, 3, 0, 0], [5, 9, 2, 11], [0, 0, 0, 0]], np.int32)
POSITIONS = np.array([13, 29, 5], np.int32)


def _params(r, L, h, nh, nkv, hd, ffn, sc=0.05):
    dq, dkv = nh * hd, nkv * hd
    f = lambda *s, sc=sc: (r.randn(*s) * sc).astype(np.float32)
    return {"ln1": 1 + f(L, h, sc=0.1), "wqkv": f(L, h, dq + 2 * dkv),
            "wo": f(L, dq, h), "ln2": 1 + f(L, h, sc=0.1),
            "wg": f(L, h, ffn), "wu": f(L, h, ffn), "wd": f(L, ffn, h)}


#: rows at the card attention's chunk edges (512-key chunks: the last key of
#: a full chunk, one and two past it, two full), then an idle row, over a
#: table of EDGE_MB blocks (1040 positions)
EDGE_POSITIONS = np.array([511, 512, 513, 1024, 5], np.int32)
EDGE_MB = 130


def _layout(b):
    """(tables, positions, pool blocks) of b rows: TABLES for 3; for 5, one
    row at each chunk edge of EDGE_POSITIONS through private blocks drawn
    from a shuffle over EDGE_MB blocks a row, and row 4 idle; for 12, rows
    0..10 own private blocks drawn from a shuffle, at positions across
    their span, and row 11 idle as row 2 of TABLES."""
    if b == 3:
        return TABLES, POSITIONS, NB
    if b == 5:
        need = [int(p) // BT + 1 for p in EDGE_POSITIONS[:-1]]
        nb = 1 + sum(need)
        perm = np.random.RandomState(b).permutation(nb - 1) + 1
        tables = np.zeros((b, EDGE_MB), np.int32)
        at = 0
        for r, n in enumerate(need):
            tables[r, :n] = perm[at:at + n]
            at += n
        return tables, EDGE_POSITIONS, nb
    nb = 1 + (b - 1) * MB
    tables = np.zeros((b, MB), np.int32)
    tables[:-1] = (np.random.RandomState(b).permutation(nb - 1)
                   + 1).reshape(b - 1, MB)
    positions = np.array([0, 3, 7, 8, 13, 17, 22, 26, 29, 30, 31, 5],
                         np.int32)
    return tables, positions, nb


def _int8_modes(params, pool, r, b, w8, kv8, nkv, hd):
    """The int8 modes' inputs from fp32 ones: int8 weight stacks with
    per-out-channel scale rows (w8; absmax / 127 over each column, as
    ``quantize_model`` takes it) and an int8 pool with per-ROW lane scales
    (L, b, 2*nkv*hd) (kv8), as numpy."""
    p = dict(params)
    if w8:
        for k in tfd._SCALED_KEYS:
            sc = np.maximum(np.abs(p[k]).max(axis=1, keepdims=True) / 127,
                            1e-8).astype(np.float32)
            p[k] = np.clip(np.round(p[k] / sc), -127, 127).astype(np.int8)
            p[f"{k}_s"] = sc
    scales = None
    if kv8:
        scales = np.repeat((r.rand(pool.shape[0], b, 2 * nkv) * 0.02 + 0.02)
                           .astype(np.float32), hd, axis=-1)
        pool = r.randint(-127, 128, pool.shape).astype(np.int8)
    return p, pool, scales


def _gpt_params(r, L, h, ffn, sc=0.05):
    f = lambda *s, sc=sc: (r.randn(*s) * sc).astype(np.float32)
    return {"ln1": 1 + f(L, h, sc=0.1), "ln1_b": f(L, h, sc=0.1),
            "wqkv": f(L, h, 3 * h), "bqkv": f(L, 3 * h, sc=0.1),
            "wo": f(L, h, h), "bo": f(L, h, sc=0.1),
            "ln2": 1 + f(L, h, sc=0.1), "ln2_b": f(L, h, sc=0.1),
            "wg": f(L, h, ffn), "bg": f(L, ffn, sc=0.1),
            "wd": f(L, ffn, h), "bd": f(L, h, sc=0.1)}


def _to_torch(a):
    """A numpy or JAX array as a torch tensor, bit for bit (bf16 too)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _appends(tables, positions, BT):
    """(block, offset) of each row's append."""
    return [(int(tables[r, p // BT]), int(p % BT))
            for r, p in enumerate(positions)]


def _int8_pool_close(pt, pj, appends):
    """The appended int8 rows within one step; the rest of the pool
    equal."""
    pt, pj = pt.astype(np.int32), pj.astype(np.int32)
    rest = np.ones(pt.shape[1:3], bool)
    for bid, off in appends:
        assert np.abs(pt[:, bid, off] - pj[:, bid, off]).max() <= 1
        rest[bid, off] = False
    assert np.array_equal(pt[:, rest], pj[:, rest])


def _rope_rows(hd, positions, span=MB * BT):
    c, s = trope_cos_sin(span, hd)
    idx = torch.from_numpy(positions.astype(np.int64))
    return c[idx], s[idx]


@pytest.mark.parametrize("nkv", [4, 2])          # MHA, GQA
# 12: past the kernels' old 8; 5: rows at the chunk edges
@pytest.mark.parametrize("b", [3, 12, 5])
def test_paged_reference_matches_jax_reference_fp32(nkv, b):
    L, h, nh, hd, ffn = 2, 64, 4, 16, 96
    tables, positions, nb = _layout(b)
    r = np.random.RandomState(nkv)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    x = r.randn(b, h).astype(np.float32)
    pool = r.randn(L, nb, BT, 2 * nkv * hd).astype(np.float32)
    cos, sin = _rope_rows(hd, positions, tables.shape[1] * BT)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xj, pj = jfd.fused_paged_decode_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), **kw)
    xt, pt = tfd.fused_paged_decode_step(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              params.items()},
        torch.from_numpy(pool.copy()), torch.from_numpy(tables),
        torch.from_numpy(positions), cos, sin, **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-5,
                               rtol=1e-5)
    assert tfd.fused_paged_decode_cuda.launches == 0


def test_paged_reference_matches_interpret_kernel_bf16():
    """The TPU kernel in interpret mode vs the port's plain version."""
    L, h, nh, nkv, hd, ffn = 2, 128, 4, 2, 64, 256
    r = np.random.RandomState(0)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    x = r.randn(3, h).astype(np.float32)
    pool = r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    pool_j = jnp.asarray(pool, jnp.bfloat16)
    xj, poolj = jax.jit(lambda x, p, c: jfd._fused_paged_decode_pallas(
        x, p, c, jnp.asarray(TABLES), jnp.asarray(POSITIONS), num_heads=nh,
        num_kv_heads=nkv, head_dim=hd, eps=1e-5, interpret=True))(
            jnp.asarray(x, jnp.bfloat16), pj, pool_j)
    to_t = lambda a: torch.from_numpy(
        np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    cos, sin = _rope_rows(hd, POSITIONS)
    xt, poolt = tfd.fused_paged_decode_step(
        to_t(jnp.asarray(x, jnp.bfloat16)), {k: to_t(v) for k, v in
                                             pj.items()},
        to_t(pool_j), torch.from_numpy(TABLES), torch.from_numpy(POSITIONS),
        cos, sin, num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    active = [0, 1]                 # the idle row's output is thrown away
    np.testing.assert_allclose(xt.float().numpy()[active],
                               np.asarray(xj, np.float32)[active],
                               atol=2e-2, rtol=2 ** -6)
    pool_ref = np.asarray(poolj, np.float32)
    for row in active:
        bid = TABLES[row, POSITIONS[row] // BT]
        off = POSITIONS[row] % BT
        np.testing.assert_allclose(poolt[:, bid, off].float().numpy(),
                                   pool_ref[:, bid, off], atol=2e-2,
                                   rtol=2 ** -6)
    # every block but the appended rows and scratch is untouched by both
    touched = {0} | {int(TABLES[i, POSITIONS[i] // BT]) for i in active}
    rest = [i for i in range(NB) if i not in touched]
    assert torch.equal(poolt[:, rest], to_t(pool_j)[:, rest])
    np.testing.assert_array_equal(pool_ref[:, rest],
                                  np.asarray(pool_j, np.float32)[:, rest])


def test_paged_equals_contiguous_plain_bitwise():
    """A pool holding a contiguous cache's rows block by block (one
    position for every row) gives the contiguous plain version's bits."""
    L, h, nh, nkv, hd, ffn, b, pos = 2, 64, 4, 2, 16, 96, 2, 19
    S = MB * BT
    r = np.random.RandomState(3)
    params = {k: torch.from_numpy(v).bfloat16() for k, v in
              _params(r, L, h, nh, nkv, hd, ffn).items()}
    x = torch.from_numpy(r.randn(b, h).astype(np.float32)).bfloat16()
    cache = torch.from_numpy(
        r.randn(L, b, S, 2 * nkv * hd).astype(np.float32)).bfloat16()
    tables = np.array([[4, 1, 10, 6], [2, 8, 3, 11]], np.int32)
    pool = torch.zeros(L, NB, BT, 2 * nkv * hd, dtype=torch.bfloat16)
    for i in range(b):
        pool[:, torch.from_numpy(tables[i]).long()] = cache[:, i].reshape(
            L, MB, BT, -1)
    c, s = trope_cos_sin(S, hd)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xc, cache = tfd.fused_decode_step(x, params, cache, pos, c[pos:pos + 1],
                                      s[pos:pos + 1], **kw)
    positions = torch.full((b,), pos, dtype=torch.int32)
    xp, pool = tfd.fused_paged_decode_step(
        x, params, pool, torch.from_numpy(tables), positions,
        c[positions.long()], s[positions.long()], **kw)
    assert torch.equal(xp, xc)
    for i in range(b):
        assert torch.equal(pool[:, torch.from_numpy(tables[i]).long()]
                           .reshape(L, S, -1), cache[:, i])


def test_block_gather_scatter_roundtrip():
    pool = torch.arange(2 * 6 * 8 * 4, dtype=torch.float32).reshape(2, 6, 8, 4)
    bids = torch.tensor([4, 1])
    got = tfd.paged_block_gather(pool, bids)
    assert tuple(got.shape) == (2, 2, 8, 4)
    assert torch.equal(got[:, 0], pool[:, 4])
    out = tfd.paged_block_scatter(pool.clone(), torch.tensor([2, 5]), got)
    assert torch.equal(out[:, 2], pool[:, 4]) and torch.equal(out[:, 5],
                                                              pool[:, 1])
    assert torch.equal(out[:, [0, 1, 3, 4]], pool[:, [0, 1, 3, 4]])
    assert tfd.paged_pool_shape(32, 129, 128, 32, 128) == (32, 129, 128,
                                                           8192)


def test_paged_dispatch_refuses_unported_modes():
    """Still refused: mp_axis (ROADMAP Queue A item 8), any arch but llama
    and gpt, and int8 weights on gpt (the reference has no such mode); a
    kv_scales that does not match the pool's dtype and a plan of another
    cache width raise ValueError. The int8 modes run."""
    x = torch.zeros(1, 8)
    pool = torch.zeros(1, 2, 8, 8)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    args = (x, {}, pool, tab, pos, None, None)
    kw = dict(num_heads=1, num_kv_heads=1)
    for extra in (dict(mp_axis="mp"), dict(arch="gpt", mp_axis="mp")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfd.fused_paged_decode_step(*args, **kw, **extra)
    # MoE rides no paged step, as in the reference
    with pytest.raises(NotImplementedError, match="llama/gpt"):
        tfd.fused_paged_decode_step(*args, **kw, arch="moe")
    with pytest.raises(NotImplementedError, match="no such mode"):
        tfd.fused_paged_decode_step(x, {"wqkv_s": None}, pool, tab, pos,
                                    None, None, arch="gpt", **kw)
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_paged_decode_step(*args, **kw, kv_scales=torch.ones(1))
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_paged_decode_step(x, {}, pool.to(torch.int8), tab, pos,
                                    None, None, **kw)
    with pytest.raises(ValueError, match="cache"):
        tfd.fused_paged_decode_step(*args, **kw, blocks={"cache_wbytes": 1})
    # every int8 mode runs on CPU tensors and launches nothing
    L, h, nh, nkv, hd, ffn = 1, 32, 2, 2, 16, 64
    r = np.random.RandomState(2)
    for w8, kv8 in ((True, False), (False, True), (True, True)):
        p, pl, sc = _int8_modes(_params(r, L, h, nh, nkv, hd, ffn),
                                r.randn(L, NB, BT, 2 * nkv * hd)
                                .astype(np.float32), r, 3, w8, kv8, nkv, hd)
        cos, sin = _rope_rows(hd, POSITIONS)
        xo, _ = tfd.fused_paged_decode_step(
            torch.from_numpy(r.randn(3, h).astype(np.float32)),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(pl), torch.from_numpy(TABLES),
            torch.from_numpy(POSITIONS), cos, sin,
            kv_scales=None if sc is None else torch.from_numpy(sc),
            num_heads=nh, num_kv_heads=nkv, blocks={"cache_wbytes":
                                                    1 if kv8 else 4})
        assert bool(torch.isfinite(xo).all())
    assert tfd.fused_paged_decode_cuda.launches == 0


def test_paged_gpt_arch_runs_on_cpu_tensors():
    """arch="gpt" (ported) runs the paged plain step on CPU tensors,
    without rope rows, and launches nothing."""
    L, h, nh, ffn = 2, 32, 2, 64
    r = np.random.RandomState(8)
    f = lambda *s: torch.from_numpy((r.randn(*s) * 0.1).astype(np.float32))
    p = {"ln1": 1 + f(L, h), "ln1_b": f(L, h), "wqkv": f(L, h, 3 * h),
         "bqkv": f(L, 3 * h), "wo": f(L, h, h), "bo": f(L, h),
         "ln2": 1 + f(L, h), "ln2_b": f(L, h), "wg": f(L, h, ffn),
         "bg": f(L, ffn), "wd": f(L, ffn, h), "bd": f(L, h)}
    pool = f(L, NB, BT, 2 * h)
    before = pool.clone()
    tfd.fused_paged_decode_cuda.launches = 0
    x, pool = tfd.fused_paged_decode_step(
        f(3, h), p, pool, torch.from_numpy(TABLES),
        torch.from_numpy(POSITIONS), None, None, num_heads=nh,
        num_kv_heads=nh, arch="gpt")
    assert tuple(x.shape) == (3, h) and bool(torch.isfinite(x).all())
    assert not torch.equal(pool[:, 3, 13 % BT], before[:, 3, 13 % BT])
    assert torch.equal(pool[:, 4], before[:, 4])     # an unused block
    assert tfd.fused_paged_decode_cuda.launches == 0


INT8_MODES = [("llama", True, False), ("llama", False, True),
              ("llama", True, True), ("gpt", False, True)]
INT8_IDS = ["llama-int8w", "llama-int8kv", "llama-int8w-int8kv",
            "gpt-int8kv"]


@pytest.mark.parametrize("b", [3, 5])            # 5: the chunk edges
@pytest.mark.parametrize("nkv", [4, 2])          # MHA, GQA (gpt: MHA)
@pytest.mark.parametrize("arch,w8,kv8", INT8_MODES, ids=INT8_IDS)
def test_paged_reference_int8_modes_match_jax_reference_fp32(arch, w8, kv8,
                                                            nkv, b):
    L, hd, ffn = 2, 16, 96
    nh = 4 if arch == "llama" else nkv
    h = 64 if arch == "llama" else nh * hd
    tables, positions, nb = _layout(b)
    r = np.random.RandomState(10 * nkv + b)
    params = (_params(r, L, h, nh, nkv, hd, ffn) if arch == "llama"
              else _gpt_params(r, L, h, ffn))
    pool = r.randn(L, nb, BT, 2 * nkv * hd).astype(np.float32)
    params, pool, sc = _int8_modes(params, pool, r, b, w8, kv8, nkv, hd)
    x = r.randn(b, h).astype(np.float32)
    span = tables.shape[1] * BT
    if arch == "llama":
        cos, sin = _rope_rows(hd, positions, span)
        cj, sj = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    else:
        cos = sin = None
        cj = sj = jnp.ones((b, hd), jnp.float32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    xj, pj = jfd.fused_paged_decode_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(positions),
        cj, sj, kv_scales=None if sc is None else jnp.asarray(sc), **kw)
    xt, pt = tfd.fused_paged_decode_step(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              params.items()},
        torch.from_numpy(pool.copy()), torch.from_numpy(tables),
        torch.from_numpy(positions), cos, sin,
        kv_scales=None if sc is None else torch.from_numpy(sc), **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    if kv8:
        assert pt.dtype == torch.int8
        _int8_pool_close(pt.numpy(), np.asarray(pj),
                         _appends(tables, positions, BT))
    else:
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-5,
                                   rtol=1e-5)
    assert tfd.fused_paged_decode_cuda.launches == 0


@pytest.mark.parametrize("w8,kv8", [(True, False), (False, True),
                                    (True, True)],
                         ids=["int8w", "int8kv", "int8w-int8kv"])
def test_paged_reference_int8_modes_match_interpret_kernel_bf16(w8, kv8):
    """The TPU kernel's int8 modes in interpret mode vs the port's plain
    version; bf16 activations and norms, nkv·hd = 128."""
    L, h, nh, nkv, hd, ffn = 2, 128, 4, 2, 64, 256
    r = np.random.RandomState(4)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    pool = r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)
    params, pool, sc = _int8_modes(params, pool, r, 3, w8, kv8, nkv, hd)
    pj = {k: (jnp.asarray(v) if v.dtype != np.float32 or k.endswith("_s")
              else jnp.asarray(v, jnp.bfloat16)) for k, v in params.items()}
    pool_j = jnp.asarray(pool) if kv8 else jnp.asarray(pool, jnp.bfloat16)
    x_j = jnp.asarray(r.randn(3, h).astype(np.float32), jnp.bfloat16)
    scj = None if sc is None else jnp.asarray(sc)
    xj, poolj = jax.jit(lambda x, p, c: jfd._fused_paged_decode_pallas(
        x, p, c, jnp.asarray(TABLES), jnp.asarray(POSITIONS), num_heads=nh,
        num_kv_heads=nkv, head_dim=hd, eps=1e-5, kv_scales=scj,
        interpret=True))(x_j, pj, pool_j)
    cos, sin = _rope_rows(hd, POSITIONS)
    pool_t = _to_torch(pool_j)
    xt, poolt = tfd.fused_paged_decode_step(
        _to_torch(x_j), {k: _to_torch(v) for k, v in pj.items()},
        pool_t.clone(), torch.from_numpy(TABLES),
        torch.from_numpy(POSITIONS), cos, sin, num_heads=nh,
        num_kv_heads=nkv, eps=1e-5,
        kv_scales=None if sc is None else torch.from_numpy(sc))
    active = [0, 1]                 # the idle row's output is thrown away
    np.testing.assert_allclose(xt.float().numpy()[active],
                               np.asarray(xj, np.float32)[active],
                               atol=2e-2, rtol=2 ** -6)
    apps = _appends(TABLES, POSITIONS, BT)[:2]
    ref = np.asarray(poolj)
    if kv8:
        got, ref = poolt.numpy().copy(), ref.copy()
        got[:, 0] = ref[:, 0] = 0       # scratch: the idle row's garbage
        _int8_pool_close(got, ref, apps)
    else:
        for bid, off in apps:
            np.testing.assert_allclose(poolt[:, bid, off].float().numpy(),
                                       ref[:, bid, off].astype(np.float32),
                                       atol=2e-2, rtol=2 ** -6)
    touched = {0} | {bid for bid, _ in apps}
    rest = [i for i in range(NB) if i not in touched]
    assert torch.equal(poolt[:, rest], pool_t[:, rest])


def test_paged_int8_equals_contiguous_int8_plain_bitwise():
    """int8 weights and an int8 pool holding an int8 contiguous cache's
    rows block by block, every row's scales the cache's (one position for
    every row): the contiguous int8 plain version's bits."""
    L, h, nh, nkv, hd, ffn, b, pos = 2, 64, 4, 2, 16, 96, 2, 19
    S = MB * BT
    r = np.random.RandomState(13)
    params, _, _ = _int8_modes(_params(r, L, h, nh, nkv, hd, ffn), None, r,
                               b, True, False, nkv, hd)
    params = {k: (torch.from_numpy(v).bfloat16()
                  if v.dtype == np.float32 and not k.endswith("_s")
                  else torch.from_numpy(v)) for k, v in params.items()}
    x = torch.from_numpy(r.randn(b, h).astype(np.float32)).bfloat16()
    cache = torch.from_numpy(
        r.randn(L, b, S, 2 * nkv * hd).astype(np.float32)).bfloat16()
    cache[:, :, pos:] = 0
    cache, lanes = tfd.quantize_kv_cache(cache, nkv)
    tables = np.array([[4, 1, 10, 6], [2, 8, 3, 11]], np.int32)
    pool = torch.zeros(L, NB, BT, 2 * nkv * hd, dtype=torch.int8)
    for i in range(b):
        pool[:, torch.from_numpy(tables[i]).long()] = cache[:, i].reshape(
            L, MB, BT, -1)
    c, s = trope_cos_sin(S, hd)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xc, cache = tfd.fused_decode_step(x, params, cache, pos, c[pos:pos + 1],
                                      s[pos:pos + 1], kv_scales=lanes, **kw)
    positions = torch.full((b,), pos, dtype=torch.int32)
    xp, pool = tfd.fused_paged_decode_step(
        x, params, pool, torch.from_numpy(tables), positions,
        c[positions.long()], s[positions.long()],
        kv_scales=lanes.expand(L, b, -1).contiguous(), **kw)
    assert torch.equal(xp, xc)
    for i in range(b):
        assert torch.equal(pool[:, torch.from_numpy(tables[i]).long()]
                           .reshape(L, S, -1), cache[:, i])
