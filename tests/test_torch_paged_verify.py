"""The paged verify step of paddle_tpu_torch against paddle_tpu's.

* fused_paged_verify_reference (the plain version a CPU tensor runs) against
  the JAX ``fused_paged_verify_reference`` in fp32, MHA and GQA: three rows
  over a shuffled block table, one tail crossing a block boundary, one row
  idle. x_out of the active rows and the appended rows in mapped blocks
  agree within 1e-5 (sums in another order).
* The same against the TPU kernel itself, run as the JAX package's own
  ``tests/test_serving_spec.py::_verify_twin_case`` runs it on the CPU
  (``_fused_paged_verify_pallas(..., interpret=True)``), bf16, b=2, NB=12,
  BT=16, K1=4, positions 33 and 17: atol = rtol = 2e-2 on x_out and 2e-2
  on the mapped pool rows — bf16 intermediates rounded on either side of a
  boundary, and the kernel's in-kernel rope angles.
* An all-accepted plain verify equals K1 sequential plain paged steps, bit
  for bit (the contract speculation's token parity rests on).
* A tail straddling a block boundary and a tail running past the table:
  appends land in the right blocks or in scratch, every other block is
  untouched.
* The int8 modes (reference :2579-2594) — llama int8 weights, an int8 pool
  with per-row scales, both, and the gpt int8 pool — against the JAX
  reference in fp32, MHA and GQA: x_out of the active rows atol 1e-5, the
  appended int8 rows of mapped blocks within one int8 step (a .5 rounding
  of values a few fp32 ulp apart), the rest of the mapped blocks equal;
  against the TPU kernel in interpret mode in bf16 on the twin case at
  the bf16 tolerance above (the int8 rows within one step); and an
  all-accepted int8 verify is K1 sequential int8 plain paged steps, bit
  for bit.
* What is still unported raises naming ROADMAP; a kv_scales that does
  not match the pool's dtype raises ValueError; the int8 modes run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.ops.rope import rope_cos_sin as trope_cos_sin

# row 0 active through private shuffled blocks, its tail crossing from
# block 7 into block 3; row 1 active near the end of its table; row 2 idle
BT, MB, NB, K1 = 8, 4, 12, 4
TABLES = np.array([[7, 3, 0, 0], [5, 9, 2, 11], [0, 0, 0, 0]], np.int32)
POSITIONS = np.array([6, 26, 3], np.int32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run shares the CPU among several test workers: keep this
    file's torch ops on one thread, so they do not crowd out the other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(r, L, h, nh, nkv, hd, ffn, sc=0.05):
    dq, dkv = nh * hd, nkv * hd
    f = lambda *s, sc=sc: (r.randn(*s) * sc).astype(np.float32)
    return {"ln1": 1 + f(L, h, sc=0.1), "wqkv": f(L, h, dq + 2 * dkv),
            "wo": f(L, dq, h), "ln2": 1 + f(L, h, sc=0.1),
            "wg": f(L, h, ffn), "wu": f(L, h, ffn), "wd": f(L, ffn, h)}


def _rope_rows(hd, positions, k1=K1, S=MB * BT):
    """(b, K1, hd) rope rows at min(pos + j, S - 1), as the engine gathers
    them."""
    c, s = trope_cos_sin(S, hd)
    idx = torch.from_numpy(np.minimum(positions[:, None] + np.arange(k1),
                                      S - 1).astype(np.int64))
    return c[idx], s[idx]


def _to_t(a):
    """A numpy or JAX array as a torch tensor, bit for bit (bf16 too)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _int8_modes(params, pool, r, b, w8, kv8, nkv, hd):
    """The int8 modes' inputs from fp32 ones: int8 weight stacks with
    per-out-channel scale rows (w8; absmax / 127 over each column) and an
    int8 pool with per-ROW lane scales (L, b, 2*nkv*hd) (kv8), as numpy."""
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


def _int8_rows_close(pt, pj, mapped):
    """Within one int8 step on the mapped blocks, equal wherever the two
    differ by nothing (the appends are the only rows that may differ)."""
    d = np.abs(pt[:, mapped].astype(np.int32) - pj[:, mapped].astype(np.int32))
    assert d.max() <= 1
    return d


@pytest.mark.parametrize("nkv", [4, 2])          # MHA, GQA
def test_verify_reference_matches_jax_reference_fp32(nkv):
    L, h, nh, hd, ffn = 2, 64, 4, 16, 96
    r = np.random.RandomState(nkv)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    x = r.randn(3, K1, h).astype(np.float32)
    pool = r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)
    cos, sin = _rope_rows(hd, POSITIONS)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xj, pj = jfd.fused_paged_verify_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(pool), jnp.asarray(TABLES), jnp.asarray(POSITIONS),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), **kw)
    xt, pt = tfd.fused_paged_verify_step(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              params.items()},
        torch.from_numpy(pool.copy()), torch.from_numpy(TABLES),
        torch.from_numpy(POSITIONS), cos, sin, **kw)
    assert tuple(xt.shape) == (3, K1, h)
    active = [0, 1]                 # the idle row's output is thrown away
    np.testing.assert_allclose(xt.numpy()[active], np.asarray(xj)[active],
                               atol=1e-5, rtol=1e-5)
    mapped = sorted({int(t) for t in TABLES.ravel() if t != 0})
    np.testing.assert_allclose(pt.numpy()[:, mapped],
                               np.asarray(pj)[:, mapped], atol=1e-5,
                               rtol=1e-5)
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_verify_reference_matches_interpret_kernel_bf16():
    """The TPU kernel in interpret mode vs the port's plain version, on the
    JAX package's own twin case (b=2, NB=12, BT=16, K1=4)."""
    L, h, nh, nkv, hd, ffn = 2, 128, 4, 4, 32, 256
    b, nb, bt, k1 = 2, 12, 16, 4
    r = np.random.RandomState(0)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    pool = r.randn(L, nb, bt, 2 * nkv * hd).astype(np.float32)
    tables = np.zeros((b, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    positions = np.asarray([33, 17], np.int32)      # mid-block appends
    x = r.randn(b, k1, h).astype(np.float32)
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    pool_j = jnp.asarray(pool, jnp.bfloat16)
    x_j = jnp.asarray(x, jnp.bfloat16)
    yk, pk = jax.jit(lambda x, p, c: jfd._fused_paged_verify_pallas(
        x.transpose(1, 0, 2).reshape(k1 * b, h), p, c, jnp.asarray(tables),
        jnp.asarray(positions), num_heads=nh, num_kv_heads=nkv,
        head_dim=hd, eps=1e-5, interpret=True))(x_j, pj, pool_j)
    yk = np.asarray(yk, np.float32).reshape(k1, b, h).transpose(1, 0, 2)
    cos, sin = _rope_rows(hd, positions, k1, S=4 * bt)
    yt, pt = tfd.fused_paged_verify_step(
        _to_t(x_j), {k: _to_t(v) for k, v in pj.items()}, _to_t(pool_j),
        torch.from_numpy(tables), torch.from_numpy(positions), cos, sin,
        num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    np.testing.assert_allclose(yt.float().numpy(), yk, atol=2e-2, rtol=2e-2)
    mapped = sorted({int(t) for t in tables.ravel() if t != 0})
    np.testing.assert_allclose(pt.float().numpy()[:, mapped],
                               np.asarray(pk, np.float32)[:, mapped],
                               atol=2e-2, rtol=0)


def test_all_accepted_verify_equals_sequential_plain_steps_bitwise():
    """Tail token j through the verify == a plain paged step at pos + j
    after steps 0..j-1, bit for bit: x_out and the whole pool (bf16)."""
    L, h, nh, nkv, hd, ffn = 2, 64, 4, 2, 16, 96
    r = np.random.RandomState(3)
    params = {k: torch.from_numpy(v).bfloat16() for k, v in
              _params(r, L, h, nh, nkv, hd, ffn).items()}
    x = torch.from_numpy(r.randn(3, K1, h).astype(np.float32)).bfloat16()
    pool = torch.from_numpy(
        r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)).bfloat16()
    tables = torch.from_numpy(TABLES)
    positions = torch.from_numpy(POSITIONS)
    cos, sin = _rope_rows(hd, POSITIONS)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    pool_seq = pool.clone()
    xv, pool = tfd.fused_paged_verify_step(x, params, pool, tables,
                                           positions, cos, sin, **kw)
    for j in range(K1):
        xs, pool_seq = tfd.fused_paged_decode_step(
            x[:, j].contiguous(), params, pool_seq, tables, positions + j,
            cos[:, j].contiguous(), sin[:, j].contiguous(), **kw)
        assert torch.equal(xv[:, j], xs), j
    assert torch.equal(pool, pool_seq)


@pytest.mark.parametrize("cap", [1, 3, 4])
def test_tail_in_chunks_equals_the_whole_tail_bitwise(cap):
    """A tail run as consecutive verifies over chunks of at most `cap`
    tokens (``in_tail_chunks``, how K7's wrapper runs a tail longer than
    one launch takes), the plain verify as the callee: x_out and the whole
    pool bit for bit the whole tail's, bf16 (each chunk sees the appends
    of the ones before it)."""
    L, h, nh, nkv, hd, ffn, k1 = 2, 64, 4, 2, 16, 96, 7
    r = np.random.RandomState(8)
    params = {k: torch.from_numpy(v).bfloat16() for k, v in
              _params(r, L, h, nh, nkv, hd, ffn).items()}
    x = torch.from_numpy(r.randn(3, k1, h).astype(np.float32)).bfloat16()
    pool = torch.from_numpy(
        r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)).bfloat16()
    tables = torch.from_numpy(TABLES)
    positions = torch.from_numpy(POSITIONS)
    cos, sin = _rope_rows(hd, POSITIONS, k1=k1)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    pool_whole = pool.clone()
    xw, _ = tfd.fused_paged_verify_reference(x, params, pool_whole, tables,
                                             positions, cos, sin, **kw)
    calls = []

    def step(xc, pc, cc, sc):
        calls.append(xc.shape[1])
        return tfd.fused_paged_verify_reference(xc, params, pool, tables, pc,
                                                cc, sc, **kw)[0]

    xc = tfd.in_tail_chunks(step, x, positions, cos, sin, cap=cap)
    assert calls == [b - a for a, b in tfd.row_groups(k1, cap)]
    assert torch.equal(xc, xw)
    assert torch.equal(pool, pool_whole)


def test_appends_straddle_and_past_the_table_land_where_they_should():
    """Row 0's tail (6..9) crosses from its block 7 into block 3; row 1's
    (30..33) runs past its 4-entry table, so 32 and 33 land in scratch.
    Each appended row holds the rope'd k and v the plain step computes for
    it; every block no append reached is untouched."""
    L, h, nh, nkv, hd, ffn = 1, 64, 4, 2, 16, 96
    r = np.random.RandomState(5)
    params = {k: torch.from_numpy(v) for k, v in
              _params(r, L, h, nh, nkv, hd, ffn).items()}
    positions = np.array([6, 30, 3], np.int32)
    x = torch.from_numpy(r.randn(3, K1, h).astype(np.float32))
    pool0 = torch.from_numpy(
        r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32))
    cos, sin = _rope_rows(hd, positions)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    _, pool = tfd.fused_paged_verify_step(
        x, params, pool0.clone(), torch.from_numpy(TABLES),
        torch.from_numpy(positions), cos, sin, **kw)
    want = {(7, 6), (7, 7), (3, 0), (3, 1),      # row 0
            (11, 6), (11, 7)}                    # row 1 (30, 31)
    dq, dkv = nh * hd, nkv * hd
    for bid, off in want:
        assert not torch.equal(pool[:, bid, off], pool0[:, bid, off])
    # the v half of an appended row is the layer-0 v projection itself
    xn = tfd._rms(x[0, 0][None], params["ln1"][0], 1e-5)
    v = (xn @ params["wqkv"][0])[0, dq + dkv:]
    torch.testing.assert_close(pool[0, 7, 6, dkv:], v, atol=1e-6, rtol=1e-6)
    touched = {0, 7, 3, 11}
    rest = [i for i in range(NB) if i not in touched]
    assert torch.equal(pool[:, rest], pool0[:, rest])
    for bid in (7, 3, 11):                       # rows no append reached
        hit = [off for b_, off in want if b_ == bid]
        keep = [o for o in range(BT) if o not in hit]
        assert torch.equal(pool[:, bid, keep], pool0[:, bid, keep])
    # the table is never read at MB or beyond: a tail starting at the
    # last position of the table still runs
    xe, _ = tfd.fused_paged_verify_step(
        x, params, pool0.clone(), torch.from_numpy(TABLES),
        torch.tensor([MB * BT - 1, MB * BT - 1, 0], dtype=torch.int32),
        cos, sin, **kw)
    assert bool(torch.isfinite(xe).all())


def test_verify_dispatch_refuses_unported_modes():
    """Still refused: any arch but llama and gpt (Queue B row 6), mp_axis
    (Queue A item 8) and int8 weights on gpt (the reference has no such
    mode); a kv_scales that does not match the pool's dtype and a plan of
    another cache width raise ValueError. The int8 modes run."""
    x = torch.zeros(1, 2, 8)
    pool = torch.zeros(1, 2, 8, 8)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    args = (x, {}, pool, tab, pos, None, None)
    kw = dict(num_heads=1, num_kv_heads=1)
    with pytest.raises(NotImplementedError, match="Queue B row 6"):
        tfd.fused_paged_verify_step(*args, **kw, arch="moe")
    for extra in (dict(mp_axis="mp"), dict(arch="gpt", mp_axis="mp")):
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            tfd.fused_paged_verify_step(*args, **kw, **extra)
    with pytest.raises(NotImplementedError, match="no such mode"):
        tfd.fused_paged_verify_step(x, {"wqkv_s": None}, pool, tab, pos,
                                    None, None, arch="gpt", **kw)
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_paged_verify_step(*args, **kw, kv_scales=torch.ones(1))
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_paged_verify_step(x, {}, pool.to(torch.int8), tab, pos,
                                    None, None, **kw)
    with pytest.raises(ValueError, match="cache"):
        tfd.fused_paged_verify_step(*args, **kw, blocks={"cache_wbytes": 1})
    # every int8 mode runs on CPU tensors and launches nothing
    L, h, nh, nkv, hd, ffn = 1, 32, 2, 2, 16, 64
    r = np.random.RandomState(2)
    cos, sin = _rope_rows(hd, POSITIONS)
    for w8, kv8 in ((True, False), (False, True), (True, True)):
        p, pl, sc = _int8_modes(_params(r, L, h, nh, nkv, hd, ffn),
                                r.randn(L, NB, BT, 2 * nkv * hd)
                                .astype(np.float32), r, 3, w8, kv8, nkv, hd)
        xo, _ = tfd.fused_paged_verify_step(
            torch.from_numpy(r.randn(3, K1, h).astype(np.float32)),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(pl), torch.from_numpy(TABLES),
            torch.from_numpy(POSITIONS), cos, sin,
            kv_scales=None if sc is None else torch.from_numpy(sc),
            num_heads=nh, num_kv_heads=nkv)
        assert bool(torch.isfinite(xo).all())
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_verify_gpt_arch_runs_on_cpu_tensors():
    """arch="gpt" (ported) runs the plain verify on CPU tensors, without
    rope rows, and launches nothing; an all-accepted gpt verify is K1
    sequential plain gpt paged steps, bit for bit."""
    L, h, nh, ffn = 2, 32, 2, 64
    r = np.random.RandomState(9)
    f = lambda *s: torch.from_numpy((r.randn(*s) * 0.1).astype(np.float32))
    p = {"ln1": 1 + f(L, h), "ln1_b": f(L, h), "wqkv": f(L, h, 3 * h),
         "bqkv": f(L, 3 * h), "wo": f(L, h, h), "bo": f(L, h),
         "ln2": 1 + f(L, h), "ln2_b": f(L, h), "wg": f(L, h, ffn),
         "bg": f(L, ffn), "wd": f(L, ffn, h), "bd": f(L, h)}
    pool = f(L, NB, BT, 2 * h)
    x = f(3, K1, h)
    tab, pos = torch.from_numpy(TABLES), torch.from_numpy(POSITIONS)
    kw = dict(num_heads=nh, num_kv_heads=nh, arch="gpt")
    tfd.fused_paged_verify_cuda.launches = 0
    xv, pv = tfd.fused_paged_verify_step(x, p, pool.clone(), tab, pos, None,
                                         None, **kw)
    assert tfd.fused_paged_verify_cuda.launches == 0
    ps = pool.clone()
    for j in range(K1):
        xs, ps = tfd.fused_paged_decode_step(x[:, j].contiguous(), p, ps,
                                             tab, pos + j, None, None, **kw)
        assert torch.equal(xv[:2, j], xs[:2])
    assert torch.equal(pv[:, 1:], ps[:, 1:])


INT8_MODES = [("llama", True, False), ("llama", False, True),
              ("llama", True, True), ("gpt", False, True)]
INT8_IDS = ["llama-int8w", "llama-int8kv", "llama-int8w-int8kv",
            "gpt-int8kv"]


def _gpt_params(r, L, h, ffn, sc=0.05):
    f = lambda *s, sc=sc: (r.randn(*s) * sc).astype(np.float32)
    return {"ln1": 1 + f(L, h, sc=0.1), "ln1_b": f(L, h, sc=0.1),
            "wqkv": f(L, h, 3 * h), "bqkv": f(L, 3 * h, sc=0.1),
            "wo": f(L, h, h), "bo": f(L, h, sc=0.1),
            "ln2": 1 + f(L, h, sc=0.1), "ln2_b": f(L, h, sc=0.1),
            "wg": f(L, h, ffn), "bg": f(L, ffn, sc=0.1),
            "wd": f(L, ffn, h), "bd": f(L, h, sc=0.1)}


@pytest.mark.parametrize("nkv", [4, 2])          # MHA, GQA (gpt: MHA)
@pytest.mark.parametrize("arch,w8,kv8", INT8_MODES, ids=INT8_IDS)
def test_verify_reference_int8_modes_match_jax_reference_fp32(arch, w8, kv8,
                                                             nkv):
    L, hd, ffn = 2, 16, 96
    nh = 4 if arch == "llama" else nkv
    h = 64 if arch == "llama" else nh * hd
    r = np.random.RandomState(20 + nkv)
    params = (_params(r, L, h, nh, nkv, hd, ffn) if arch == "llama"
              else _gpt_params(r, L, h, ffn))
    pool = r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32)
    params, pool, sc = _int8_modes(params, pool, r, 3, w8, kv8, nkv, hd)
    x = r.randn(3, K1, h).astype(np.float32)
    if arch == "llama":
        cos, sin = _rope_rows(hd, POSITIONS)
        cj, sj = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    else:
        cos = sin = None
        cj = sj = jnp.ones((3, K1, hd), jnp.float32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    xj, pj = jfd.fused_paged_verify_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(pool), jnp.asarray(TABLES), jnp.asarray(POSITIONS),
        cj, sj, kv_scales=None if sc is None else jnp.asarray(sc), **kw)
    xt, pt = tfd.fused_paged_verify_step(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              params.items()},
        torch.from_numpy(pool.copy()), torch.from_numpy(TABLES),
        torch.from_numpy(POSITIONS), cos, sin,
        kv_scales=None if sc is None else torch.from_numpy(sc), **kw)
    active = [0, 1]                 # the idle row's output is thrown away
    np.testing.assert_allclose(xt.numpy()[active], np.asarray(xj)[active],
                               atol=1e-5, rtol=1e-5)
    mapped = sorted({int(t) for t in TABLES.ravel() if t != 0})
    if kv8:
        d = _int8_rows_close(pt.numpy(), np.asarray(pj), mapped)
        # only appended rows (row 0: 6..9 over blocks 7, 3; row 1: 26..29
        # in block 2) may differ
        appended = np.zeros(d.shape[1:3], bool)
        for row, p0 in ((0, 6), (1, 26)):
            for t in range(p0, p0 + K1):
                appended[mapped.index(int(TABLES[row, t // BT])),
                         t % BT] = True
        assert not d[:, ~appended].any()
    else:
        np.testing.assert_allclose(pt.numpy()[:, mapped],
                                   np.asarray(pj)[:, mapped], atol=1e-5,
                                   rtol=1e-5)
    assert tfd.fused_paged_verify_cuda.launches == 0


@pytest.mark.parametrize("w8,kv8", [(True, True), (False, True)],
                         ids=["int8w-int8kv", "int8kv"])
def test_verify_reference_int8_modes_match_interpret_kernel_bf16(w8, kv8):
    """The TPU kernel's int8 modes in interpret mode vs the port's plain
    version, on the twin case above."""
    L, h, nh, nkv, hd, ffn = 2, 128, 4, 4, 32, 256
    b, nb, bt, k1 = 2, 12, 16, 4
    r = np.random.RandomState(7)
    params = _params(r, L, h, nh, nkv, hd, ffn)
    pool = r.randn(L, nb, bt, 2 * nkv * hd).astype(np.float32)
    params, pool, sc = _int8_modes(params, pool, r, b, w8, kv8, nkv, hd)
    tables = np.zeros((b, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    positions = np.asarray([33, 17], np.int32)      # mid-block appends
    pj = {k: (jnp.asarray(v) if v.dtype != np.float32 or k.endswith("_s")
              else jnp.asarray(v, jnp.bfloat16)) for k, v in params.items()}
    pool_j = jnp.asarray(pool)
    x_j = jnp.asarray(r.randn(b, k1, h).astype(np.float32), jnp.bfloat16)
    yk, pk = jax.jit(lambda x, p, c: jfd._fused_paged_verify_pallas(
        x.transpose(1, 0, 2).reshape(k1 * b, h), p, c, jnp.asarray(tables),
        jnp.asarray(positions), num_heads=nh, num_kv_heads=nkv,
        head_dim=hd, eps=1e-5, kv_scales=jnp.asarray(sc),
        interpret=True))(x_j, pj, pool_j)
    yk = np.asarray(yk, np.float32).reshape(k1, b, h).transpose(1, 0, 2)
    cos, sin = _rope_rows(hd, positions, k1, S=4 * bt)
    yt, pt = tfd.fused_paged_verify_step(
        _to_t(x_j), {k: _to_t(v) for k, v in pj.items()}, _to_t(pool_j),
        torch.from_numpy(tables), torch.from_numpy(positions), cos, sin,
        num_heads=nh, num_kv_heads=nkv, eps=1e-5,
        kv_scales=torch.from_numpy(sc))
    np.testing.assert_allclose(yt.float().numpy(), yk, atol=2e-2, rtol=2e-2)
    mapped = sorted({int(t) for t in tables.ravel() if t != 0})
    _int8_rows_close(pt.numpy(), np.asarray(pk), mapped)


@pytest.mark.parametrize("w8", [False, True])
def test_all_accepted_int8_verify_equals_sequential_plain_steps_bitwise(w8):
    """The int8 pool (and int8 weights): tail token j through the verify
    == an int8 plain paged step at pos + j after steps 0..j-1, bit for
    bit: x_out and the whole pool."""
    L, h, nh, nkv, hd, ffn = 2, 64, 4, 2, 16, 96
    r = np.random.RandomState(17)
    params, pool, sc = _int8_modes(
        _params(r, L, h, nh, nkv, hd, ffn),
        r.randn(L, NB, BT, 2 * nkv * hd).astype(np.float32), r, 3, w8,
        True, nkv, hd)
    params = {k: (torch.from_numpy(v).bfloat16()
                  if v.dtype == np.float32 and not k.endswith("_s")
                  else torch.from_numpy(v)) for k, v in params.items()}
    x = torch.from_numpy(r.randn(3, K1, h).astype(np.float32)).bfloat16()
    pool, sc = torch.from_numpy(pool), torch.from_numpy(sc)
    tables = torch.from_numpy(TABLES)
    positions = torch.from_numpy(POSITIONS)
    cos, sin = _rope_rows(hd, POSITIONS)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, kv_scales=sc)
    pool_seq = pool.clone()
    xv, pool = tfd.fused_paged_verify_step(x, params, pool, tables,
                                           positions, cos, sin, **kw)
    for j in range(K1):
        xs, pool_seq = tfd.fused_paged_decode_step(
            x[:, j].contiguous(), params, pool_seq, tables, positions + j,
            cos[:, j].contiguous(), sin[:, j].contiguous(), **kw)
        assert torch.equal(xv[:, j], xs), j
    assert torch.equal(pool, pool_seq)
