"""GPT generation of paddle_tpu_torch against paddle_tpu, on the CPU.

A tiny GPT (hidden 128, 2 layers, 2 heads of 64, vocab 256, 256 positions,
dropout 0) with fp32 weights from the JAX model, carried across with
utils/convert.py; inputs from numpy seeds.

* The cache forward: logits and cache at start_pos 0 and > 0 against the
  JAX cache forward, atol 1e-4 (fp32; sums in another order).
* ``build_fused_params_gpt``: the same stacks, bit for bit.
* The gpt arch of ``fused_decode_reference``, ``fused_paged_decode_reference``
  and ``fused_paged_verify_reference`` (the plain versions a CPU tensor
  runs) against the JAX functions of the same name in fp32: atol 2e-5,
  rtol 1e-5 (sums in another order), x_out and the whole cache or pool;
  the decode steps at 3 and 12 rows.
* The same three steps against the TPU kernels themselves in bf16, run as
  the JAX package runs them on the CPU (``_fused_decode_pallas``,
  ``_fused_paged_decode_pallas``, ``_fused_paged_verify_pallas`` with
  ``arch="gpt", interpret=True``): atol 2e-2, rtol 2^-6 (the verify case
  2e-2, as the llama one), K2's bound (one or two bf16 ulp of the output
  plus bf16 intermediates rounded on either side of a boundary).
* ``generate``: tokens EQUAL the JAX ``generate``'s, greedy and sampled,
  on the fused path (bf16 cache) and the layered path (FLAGS_fused_decode
  off in both packages, fp32 cache), with a tied and an untied head; no
  kernel counts a launch.
* A model without ``fused_decode_plan`` takes the layered path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core.flags import set_flags as jset_flags
from paddle_tpu.inference import generate as jgenerate
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainModel as JGPT
from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu_torch.core.flags import set_flags as tset_flags
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import (GPTConfig, GPTPretrainModel,
                                     LlamaConfig, LlamaForCausalLM)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.utils.convert import jax_state_to_torch, load_jax_state

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
B, PROMPT, NEW = 2, 9, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpt_pair(tied=True, seed=0):
    """(JAX model, port model) with the same fp32 weights, both in eval."""
    paddle_tpu.seed(seed)
    jm = JGPT(JGPTConfig(**CFG, tie_word_embeddings=tied))
    jm.eval()
    tm = GPTPretrainModel(GPTConfig(**CFG, tie_word_embeddings=tied),
                          device="cpu", seed=0)
    tm.eval()
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return jm, tm


@pytest.fixture(scope="module")
def tied():
    return gpt_pair(True)


@pytest.fixture(scope="module")
def untied():
    return gpt_pair(False, seed=1)


def _ids(seed, b=B, s=PROMPT):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def test_cache_forward_matches_jax(tied):
    jm, tm = tied
    ids = _ids(0)
    total = PROMPT + 4
    cj = jm.init_cache(B, total, dtype=jnp.float32)
    oj, cj = jm(jnp.asarray(ids), cache=cj, start_pos=0)
    nxt = _ids(1, s=2)
    oj2, cj = jm(jnp.asarray(nxt), cache=cj, start_pos=PROMPT)
    with torch.no_grad():
        ct = tm.init_cache(B, total, dtype=torch.float32)
        ot, ct = tm(torch.from_numpy(ids).long(), cache=ct, start_pos=0)
        ot2, ct = tm(torch.from_numpy(nxt).long(), cache=ct,
                     start_pos=PROMPT)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    np.testing.assert_allclose(ot2.numpy(), np.asarray(oj2), atol=1e-4)
    for c_t, c_j in zip(ct, cj):
        for k in ("k", "v"):
            np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                       atol=1e-4)
    # the no-cache forward is the cache forward's prefix
    with torch.no_grad():
        full = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(full.numpy(), ot.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_build_fused_params_gpt_equal(tied, dtype):
    jm, _ = tied
    sd = {k: np.asarray(v.astype(dtype)) for k, v in
          jm.state_dict(include_buffers=False).items()}
    pj = jfd.build_fused_params_gpt({k: jnp.asarray(v) for k, v in
                                     sd.items()}, CFG["num_layers"])
    pt = tfd.build_fused_params_gpt(jax_state_to_torch(sd),
                                    CFG["num_layers"])
    assert list(pt) == list(tfd._GPT_KEYS) and set(pj) == set(pt)
    for k in pj:
        a = np.asarray(pj[k])
        assert tuple(pt[k].shape) == a.shape, k
        if dtype == jnp.bfloat16:
            assert np.array_equal(pt[k].view(torch.int16).numpy(),
                                  a.view(np.int16)), k
        else:
            assert np.array_equal(pt[k].numpy(), a), k


def _gpt_params(r, L, h, ffn, sc=0.05):
    f = lambda *s, sc=sc: (r.randn(*s) * sc).astype(np.float32)
    return {"ln1": 1 + f(L, h, sc=0.1), "ln1_b": f(L, h, sc=0.1),
            "wqkv": f(L, h, 3 * h), "bqkv": f(L, 3 * h, sc=0.1),
            "wo": f(L, h, h), "bo": f(L, h, sc=0.1),
            "ln2": 1 + f(L, h, sc=0.1), "ln2_b": f(L, h, sc=0.1),
            "wg": f(L, h, ffn), "bg": f(L, ffn, sc=0.1),
            "wd": f(L, ffn, h), "bd": f(L, h, sc=0.1)}


def _jt(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


@pytest.mark.parametrize("pos", [0, 11])
@pytest.mark.parametrize("b", [3, 12])    # 12: past the kernels' old 8
def test_gpt_reference_matches_jax_reference_fp32(pos, b):
    L, S, nh, hd, ffn = 2, 16, 4, 16, 96
    h = nh * hd
    r = np.random.RandomState(pos)
    pj, pt = _jt(_gpt_params(r, L, h, ffn))
    x = (r.randn(b, h) * 2 + 1).astype(np.float32)   # a residual with a mean
    kv = r.randn(L, b, S, 2 * h).astype(np.float32)
    kv[:, :, pos:] = 0.0
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5)
    ones = jnp.ones((1, hd), jnp.float32)      # the gpt step takes no rope
    xj, kvj = jfd.fused_decode_reference(jnp.asarray(x), pj, jnp.asarray(kv),
                                         pos, ones, ones, arch="gpt", **kw)
    xt, kvt = tfd.fused_decode_step(torch.from_numpy(x), pt,
                                    torch.from_numpy(kv.copy()), pos, None,
                                    None, arch="gpt", **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(kvt.numpy(), np.asarray(kvj), atol=2e-5,
                               rtol=1e-5)
    assert tfd.fused_decode_cuda.launches == 0


# rows 0 and 1 active at their own positions through private shuffled
# blocks; row 2 idle (table all scratch) at a position inside block 0
BT, MB, NB = 8, 4, 12
TABLES = np.array([[7, 3, 0, 0], [5, 9, 2, 11], [0, 0, 0, 0]], np.int32)
POSITIONS = np.array([13, 29, 5], np.int32)


def _layout(b):
    """(tables, positions, pool blocks) of b rows: TABLES for 3; for 12,
    rows 0..10 own private blocks drawn from a shuffle, at positions across
    their span, and row 11 idle as row 2 of TABLES."""
    if b == 3:
        return TABLES, POSITIONS, NB
    nb = 1 + (b - 1) * MB
    tables = np.zeros((b, MB), np.int32)
    tables[:-1] = (np.random.RandomState(b).permutation(nb - 1)
                   + 1).reshape(b - 1, MB)
    positions = np.array([0, 3, 7, 8, 13, 17, 22, 26, 29, 30, 31, 5],
                         np.int32)
    return tables, positions, nb


@pytest.mark.parametrize("b", [3, 12])    # 12: past the kernels' old 8
def test_gpt_paged_reference_matches_jax_reference_fp32(b):
    L, nh, hd, ffn = 2, 4, 16, 96
    h = nh * hd
    tables, positions, nb = _layout(b)
    r = np.random.RandomState(3)
    pj, pt = _jt(_gpt_params(r, L, h, ffn))
    x = r.randn(b, h).astype(np.float32)
    pool = r.randn(L, nb, BT, 2 * h).astype(np.float32)
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5)
    ones = jnp.ones((b, hd), jnp.float32)
    xj, poolj = jfd.fused_paged_decode_reference(
        jnp.asarray(x), pj, jnp.asarray(pool), jnp.asarray(tables),
        jnp.asarray(positions), ones, ones, arch="gpt", **kw)
    xt, poolt = tfd.fused_paged_decode_step(
        torch.from_numpy(x), pt, torch.from_numpy(pool.copy()),
        torch.from_numpy(tables), torch.from_numpy(positions), None, None,
        arch="gpt", **kw)
    # the active rows (all but the last)
    np.testing.assert_allclose(xt[:-1].numpy(), np.asarray(xj)[:-1],
                               atol=2e-5, rtol=1e-5)
    # every block but scratch (where the idle row's append lands)
    np.testing.assert_allclose(poolt[:, 1:].numpy(), np.asarray(poolj)[:, 1:],
                               atol=2e-5, rtol=1e-5)
    assert tfd.fused_paged_decode_cuda.launches == 0


def test_gpt_verify_reference_matches_jax_reference_fp32():
    L, nh, hd, ffn, K1 = 2, 4, 16, 96, 3
    h = nh * hd
    r = np.random.RandomState(4)
    pj, pt = _jt(_gpt_params(r, L, h, ffn))
    x = r.randn(3, K1, h).astype(np.float32)
    pool = r.randn(L, NB, BT, 2 * h).astype(np.float32)
    # row 0 crosses a block boundary (13..15 | 16 unmapped: scratch), row 1
    # runs to the table's last position and past it
    positions = np.array([13, MB * BT - 2, 5], np.int32)
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5)
    ones = jnp.ones((3, K1, hd), jnp.float32)
    xj, poolj = jfd.fused_paged_verify_reference(
        jnp.asarray(x), pj, jnp.asarray(pool), jnp.asarray(TABLES),
        jnp.asarray(positions), ones, ones, arch="gpt", **kw)
    xt, poolt = tfd.fused_paged_verify_step(
        torch.from_numpy(x), pt, torch.from_numpy(pool.copy()),
        torch.from_numpy(TABLES), torch.from_numpy(positions), None, None,
        arch="gpt", **kw)
    # the tail tokens at mapped positions: row 0's first three, row 1's
    # first two
    for r_, j in [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]:
        np.testing.assert_allclose(xt[r_, j].numpy(), np.asarray(xj)[r_, j],
                                   atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(poolt[:, 1:].numpy(), np.asarray(poolj)[:, 1:],
                               atol=2e-5, rtol=1e-5)
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_gpt_reference_matches_interpret_kernel_bf16():
    """The TPU kernel's gpt mode in interpret mode vs the port's plain
    version, bf16."""
    L, b, S, nh, hd, ffn = 2, 2, 128, 2, 64, 256
    h = nh * hd
    r = np.random.RandomState(0)
    params = _gpt_params(r, L, h, ffn)
    x = (r.randn(b, h) + 0.5).astype(np.float32)
    kv = r.randn(L, b, S, 2 * h).astype(np.float32)
    pos = 77
    kv[:, :, pos:] = 0.0
    pj, pt = _bf16_pair(params)
    kv_j = jnp.asarray(kv, jnp.bfloat16)
    xj, kvj = jax.jit(lambda x, p, c: jfd._fused_decode_pallas(
        x, p, c, pos, num_heads=nh, num_kv_heads=nh, head_dim=hd, eps=1e-5,
        arch="gpt", interpret=True))(jnp.asarray(x, jnp.bfloat16), pj, kv_j)
    xt, kvt = tfd.fused_decode_step(
        _to_t(jnp.asarray(x, jnp.bfloat16)), pt, _to_t(kv_j), pos, None,
        None, num_heads=nh, num_kv_heads=nh, eps=1e-5, arch="gpt")
    np.testing.assert_allclose(xt.float().numpy(), np.asarray(xj, np.float32),
                               atol=2e-2, rtol=2 ** -6)
    np.testing.assert_allclose(kvt[:, :, pos].float().numpy(),
                               np.asarray(kvj, np.float32)[:, :, pos],
                               atol=2e-2, rtol=2 ** -6)
    assert torch.equal(kvt[:, :, :pos], _to_t(kv_j)[:, :, :pos])


def _bf16_pair(params):
    """bf16 params for both packages, bit for bit."""
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    return pj, {k: _to_t(v) for k, v in pj.items()}


def _to_t(a):
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
        torch.bfloat16)


def test_gpt_paged_reference_matches_interpret_kernel_bf16():
    """The paged TPU kernel's gpt mode in interpret mode vs the port's plain
    paged version, bf16, the active rows (K2's tolerance)."""
    L, nh, hd, ffn = 2, 2, 64, 256
    h = nh * hd
    r = np.random.RandomState(1)
    pj, pt = _bf16_pair(_gpt_params(r, L, h, ffn))
    x = jnp.asarray(r.randn(3, h), jnp.bfloat16)
    pool = jnp.asarray(r.randn(L, NB, BT, 2 * h), jnp.bfloat16)
    xj, poolj = jax.jit(lambda x, p, c: jfd._fused_paged_decode_pallas(
        x, p, c, jnp.asarray(TABLES), jnp.asarray(POSITIONS), num_heads=nh,
        num_kv_heads=nh, head_dim=hd, eps=1e-5, arch="gpt",
        interpret=True))(x, pj, pool)
    xt, poolt = tfd.fused_paged_decode_step(
        _to_t(x), pt, _to_t(pool), torch.from_numpy(TABLES),
        torch.from_numpy(POSITIONS), None, None, num_heads=nh,
        num_kv_heads=nh, eps=1e-5, arch="gpt")
    np.testing.assert_allclose(xt.float().numpy()[:2],
                               np.asarray(xj, np.float32)[:2], atol=2e-2,
                               rtol=2 ** -6)
    for row in (0, 1):
        bid, off = TABLES[row, POSITIONS[row] // BT], POSITIONS[row] % BT
        np.testing.assert_allclose(poolt[:, bid, off].float().numpy(),
                                   np.asarray(poolj, np.float32)[:, bid, off],
                                   atol=2e-2, rtol=2 ** -6)


def test_gpt_verify_reference_matches_interpret_kernel_bf16():
    """The paged verify TPU kernel's gpt mode in interpret mode vs the
    port's plain verify, bf16 (the JAX package's twin case shape: b=2,
    BT=16, K1=4, mid-block positions): atol = rtol = 2e-2, as the llama
    case."""
    L, nh, hd, ffn = 2, 2, 64, 256
    h = nh * hd
    b, nb, bt, k1 = 2, 12, 16, 4
    r = np.random.RandomState(2)
    pj, pt = _bf16_pair(_gpt_params(r, L, h, ffn))
    pool = jnp.asarray(r.randn(L, nb, bt, 2 * h), jnp.bfloat16)
    tables = np.zeros((b, 4), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    positions = np.asarray([33, 17], np.int32)
    x = jnp.asarray(r.randn(b, k1, h), jnp.bfloat16)
    yk, pk = jax.jit(lambda x, p, c: jfd._fused_paged_verify_pallas(
        x.transpose(1, 0, 2).reshape(k1 * b, h), p, c, jnp.asarray(tables),
        jnp.asarray(positions), num_heads=nh, num_kv_heads=nh, head_dim=hd,
        eps=1e-5, arch="gpt", interpret=True))(x, pj, pool)
    yk = np.asarray(yk, np.float32).reshape(k1, b, h).transpose(1, 0, 2)
    yt, ptl = tfd.fused_paged_verify_step(
        _to_t(x), pt, _to_t(pool), torch.from_numpy(tables),
        torch.from_numpy(positions), None, None, num_heads=nh,
        num_kv_heads=nh, eps=1e-5, arch="gpt")
    np.testing.assert_allclose(yt.float().numpy(), yk, atol=2e-2, rtol=2e-2)
    mapped = [1, 2, 3, 4, 5]
    np.testing.assert_allclose(ptl.float().numpy()[:, mapped],
                               np.asarray(pk, np.float32)[:, mapped],
                               atol=2e-2, rtol=0)


SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)


@pytest.fixture
def layered_flags():
    """FLAGS_fused_decode off in both packages for one test."""
    jset_flags({"FLAGS_fused_decode": False})
    tset_flags({"FLAGS_fused_decode": False})
    yield
    jset_flags({"FLAGS_fused_decode": True})
    tset_flags({"FLAGS_fused_decode": True})


def _generate_both(pair, kw, cache):
    jm, tm = pair
    ids = _ids(6)
    jc, tc = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "fp32": (jnp.float32, torch.float32)}[cache]
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                              cache_dtype=jc, **kw))
    tfd.fused_decode_cuda.launches = 0
    tfa.flash_attention_fwd.launches = 0
    ot = tgenerate(tm, ids, max_new_tokens=NEW, cache_dtype=tc,
                   **kw).numpy()
    assert tfd.fused_decode_cuda.launches == 0
    assert tfa.flash_attention_fwd.launches == 0
    return ot.tolist(), oj.tolist()


@pytest.mark.parametrize("head", ["tied", "untied"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_fused_path_tokens_equal_jax(request, head, mode):
    """bf16 cache: the fused gpt decode step on both sides."""
    pair = request.getfixturevalue(head)
    got, want = _generate_both(pair, SAMPLED if mode == "sampled" else {},
                               "bf16")
    assert got == want


@pytest.mark.parametrize("head", ["tied", "untied"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_layered_path_tokens_equal_jax(request, layered_flags, head,
                                                mode):
    """FLAGS_fused_decode off: the model's cache forward on both sides."""
    pair = request.getfixturevalue(head)
    got, want = _generate_both(pair, SAMPLED if mode == "sampled" else {},
                               "fp32")
    assert got == want


def test_fused_plan_meta(tied):
    _, tm = tied
    meta = tm.fused_decode_plan(tm.state_dict(include_buffers=False),
                                probe=True)
    assert meta["arch"] == "gpt" and meta["num_kv_heads"] == 2
    assert meta["head_dim"] == 64 and meta["blocks"]["ffn_pad"] == 512
    plan = tm.fused_decode_plan(tm.state_dict(include_buffers=False))
    tok = torch.tensor([3, 7])
    x = plan["embed"](tok, torch.tensor([0, 5]))
    want = tm.gpt.wte.weight[tok] + tm.gpt.wpe.weight[[0, 5]]
    assert torch.equal(x, want)
    assert torch.equal(plan["embed"](tok, 4),
                       tm.gpt.wte.weight[tok] + tm.gpt.wpe.weight[4])


class _NoPlan:
    """A model object without ``fused_decode_plan``: the tiny llama's
    forward, cache and state, nothing else."""

    def __init__(self, model):
        self._m = model
        self.device = model.device
        self.cfg = model.cfg

    def __call__(self, *a, **kw):
        return self._m(*a, **kw)

    def init_cache(self, *a, **kw):
        return self._m.init_cache(*a, **kw)

    def state_dict(self, **kw):
        return self._m.state_dict(**kw)


def test_generate_without_a_plan_takes_the_layered_path():
    """The reference guards the plan call with hasattr: a model without
    ``fused_decode_plan`` decodes through its cache forward, and its tokens
    equal the fused path's on the same weights (fp32 weights; an fp32 and a
    bf16 cache round apart only in the last bits)."""
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    ids = _ids(8)
    fused = tgenerate(m, ids, max_new_tokens=NEW)
    layered = tgenerate(_NoPlan(m), ids, max_new_tokens=NEW)
    assert not hasattr(_NoPlan(m), "fused_decode_plan")
    assert layered.tolist() == fused.tolist()
    tset_flags({"FLAGS_fused_decode": False})
    try:
        off = tgenerate(m, ids, max_new_tokens=NEW)
    finally:
        tset_flags({"FLAGS_fused_decode": True})
    assert layered.tolist() == off.tolist()


def test_gpt_generate_runs_on_cpu_with_counters_at_zero():
    """A bf16 GPT generates on CPU tensors through the fused plain step:
    no kernel counts a launch."""
    m = GPTPretrainModel(GPTConfig.tiny(vocab_size=256),
                         dtype=torch.bfloat16, device="cpu", seed=0)
    m.eval()
    for c in (tfd.fused_decode_cuda, tfa.flash_attention_fwd):
        c.launches = 0
    out = tgenerate(m, _ids(9), max_new_tokens=4, temperature=0.7, top_k=10)
    assert tuple(out.shape) == (B, PROMPT + 4)
    assert tfd.fused_decode_cuda.launches == 0
    assert tfa.flash_attention_fwd.launches == 0
