"""MoE layer and Mixtral model of paddle_tpu_torch against paddle_tpu, on the CPU.

The JAX modules' weights are carried into the port with
``utils.convert.load_jax_state`` (same state keys); inputs come from numpy
seeds. Each test states its tolerance.

* ``topk_routing``: ids, renormalised weights, queue positions, keep and
  the aux loss equal the JAX function's (fp32 at 1e-6), with a capacity
  that drops copies and with exact ties between experts.
* ``MoELayer`` (scatter dispatch) output and aux against the JAX layer,
  fp32 at 1e-5, with and without drops.
* ``MixtralForCausalLM``: forward logits and weighted aux, and the cache
  forward (prefill + one decode step), fp32 at 1e-5, on ``tiny()`` and on
  a tiny config with shared experts.
* The dispatch mode the port does not take (alltoall) and an unknown one
  raise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from paddle_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from paddle_tpu.nn.layers.moe import MoELayer as JMoELayer
from paddle_tpu.nn.layers.moe import topk_routing as jtopk_routing
from paddle_tpu_torch.inference import prefill as tprefill
from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from paddle_tpu_torch.nn.layers.moe import MoELayer, topk_routing
from paddle_tpu_torch.utils.convert import load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(layer):
    return {k: np.asarray(v)
            for k, v in layer.state_dict(include_buffers=False).items()}


@pytest.mark.parametrize("k,cap,tie", [(2, 64, False), (2, 3, False),
                                       (3, 5, True), (1, 2, True)])
def test_topk_routing_matches_jax(k, cap, tie):
    """Equal ids, positions and keep; weights, aux and stats at 1e-6. The
    small capacities drop copies (choice 0 of every token claims its slot
    first); `tie` makes experts 1 and 3 (and 0 and 2) exactly equal."""
    r = np.random.RandomState(k * 10 + cap)
    logits = r.randn(24, 6).astype(np.float32)
    if tie:
        logits[:, 3] = logits[:, 1]
        logits[::2, 2] = logits[::2, 0]
    ji, jv, jp, jk, ja, js = jtopk_routing(jnp.asarray(logits), k, cap)
    ti, tv, tp, tk, ta, ts = topk_routing(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    for key in js:
        np.testing.assert_allclose(np.asarray(ts[key]), np.asarray(js[key]),
                                   atol=1e-6, err_msg=key)
    if cap < 24:
        assert not bool(tk.all())        # the case drops copies


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_matches_jax(cf):
    """Scatter dispatch output and aux, fp32 at 1e-5 (capacity factor 0.5
    drops copies)."""
    paddle_tpu.seed(0)
    h, f, e = 32, 48, 8
    jl = JMoELayer(h, f, e, top_k=2, capacity_factor=cf)
    tl = MoELayer(h, f, e, top_k=2, capacity_factor=cf, device="cpu")
    missing, unexpected = load_jax_state(tl, _np_state(jl))
    assert not missing and not unexpected
    x = np.random.RandomState(1).randn(2, 12, h).astype(np.float32)
    jy, jaux, jst = jl(jnp.asarray(x), return_stats=True)
    with torch.no_grad():
        ty, taux, tst = tl(torch.from_numpy(x), return_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    np.testing.assert_allclose(float(tst["moe_dropped_fraction"]),
                               float(jst["moe_dropped_fraction"]), atol=1e-6)
    if cf < 1:
        assert float(tst["moe_dropped_fraction"]) > 0


def _tiny_shared():
    return dict(num_experts=8, num_shared_experts=2, num_kv_heads=4)


@pytest.mark.parametrize("extra", [{}, _tiny_shared()],
                         ids=["tiny", "shared"])
def test_mixtral_forward_and_cache_forward(extra):
    """Logits (fp32, atol 1e-5) and the weighted aux (1e-6) of the full
    forward, then the cache forward: prefill logits and one decode step's
    logits (1e-5)."""
    paddle_tpu.seed(0)
    jcfg = dataclasses.replace(JMixtralConfig.tiny(), **extra)
    cfg = dataclasses.replace(MixtralConfig.tiny(), **extra)
    jm = JMixtral(jcfg)
    tm = MixtralForCausalLM(cfg, device="cpu", seed=0)
    js = _np_state(jm)
    assert list(tm.state_dict(include_buffers=False)) == list(js)
    missing, unexpected = load_jax_state(tm, js)
    assert not missing and not unexpected
    b, s = 2, 9
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, (b, s))
    jl, jaux = jm(jnp.asarray(ids))
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    labels = np.roll(ids, -1, axis=1)
    with torch.no_grad():
        tloss = tm.loss((tl, taux), torch.from_numpy(labels))
    jloss = jm.loss((jl, jaux), jnp.asarray(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)

    total = s + 2
    jc = jm.init_cache(b, total, dtype=jnp.float32)
    jo, jc = jm(jnp.asarray(ids), cache=jc, start_pos=0)
    nxt = np.argmax(np.asarray(jo)[:, -1], -1)[:, None]
    jo2, _ = jm(jnp.asarray(nxt), cache=jc, start_pos=s)
    with torch.no_grad():
        to, tc = tprefill(tm, torch.from_numpy(ids), total,
                          cache_dtype=torch.float32)
        to2, _ = tm(torch.from_numpy(nxt), cache=tc, start_pos=s)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), atol=1e-5)


def test_unported_dispatch_modes_raise():
    """What stays refused: alltoall (an expert-parallel mesh, ROADMAP Queue
    A item 10) and an unknown mode. The other modes' parity with the JAX
    layer is in tests/test_torch_moe_train.py."""
    x = torch.zeros(1, 4, 16)
    layer = MoELayer(16, 32, 8, dispatch_mode="alltoall", device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        layer(x)
    with pytest.raises(ValueError, match="unknown"):
        MoELayer(16, 32, 8, dispatch_mode="bogus", device="cpu")
