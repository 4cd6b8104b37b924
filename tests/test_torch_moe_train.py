"""MoE training of paddle_tpu_torch against paddle_tpu, on the CPU.

The JAX modules' weights are carried into the port with
``utils.convert.load_jax_state``; inputs come from numpy seeds. Every
gradient compare first holds the routing equal on both sides and draws
cases whose top-k gap is clear (``MIN_GAP``), so no expert choice can flip
between the frameworks' fp32 sums.

* ``MoELayer``, every one-device dispatch mode (scatter, sort, fused,
  einsum, dropless), gshard top-2 and switch top-1, capacity factors 0.5
  (copies dropped) and 8.0: the loss sum(y²) + aux and the gradients of
  every parameter and of the input equal ``jax.value_and_grad`` of the
  JAX layer, fp32, rtol 1e-4, atol 1e-5 (``tests/test_moe.py:74-95``'s
  tolerance).
* Every port mode equals the port's scatter mode on the same weights
  (dropless where nothing drops), rtol 1e-4, atol 1e-5.
* ``topk_gating``: combine, dispatch and aux equal the JAX function's.
* ``MixtralForCausalLM.loss`` and every gradient, fused dispatch, on
  ``MixtralConfig.tiny()`` and a tiny DeepSeek-style config with shared
  experts: loss atol 1e-5, gradients rtol 1e-4 atol 1e-5.
* Three pure-bf16 AdamW steps of the twin (``paddle_tpu_torch.moe_bench``)
  on the reference's CPU shape give the JAX package's losses within
  ``TWIN_LOSS_ATOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from paddle_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.nn.layers.moe import MoELayer as JMoELayer
from paddle_tpu.nn.layers.moe import topk_gating as jtopk_gating
from paddle_tpu.nn.layers.moe import topk_routing as jtopk_routing
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import moe_bench
from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from paddle_tpu_torch.nn.layers.moe import MoELayer, topk_gating
from paddle_tpu_torch.utils.convert import load_jax_state

RTOL, ATOL = 1e-4, 1e-5
#: the least gap between the k-th and (k+1)-th router probability of any
#: token in a gradient compare: fp32 probabilities of the two frameworks
#: differ by ~1e-7, so a gap of 1e-4 cannot flip
MIN_GAP = 1e-4
#: the twin's losses over 3 pure-bf16 steps against the JAX package's:
#: every activation, logit and update rounds to bf16 (2^-9 relative) on
#: both sides, with products summed in another order. Read on this CPU:
#: differences of 5e-5, 7e-4 and 7e-5 at losses of 6.27, 6.22, 6.16; the
#: loss falls 0.055 a step, so a step without its update is off by 0.05
TWIN_LOSS_ATOL = 5e-3

MODES = ("scatter", "sort", "fused", "einsum", "dropless")
GATES = [("gshard", 0.5), ("gshard", 8.0), ("switch", 0.5), ("switch", 8.0)]


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


def _layer_kw(mode, gate, cf):
    kw = dict(gate=gate, capacity_factor=cf, dropless=mode == "dropless",
              dispatch_mode="scatter" if mode == "dropless" else mode,
              initializer_range=0.05)
    if gate == "gshard":
        kw["top_k"] = 2
    return kw


def _layer_pair(mode, gate, cf, h=32, f=48, e=8):
    """The JAX layer (seed 0, router ×8: decisive routing) and the port's
    on its weights."""
    paddle_tpu.seed(0)
    kw = _layer_kw(mode, gate, cf)
    jl = JMoELayer(h, f, e, **kw)
    jl.gate.proj.weight = jl.gate.proj.weight * 8.0
    tl = MoELayer(h, f, e, device="cpu", **kw)
    missing, unexpected = load_jax_state(tl, _np_state(jl))
    assert not missing and not unexpected
    return jl, tl


def _assert_clear_routing(logits, k, cap):
    """Equal routing on both sides, and a clear top-k gap: the compare
    below is then not at the mercy of a near-tie."""
    from paddle_tpu_torch.nn.layers.moe import topk_routing
    ji, _, jp, jk, _, _ = jtopk_routing(jnp.asarray(logits), k, cap)
    ti, _, tp, tk, _, _ = topk_routing(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    probs = torch.softmax(torch.from_numpy(logits), -1)
    top = torch.topk(probs, k + 1, dim=-1).values
    assert float((top[:, k - 1] - top[:, k]).min()) > MIN_GAP


def _x(seed=3, b=2, s=16, h=32):
    return np.random.RandomState(seed).randn(b, s, h).astype(np.float32)


def _port_loss_grads(tl, x):
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, stats = tl(xt, return_stats=True)
    loss = (y ** 2).sum() + aux
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tl.named_parameters()}
    grads["x"] = xt.grad.numpy()
    return float(loss.detach()), grads, stats


@pytest.mark.parametrize("gate,cf", GATES, ids=[f"{g}-cf{c}" for g, c in GATES])
@pytest.mark.parametrize("mode", MODES)
def test_moe_layer_loss_and_grads_match_jax(mode, gate, cf):
    jl, tl = _layer_pair(mode, gate, cf)
    x = _x()
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ _np_state(jl)["gate.proj.weight"]
    _assert_clear_routing(logits, jl.gate.top_k, jl.gate.capacity(len(xt)))
    st = jl.trainable_state()

    def jloss(s, xj):
        y, aux = functional_call(jl, s, xj)
        return jnp.sum(y ** 2) + aux

    lj, (gj, gxj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        st, jnp.asarray(x))
    lt, gt, stats = _port_loss_grads(tl, x)
    np.testing.assert_allclose(lt, float(lj), rtol=RTOL)
    assert set(gt) == set(gj) | {"x"}
    for n in gj:
        np.testing.assert_allclose(gt[n], np.asarray(gj[n]), rtol=RTOL,
                                   atol=ATOL, err_msg=n)
        assert np.abs(gt[n]).max() > 10 * ATOL, n   # the compare bites
    np.testing.assert_allclose(gt["x"], np.asarray(gxj), rtol=RTOL,
                               atol=ATOL)
    if mode == "einsum":
        assert stats is None
    elif mode == "dropless":
        assert float(stats["moe_dropped_fraction"]) == 0.0
    elif cf < 1:
        assert float(stats["moe_dropped_fraction"]) > 0   # copies dropped


CASES = [(m, g, c) for m in MODES[1:] for g, c in GATES
         if m != "dropless" or c > 1]


@pytest.mark.parametrize("mode,gate,cf", CASES,
                         ids=[f"{m}-{g}-cf{c}" for m, g, c in CASES])
def test_port_modes_equal_port_scatter(mode, gate, cf):
    """Each mode computes the scatter mode's function, forward and
    backward (dropless only where nothing drops)."""
    torch.manual_seed(0)
    kw = _layer_kw("scatter", gate, cf)
    ref = MoELayer(32, 48, 8, device="cpu", **kw)
    alt = MoELayer(32, 48, 8, device="cpu", **_layer_kw(mode, gate, cf))
    alt.load_state_dict(ref.state_dict())
    x = _x(seed=5)
    l1, g1, s1 = _port_loss_grads(ref, x)
    l2, g2, _ = _port_loss_grads(alt, x)
    np.testing.assert_allclose(l2, l1, rtol=RTOL)
    for n in g1:
        np.testing.assert_allclose(g2[n], g1[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    if mode == "dropless":
        assert float(s1["moe_dropped_fraction"]) == 0.0


@pytest.mark.parametrize("k,cap", [(2, 64), (2, 3), (1, 2)])
def test_topk_gating_matches_jax(k, cap):
    """Combine (fp32, 1e-6), dispatch (equal) and aux (1e-6); the small
    capacities drop copies, which then have no one-hot row."""
    logits = np.random.RandomState(k + cap).randn(24, 6).astype(np.float32)
    jc, jd, ja = jtopk_gating(jnp.asarray(logits), k, cap)
    tc, td, ta = topk_gating(torch.from_numpy(logits), k, cap)
    assert tuple(tc.shape) == (24, 6, cap)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    if cap < 24:
        assert int(td.sum()) < 24 * k


def _tiny_shared():
    return dict(num_experts=8, num_shared_experts=2, num_kv_heads=4)


@pytest.mark.parametrize("extra", [{}, _tiny_shared()],
                         ids=["tiny", "shared"])
def test_mixtral_loss_and_grads_match_jax(extra):
    """Fused dispatch, router ×8; every layer's routing has a clear top-k
    gap (checked on the port's router logits)."""
    extra = dict(extra, moe_dispatch="fused")
    paddle_tpu.seed(0)
    jm = JMixtral(dataclasses.replace(JMixtralConfig.tiny(), **extra))
    for layer in jm.model.layers:
        layer.moe.gate.proj.weight = layer.moe.gate.proj.weight * 8.0
    cfg = dataclasses.replace(MixtralConfig.tiny(), **extra)
    tm = MixtralForCausalLM(cfg, device="cpu", seed=0)
    missing, unexpected = load_jax_state(tm, _np_state(jm))
    assert not missing and not unexpected
    # seed 4: every layer's top-k gap at least 2e-3 in both configs
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 9))
    labels = np.roll(ids, -1, axis=1)
    st = jm.trainable_state()
    lj, gj = jax.value_and_grad(lambda s: jm.loss(
        functional_call(jm, s, jnp.asarray(ids)), jnp.asarray(labels)))(st)

    gaps = []
    hooks = [layer.moe.gate.proj.register_forward_hook(
        lambda mod, inp, out, k=layer.moe.gate.top_k: gaps.append(float(
            (lambda top: (top[:, k - 1] - top[:, k]).min())(
                torch.topk(torch.softmax(out, -1), k + 1, -1).values))))
        for layer in tm.model.layers]
    loss = tm.loss(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
    for hk in hooks:
        hk.remove()
    assert len(gaps) == cfg.num_layers and min(gaps) > MIN_GAP
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), atol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(gj)
    for n in gj:
        np.testing.assert_allclose(grads[n].numpy(), np.asarray(gj[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    gate = grads["model.layers.0.moe.gate.proj.weight"]
    assert float(gate.abs().max()) > 10 * ATOL   # the router learns


def test_twin_train_steps_match_jax():
    """The twin's CPU shape (2 layers, h 128, ffn 256, S 128, B 4, vocab
    512, 8 experts, fused, capacity factor 1.0), bf16: three train_step
    calls against the reference's one_step (value_and_grad + AdamW
    update), same weights and batch."""
    cfg = moe_bench.config(2, 8, 128, 256, 128, 1.0, "fused", on_card=False)
    paddle_tpu.seed(0)
    jnames = {f.name for f in dataclasses.fields(JMixtralConfig)}
    jcfg = JMixtralConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)
                             if f.name in jnames})
    jm = JMixtral(jcfg).bfloat16()
    model, opt, x, y = moe_bench.build(cfg, 4, 128, "cpu")
    missing, unexpected = load_jax_state(model, _np_state(jm))
    assert not missing and not unexpected
    assert model.num_params() == jm.num_params()
    jopt = JAdamW(learning_rate=1e-4, multi_precision=False)
    state = jm.trainable_state()
    opt_state = jopt.init_state(state)
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    @jax.jit
    def one_step(state, opt_state):
        loss, grads = jax.value_and_grad(
            lambda s: jm.loss(functional_call(jm, s, xj), yj))(state)
        state, opt_state = jopt.update(grads, opt_state, state)
        return state, opt_state, loss

    jl, tl = [], []
    for _ in range(3):
        state, opt_state, loss = one_step(state, opt_state)
        jl.append(float(loss))
        tl.append(float(moe_bench.train_step(model, opt, x, y)))
    np.testing.assert_allclose(tl, jl, atol=TWIN_LOSS_ATOL)
    assert tl[-1] < tl[0]


def test_twin_cpu_record():
    """python -m paddle_tpu_torch.moe_bench --device cpu: the reference's
    CPU shape, one JSON record with the activated-basis fields and no
    device numbers; dropless counts its host reads (one a layer a step)."""
    rec = moe_bench.main(["--device", "cpu", "--dispatch", "dropless"])
    cfg = moe_bench.config(2, 8, 128, 256, 128, on_card=False)
    assert rec["mfu_basis"] == "activated" and rec["mfu"] is None
    assert rec["params_activated"] == moe_bench.activated_params(
        cfg, rec["params"]) < rec["params"]
    assert rec["host_reads_per_step"] == 2.0
    assert rec["step_time_ms"] is None and np.isfinite(rec["final_loss"])
    with pytest.raises(NotImplementedError, match="item 10"):
        moe_bench.main(["--device", "cpu", "--dispatch", "alltoall"])
