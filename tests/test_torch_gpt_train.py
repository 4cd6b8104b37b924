"""GPT-2 pretraining of paddle_tpu_torch against paddle_tpu, on the CPU.

Both packages build ``GPTConfig.tiny()`` (2 layers, hidden 128, 4 heads,
vocab 1024); the JAX model's weights are carried into the port with
``utils.convert.load_jax_state`` (the state keys are the same). Batches
and gradients are made with numpy from a seed. On the CPU the JAX side
takes its XLA attention path and ``jax.grad``; the port takes its plain
attention forward and backward through the ``FlashAttention`` Function.
Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainModel as JGPT
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.convert import array_to_tensor, load_jax_state

B, S = 2, 16



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run shares the CPU among several test workers: keep this
    file's torch ops on one thread, so they do not crowd out the other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _pair(bf16=False):
    paddle_tpu.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    if bf16:
        jm = jm.bfloat16()
    tm = GPTPretrainModel(GPTConfig.tiny(), device="cpu", seed=0,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
    missing, unexpected = load_jax_state(
        tm, {k: np.asarray(v)
             for k, v in jm.state_dict(include_buffers=False).items()})
    assert not missing and not unexpected
    return jm, tm


def _batch(seed=0, vocab=1024):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _jax_loss_fn(jm, x, y):
    return lambda state: jm.loss(functional_call(jm, state, jnp.asarray(x)),
                                 jnp.asarray(y))


def test_state_keys_and_sizes_match():
    """The port's state keys, parameter count and trainable set are the
    JAX package's, exactly (load_jax_state in _pair is strict)."""
    jm, tm = _pair()
    js = jm.state_dict(include_buffers=False)
    ts = tm.state_dict(include_buffers=False)
    assert list(ts) == list(js)
    assert tm.num_params() == jm.num_params()
    assert set(tm.trainable_state()) == set(jm.trainable_state())


def test_logits_loss_and_every_gradient_fp32():
    """fp32: logits at atol 1e-5, loss at 1e-6, and the gradient of every
    parameter at atol 1e-5 — the tied wte takes both the embedding's and
    the unembedding's share."""
    jm, tm = _pair()
    x, y = _batch()
    state = jm.trainable_state()
    lj = np.asarray(jax.jit(lambda s: functional_call(
        jm, s, jnp.asarray(x)))(state))
    loss_j, grads_j = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, x, y)))(
        state)
    logits = tm(torch.from_numpy(x))
    loss = tm.loss(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), lj, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-6)
    params = dict(tm.named_parameters())
    assert set(params) == set(grads_j)
    for k, g in grads_j.items():
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=k)


def test_loss_bf16():
    """bf16 weights: the two frameworks round bf16 products and
    activations at other points, so the loss agrees to 2e-2."""
    jm, tm = _pair(bf16=True)
    x, y = _batch(1)
    loss_j = float(jax.jit(_jax_loss_fn(jm, x, y))(jm.trainable_state()))
    loss = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - loss_j) < 2e-2
    assert all(p.grad is not None and p.grad.dtype == torch.bfloat16
               for p in tm.parameters())


def test_cross_entropy_ignore_index_and_gradient():
    """Mean over the tokens whose label is not ignore_index, and the
    gradient (softmax − onehot)/count in the logits dtype (fp32: atol
    1e-6 against jax.grad)."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF
    r = np.random.RandomState(4)
    z = r.randn(7, 11).astype(np.float32) * 3
    lab = r.randint(0, 11, 7)
    lab[[1, 4]] = -100
    lj, gj = jax.value_and_grad(lambda a: JF.cross_entropy(
        a, jnp.asarray(lab)))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    lt = TF.cross_entropy(zt, torch.from_numpy(lab))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gj), atol=1e-6)
    assert not zt.grad[[1, 4]].any()


def _grads_like(state, seed):
    r = np.random.RandomState(seed)
    return {k: (r.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in state.items()}


def test_adamw_update_fp32():
    """One AdamW update on the same numpy grads: new params and both
    moments at atol 1e-6 (the bias corrections are fp32, as in JAX). The
    functional update leaves its inputs untouched; update_ gives the
    bit-equal result in place."""
    jm, tm = _pair()
    pj = jm.trainable_state()
    grads = _grads_like(pj, 5)
    jopt, topt = JAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    new_j, st_j = jax.jit(jopt.update)(
        {k: jnp.asarray(g) for k, g in grads.items()}, jopt.init_state(pj),
        pj)
    pt = tm.trainable_state()
    gt = {k: torch.from_numpy(g) for k, g in grads.items()}
    st0 = topt.init_state(pt)
    new_t, st_t = topt.update(gt, st0, pt)
    assert "master" not in st_t and st_t["step"] == 1
    for k in pj:
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   atol=1e-6, err_msg=k)
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(st_t[slot][k].numpy(),
                                       np.asarray(st_j[slot][k]), atol=1e-6,
                                       err_msg=f"{slot} {k}")
    # the functional update leaves the model's parameters as they were,
    # and the state it was given too, as the reference's pure update does
    np.testing.assert_array_equal(pt["gpt.wte.weight"].detach().numpy(),
                                  np.asarray(pj["gpt.wte.weight"]))
    assert st0["step"] == 0
    assert not any(t.any() for slot in ("moment1", "moment2")
                   for t in st0[slot].values())
    # update_ (the eager path's form) gives the same result in place
    new_i, st_i = topt.update_(gt, st0, pt)
    assert st_i is st0 and st0["step"] == 1
    for k in pt:
        assert torch.equal(new_i[k], new_t[k]), k
        assert torch.equal(st0["moment2"][k], st_t["moment2"][k]), k


def test_adamw_update_bf16_masters():
    """bf16 params: fp32 masters at atol 1e-6; the new bf16 params are the
    masters rounded, so they are bit-equal wherever the masters are."""
    jm, tm = _pair(bf16=True)
    pj = jm.trainable_state()
    grads = _grads_like(pj, 6)
    jopt, topt = JAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    pt = tm.trainable_state()
    # bf16 grads, as backward() gives them for bf16 params, to both sides
    new_t, st_t = topt.update({k: torch.from_numpy(g).bfloat16()
                               for k, g in grads.items()},
                              topt.init_state(pt), pt)
    new_j, st_j = jax.jit(jopt.update)(
        {k: jnp.asarray(g, jnp.bfloat16) for k, g in grads.items()},
        jopt.init_state(pj), pj)
    for k in pj:
        mj = np.asarray(st_j["master"][k])
        mt = st_t["master"][k].numpy()
        np.testing.assert_allclose(mt, mj, atol=1e-6, err_msg=k)
        assert new_t[k].dtype == torch.bfloat16
        same = mt == mj
        np.testing.assert_array_equal(
            new_t[k].float().numpy()[same],
            np.asarray(new_j[k], np.float32)[same], err_msg=k)


def test_five_step_loss_curve_fp32():
    """Five AdamW steps on one fixed batch, JAX (functional_call +
    value_and_grad + update) against the port (backward + step): losses at
    rtol 1e-5. Parameters at atol 10·lr: where a gradient is ~0 in exact
    arithmetic (the k bias: softmax ignores a per-row shift) both sides
    hold fp32 noise of either sign, and Adam moves such an entry by ±lr a
    step whatever its size."""
    lr, steps = 1e-3, 5
    jm, tm = _pair()
    x, y = _batch(2)
    vg = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, x, y)))
    jopt = JAdamW(learning_rate=lr)
    jupdate = jax.jit(jopt.update)
    state = jm.trainable_state()
    ost = jopt.init_state(state)
    losses_j = []
    for _ in range(steps):
        loss, grads = vg(state)
        state, ost = jupdate(grads, ost, state)
        losses_j.append(float(loss))
    topt = AdamW(learning_rate=lr, parameters=tm.parameters())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = []
    for _ in range(steps):
        loss = tm.loss(tm(xt), yt)
        loss.backward()
        topt.step()
        topt.clear_grad()
        losses_t.append(loss.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(state[k]),
                                   atol=10 * lr, err_msg=k)


def test_weights_carry_bf16_bit_for_bit():
    """bf16 weights cross from JAX to the port bit for bit."""
    jm, tm = _pair(bf16=True)
    w = np.asarray(jm.state_dict()["gpt.h.0.fc_in.weight"])
    assert torch.equal(tm.gpt.h[0].fc_in.weight.detach(), array_to_tensor(w))


def test_refusals():
    """GPT generation with a deadline is not ported: it raises
    NotImplementedError naming the ROADMAP item. (GPT decode over a bf16,
    fp32 or int8 cache is ported: its cache forward runs.) Dropout in
    training, once refused, runs: under the same "dropout" key it gives the
    reference's output bit for bit; in eval it is the identity."""
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.nn import functional as TF
    _, tm = _pair()
    x = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        generate(tm, x, max_new_tokens=2, deadline_s=1.0)
    with torch.no_grad():
        logits, cache = tm(x, cache=tm.init_cache(1, 8, torch.float32))
    assert tuple(logits.shape) == (1, 4, tm.cfg.vocab_size)
    assert bool(cache[0]["k"][:, :4].abs().sum() > 0)
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.core import rng as trng
    key = jax.random.PRNGKey(9)
    with jrng.rng_guard(dropout=key):
        ref = JF.dropout(jnp.ones(64), p=0.1, training=True)
    with trng.rng_guard(dropout=torch.from_numpy(
            np.asarray(key).astype(np.int64))):
        got = TF.dropout(torch.ones(64), p=0.1, training=True)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int((got == 0).sum()) < 64
    assert torch.equal(TF.dropout(torch.ones(3), p=0.1, training=False),
                       torch.ones(3))


def test_bench_twin_cpu_record(capsys, monkeypatch):
    """python -m paddle_tpu_torch.bench --device cpu --tiny: one JSON line
    shaped like bench.py's record; a CPU run names the CPU and reports no
    device time and no MFU. (The tiny shape's passes are cut to one step
    here to keep the test short.)"""
    import json

    from paddle_tpu_torch import bench
    tiny = bench.config(tiny=True)
    monkeypatch.setattr(bench, "config", lambda tiny_=False: (*tiny[:3], 1))
    rec = bench.main(["--device", "cpu", "--tiny"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["metric"] == "gpt2-345m tokens/sec/chip"
    assert rec["device"] == "cpu" and rec["mfu"] is None \
        and rec["step_time_ms"] is None
    assert (rec["batch"], rec["seq"], rec["steps"]) == (2, 256, 1)
    assert rec["params"] == 16299520 and np.isfinite(rec["final_loss"])
