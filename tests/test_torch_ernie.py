"""ERNIE 3.0 of paddle_tpu_torch against paddle_tpu, on the CPU.

Both packages build ``ErnieConfig.tiny()`` (2 shared + 1 task layers,
hidden 64, 4 heads, vocab 256) in fp32; the JAX model's weights are carried
into the port with ``utils.convert.load_jax_state``. Inputs are made with
numpy from a seed. On the CPU the JAX side takes its XLA attention path and
``jax.value_and_grad``; the port its plain attention through the
``FlashAttention`` Function (the dense padding mask included). Tolerances as
``tests/test_torch_llama_train.py``'s: fp32 outputs and losses at atol
1e-6 (logits 1e-5), gradients at atol 1e-5; the SGD updates of the
reference's ``SGD.update`` at atol 1e-6 in fp32 and bit for bit in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu.models.ernie import ErnieModel as JErnieModel
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu_torch import scale_report
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     ErnieModel)
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.utils.convert import array_to_tensor, load_jax_state

B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jm, tm):
    missing, unexpected = load_jax_state(
        tm, {k: np.asarray(v)
             for k, v in jm.state_dict(include_buffers=False).items()})
    assert not missing and not unexpected
    return tm


def _pair():
    paddle_tpu.seed(0)
    jm = JErnie(JErnieConfig.tiny())
    return jm, _carry(jm, ErnieForPretraining(ErnieConfig.tiny(),
                                              device="cpu", seed=0))


def _ids(seed=0, b=B, s=S, vocab=256):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s + 1))
    return ids[:, :-1], ids[:, 1:].copy()


@pytest.mark.parametrize("branch", ["nlu", "nlg"])
def test_both_branches_logits_match_jax(branch):
    jm, tm = _pair()
    x, _ = _ids(1)
    types = np.random.RandomState(2).randint(0, 4, x.shape)
    lj = jm(jnp.asarray(x), jnp.asarray(types), branch=branch)
    with torch.no_grad():
        lt = tm(torch.from_numpy(x), torch.from_numpy(types), branch=branch)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    assert tm.num_params() == jm.num_params()


def test_nlu_loss_and_every_gradient_match_jax():
    """The Engine step's loss, model.loss(model(x), y) with ignored labels,
    and the gradient of every parameter against jax.value_and_grad; the
    parameters the NLU step does not reach (the NLG layers, the token
    types) get no gradient in the port and zeros in the reference."""
    jm, tm = _pair()
    x, y = _ids(3)
    y[0, 4] = y[1, 9] = -100
    state = jm.trainable_state()

    def f(st):
        return jm.loss(functional_call(jm, st, jnp.asarray(x)),
                       jnp.asarray(y))
    loss_j, grads_j = jax.value_and_grad(f)(state)
    loss_t = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    for k, p in tm.named_parameters():
        g = np.asarray(grads_j[k])
        if p.grad is None:
            assert not g.any(), k
            assert k.startswith(("nlg_layers.", "ernie.type_emb")), k
        else:
            np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_backbone_with_a_padding_mask_matches_jax(kind):
    """ErnieModel under a (b, 1, 1, s) padding mask, bool or PaddleNLP's
    additive −1e4, with token types: the output and the gradients of
    sum(out · w), w fixed random weights, against the reference."""
    cfg = JErnieConfig.tiny()
    paddle_tpu.seed(1)
    jm = JErnieModel(cfg)
    tm = _carry(jm, ErnieModel(ErnieConfig.tiny(), device="cpu", seed=1))
    x, _ = _ids(4)
    types = np.random.RandomState(5).randint(0, 4, x.shape)
    lens = np.array([S, 9])
    keep = np.arange(S)[None, :] < lens[:, None]
    mask = (keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(
        np.float32))[:, None, None, :]
    state = jm.trainable_state()
    w = np.random.RandomState(6).randn(B, S, cfg.hidden_size).astype(
        np.float32) / np.sqrt(B * S)

    def f(st):
        out = functional_call(jm, st, jnp.asarray(x), jnp.asarray(types),
                              jnp.asarray(mask))
        return jnp.sum(out * w), out
    (_, out_j), grads_j = jax.value_and_grad(f, has_aux=True)(state)
    out_t = tm(torch.from_numpy(x), torch.from_numpy(types),
               torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    (out_t * torch.from_numpy(w)).sum().backward()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads_j[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["bf16_masters", "fp32", "pure_bf16"])
def test_three_sgd_steps_match_the_reference(mode):
    """Three steps of SGD(0.1, weight_decay 0.01, biases excluded) on random
    parameters and gradients: new parameters (and fp32 masters) against
    the reference's SGD.update; fp32 at atol 1e-6, bf16 bit for bit."""
    r = np.random.RandomState(7)
    shapes = {"a.weight": (5, 6), "a.bias": (6,), "b.weight": (7,)}
    bf16 = mode != "fp32"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jp = {k: jnp.asarray(r.randn(*s).astype(np.float32)).astype(jdt)
          for k, s in shapes.items()}
    tp = {k: array_to_tensor(np.asarray(v)) for k, v in jp.items()}
    kw = dict(learning_rate=0.1, weight_decay=0.01,
              multi_precision=mode != "pure_bf16",
              apply_decay_param_fun=lambda n: not n.endswith("bias"))
    jopt, topt = JSGD(**kw), SGD(**kw)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    assert set(ts) == set(js)
    for _ in range(3):
        g = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jp, js = jopt.update({k: jnp.asarray(v).astype(jdt)
                              for k, v in g.items()}, js, jp)
        tp, ts = topt.update({k: array_to_tensor(np.asarray(
            jnp.asarray(v).astype(jdt))) for k, v in g.items()}, ts, tp)
    for k in shapes:
        got = tp[k].float().numpy()
        want = np.asarray(jp[k]).astype(np.float32)
        if bf16:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=k)
        if "master" in js:
            np.testing.assert_allclose(ts["master"][k].numpy(),
                                       np.asarray(js["master"][k]),
                                       atol=1e-6, err_msg=k)
    assert ts["step"] == int(js["step"]) == 3


def test_sgd_refuses_regularizer_objects():
    from paddle_tpu_torch.optimizer import SGD as TSGD

    class L1Decay:
        coeff = 0.01
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        TSGD(learning_rate=0.1, weight_decay=L1Decay())


def test_twin_step_matches_a_jax_loop():
    """scale_report's step (the Engine.fit step: the NLU forward, the loss,
    the gradients, SGD) on ErnieConfig.tiny() at its 1 + 1 cut in fp32,
    three steps, against a JAX loop of value_and_grad and SGD.update over
    the reference's model at the same weights: every loss at atol 1e-6 and
    every parameter after the last step at atol 1e-6."""
    cfg_t = scale_report.config(tiny=True, seq=S)
    jcfg = JErnieConfig.tiny()
    jcfg.num_hidden_layers = jcfg.num_task_layers = 1
    jcfg.max_position_embeddings = cfg_t.max_position_embeddings
    paddle_tpu.seed(0)
    jm = JErnie(jcfg)
    tm, topt, tstate = scale_report.build(cfg_t, "cpu", dtype=torch.float32)
    _carry(jm, tm)
    x, y = scale_report.batch(cfg_t, B, S, "cpu")
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jopt = JSGD(learning_rate=1e-4)
    state = jm.trainable_state()
    jstate = jopt.init_state(state)
    step = jax.jit(jax.value_and_grad(
        lambda st: jm.loss(functional_call(jm, st, jx), jy)))
    for _ in range(3):
        loss_j, grads = step(state)
        state, jstate = jopt.update(grads, jstate, state)
        loss_t, trained = scale_report.train_step(tm, topt, tstate, x, y)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    assert trained == sum(int(np.prod(v.shape)) for k, v in state.items()
                          if not k.startswith(("nlg_layers.",
                                               "ernie.type_emb")))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(state[k]),
                                   atol=1e-6, err_msg=k)


def test_twin_refuses_the_aot_subcommands(capsys):
    assert scale_report.main(["7b"]) != 0
    assert "no counterpart" in capsys.readouterr().err
