"""paddle_tpu_torch.quantization against paddle_tpu.quantization, on the CPU.

* ``quantize_weight_int8``: the same int8 values and fp32 scales, bit for
  bit, from the same numpy weights (fp32 and bf16).
* ``quantize_model`` of a tiny Llama with the JAX model's fp32 weights: the
  same state keys (``…weight_q``, ``…weight_scale``; embeddings kept) and
  values, bit for bit; a quantized JAX state loads into a quantized port
  model with strict key matching; the dequantized ``weight`` property
  equals the JAX one bit for bit; the forward logits agree (atol 1e-5,
  fp32 sums in another order).
* ``weight_only_linear``: within fp32 rounding of the JAX function (atol
  1e-5; the weight and scale round to x's dtype before their product in
  both).
* The int8 tensors are non-trainable parameters, so the state ``generate``
  binds carries them, and a second ``quantize_model`` is a no-op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.quantization import quantize_model as jquantize_model
from paddle_tpu.quantization import quantize_weight_int8 as jquantize_weight
from paddle_tpu.quantization import weight_only_linear as jwol
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization import (quantize_model,
                                           quantize_weight_int8,
                                           quantized_state,
                                           weight_only_linear)
from paddle_tpu_torch.utils.convert import array_to_tensor, load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(16, 8), (3, 12, 20)])
def test_quantize_weight_int8_equal(dtype, shape):
    w = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    w[..., 1] = 0.0                     # a zero column: the 1e-8 floor
    wj = jnp.asarray(w, dtype)
    qj, sj = jquantize_weight(wj)
    qt, st = quantize_weight_int8(array_to_tensor(np.asarray(wj)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == (shape[-1],)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


def test_weight_only_linear_matches_jax():
    r = np.random.RandomState(1)
    x = r.randn(4, 16).astype(np.float32)
    w = r.randn(16, 8).astype(np.float32)
    b = r.randn(8).astype(np.float32)
    qj, sj = jquantize_weight(jnp.asarray(w))
    yj = jwol(jnp.asarray(x), qj, sj, jnp.asarray(b))
    qt, st = quantize_weight_int8(torch.from_numpy(w))
    yt = weight_only_linear(torch.from_numpy(x), qt, st, torch.from_numpy(b))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    paddle_tpu.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    jquantize_model(jm)
    quantize_model(tm)
    return jm, tm


def test_quantized_state_equal(pair):
    jm, tm = pair
    sj = {k: np.asarray(v) for k, v in
          jm.state_dict(include_buffers=False).items()}
    st = tm.state_dict(include_buffers=False)
    assert list(st) == list(sj)
    assert "model.layers.0.self_attn.q_proj.weight_q" in st
    assert "lm_head.weight_scale" in st
    assert "model.embed_tokens.weight" in st       # embeddings kept
    assert not any(k.endswith(".weight") and "proj" in k for k in st)
    for k, v in sj.items():
        assert st[k].dtype == array_to_tensor(v).dtype, k
        assert np.array_equal(st[k].numpy(), v), k
    assert set(quantized_state(tm)) == set(st)


def test_quantized_layers_and_logits_match_jax(pair):
    jm, tm = pair
    jq = jm.model.layers[0].mlp.up_proj
    tq = tm.model.layers[0].mlp.up_proj
    assert type(tq).__name__ == type(jq).__name__ == "Int8ColumnParallelLinear"
    assert tq.weight.dtype == torch.bfloat16
    assert np.array_equal(tq.weight.view(torch.int16).numpy(),
                          np.asarray(jq.weight).view(np.int16))
    ids = np.random.RandomState(0).randint(0, 256, (2, 10))
    lj = np.asarray(functional_call(jm, jm.state_dict(include_buffers=False),
                                    jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-5)


def test_quantized_jax_state_loads_strictly(pair):
    jm, _ = pair
    fresh = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    quantize_model(fresh)
    load_jax_state(fresh, {k: np.asarray(v) for k, v in
                           jm.state_dict(include_buffers=False).items()})
    for k, v in jm.state_dict(include_buffers=False).items():
        assert np.array_equal(fresh.state_dict(include_buffers=False)[k]
                              .numpy(), np.asarray(v)), k


def test_int8_parameters_are_bound_not_trained(pair):
    """As the reference's Parameter(q, trainable=False): the int8 tensors
    are parameters that generate's state carries and no optimizer sees."""
    _, tm = pair
    params = dict(tm.named_parameters())
    q = params["model.layers.1.self_attn.o_proj.weight_q"]
    assert q.dtype == torch.int8 and not q.requires_grad
    assert not any(k.endswith(("weight_q", "weight_scale"))
                   for k in tm.trainable_state())
    assert dict(tm.named_buffers()) == {}


def test_quantize_plain_layers_and_idempotence():
    paddle_tpu.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(nn.Linear(8, 16, device="cpu"),
                             torch.nn.GELU(), nn.Linear(16, 4, device="cpu"))
    sj = jm.state_dict(include_buffers=False)
    with torch.no_grad():
        for (k, v), t in zip(sorted(sj.items()), [tm[0].bias, tm[0].weight,
                                                  tm[2].bias, tm[2].weight]):
            t.copy_(torch.from_numpy(np.array(v)))
    jquantize_model(jm)
    quantize_model(tm)
    quantize_model(tm)               # a second call changes nothing
    tq = quantized_state(tm)
    assert sum(k.endswith("weight_q") for k in tq) == 2
    assert np.array_equal(tq["0.weight_q"].numpy(),
                          np.asarray(jm.state_dict()["0.weight_q"]))
    assert np.array_equal(tq["2.weight_scale"].numpy(),
                          np.asarray(jm.state_dict()["2.weight_scale"]))
