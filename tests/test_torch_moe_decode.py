"""The MoE decode step and MoE generation of paddle_tpu_torch against
paddle_tpu, on the CPU.

* ``build_fused_params_moe``: the same stacks, bit for bit.
* ``fused_decode_reference(arch="moe")`` (the plain version a CPU tensor
  runs) against the JAX reference in fp32, MHA and GQA, with and without
  shared experts, k=2 and k=4 over E=16: x_out and the cache at atol 2e-5
  (sums in another order), and the port's routing ids against the ids the
  JAX router math gives.
* The same against the TPU kernel itself in bf16, run as the JAX
  package's own tests run it on the CPU (``_fused_decode_moe_pallas(...,
  interpret=True)``, ``tests/test_fused_decode.py:415``), with the gate
  scaled ×8 so that no expert choice sits on a bf16 near-tie: atol 5e-2,
  rtol 2^-6 (bf16 intermediates rounded on either side of a boundary, as
  the JAX test allows).
* ``generate`` on a tiny Mixtral (fp32 weights, gate ×8 — the JAX tests'
  decisive routing): greedy and sampled tokens equal the JAX ``generate``
  on the fused path (bf16 cache, b <= max_batch) and on the layered path
  (b > max_batch).
* ``utils.convert`` carries the whole state across, every key matched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.inference import generate as jgenerate
from paddle_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from paddle_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu.ops.rope import rope_cos_sin as jrope
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.ops.rope import rope_cos_sin as trope
from paddle_tpu_torch.utils.convert import jax_state_to_torch, load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(L, h, nh, nkv, hd, E, f, fs, seed=0, gate_scale=1.0):
    r = np.random.RandomState(seed)
    w = lambda *s, sc=0.05: (r.randn(*s) * sc).astype(np.float32)
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + w(L, h, sc=0.1), "wqkv": w(L, h, dq + 2 * dkv),
         "wo": w(L, dq, h), "ln2": 1 + w(L, h, sc=0.1),
         "gate": w(L, E, h) * gate_scale, "weg": w(L, E, h, f),
         "weu": w(L, E, h, f), "wed": w(L, E, f, h)}
    if fs:
        p.update(wsg=w(L, h, fs), wsu=w(L, h, fs), wsd=w(L, fs, h))
    return p


def _jax_ids(params, x, kv, pos, cos, sin, nh, nkv, k):
    """The top-k ids of the JAX router math at every layer, from the JAX
    reference run one layer at a time."""
    L = params["ln1"].shape[0]
    out = []
    xl = x
    for l in range(L):
        pl = {n: v[l:l + 1] for n, v in params.items()}
        kvl = kv[l:l + 1]
        xn = jfd._rms(_attn_only(xl, pl, kvl, pos, cos, sin, nh, nkv),
                      pl["ln2"][0], 1e-5)
        logits = jnp.dot(xn.astype(jnp.float32), pl["gate"][0].T)
        out.append(np.asarray(jax.lax.top_k(jax.nn.softmax(logits), k)[1]))
        xl, _ = jfd.fused_decode_reference(
            xl, pl, kvl, pos, cos, sin, num_heads=nh, num_kv_heads=nkv,
            arch="moe", top_k=k)
    return np.stack(out)


def _attn_only(x, pl, kv, pos, cos, sin, nh, nkv):
    """x after the attention half of a one-layer stack: the MoE step with
    zeroed expert and shared weights adds nothing after the attention."""
    z = {n: (v * 0.0 if n in ("weg", "weu", "wed", "wsg", "wsu", "wsd")
             else v) for n, v in pl.items()}
    xa, _ = jfd.fused_decode_reference(x, z, kv, pos, cos, sin,
                                       num_heads=nh, num_kv_heads=nkv,
                                       arch="moe", top_k=1)
    return xa.astype(jnp.float32)


@pytest.mark.parametrize("nkv,k,fs", [(4, 2, 0), (2, 4, 0), (4, 4, 96),
                                      (2, 2, 96)],
                         ids=["mha-k2", "gqa-k4", "mha-k4-shared",
                              "gqa-k2-shared"])
def test_reference_matches_jax_reference_fp32(nkv, k, fs):
    L, b, S, nh, hd, h, E, f, pos = 2, 3, 16, 4, 16, 64, 16, 48, 9
    p = _params(L, h, nh, nkv, hd, E, f, fs, seed=k + nkv + fs)
    r = np.random.RandomState(7)
    x = r.randn(b, h).astype(np.float32)
    kv = r.randn(L, b, S, 2 * nkv * hd).astype(np.float32)
    kv[:, :, pos:] = 0.0
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch="moe",
              top_k=k)
    cj, sj = jrope(S, hd)
    pj = {n: jnp.asarray(v) for n, v in p.items()}
    xj, kvj = jfd.fused_decode_reference(
        jnp.asarray(x), pj, jnp.asarray(kv), pos, cj[pos:pos + 1],
        sj[pos:pos + 1], **kw)
    ct, st = trope(S, hd)
    routing = {}
    xt, kvt = tfd.fused_decode_reference(
        torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
        torch.from_numpy(kv.copy()), pos, ct[pos:pos + 1], st[pos:pos + 1],
        routing=routing, **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(kvt.numpy(), np.asarray(kvj), atol=2e-5,
                               rtol=1e-5)
    assert tuple(routing["ids"].shape) == (L, b, k)
    ids_j = _jax_ids(pj, jnp.asarray(x), jnp.asarray(kv), pos,
                     cj[pos:pos + 1], sj[pos:pos + 1], nh, nkv, k)
    np.testing.assert_array_equal(routing["ids"].numpy(), ids_j)
    np.testing.assert_allclose(routing["w"].sum(-1).numpy(), 1.0, atol=1e-6)
    assert bool((routing["gap"] >= 0).all())
    assert tfd.fused_decode_moe_cuda.launches == 0


@pytest.mark.parametrize("fs", [0, 512], ids=["routed", "shared"])
def test_reference_matches_interpret_kernel_bf16(fs):
    """The TPU kernel in interpret mode vs the port's plain version."""
    L, b, S, nh, nkv, hd, h, E, f, k = 2, 2, 256, 4, 2, 64, 256, 8, 256, 2
    p = _params(L, h, nh, nkv, hd, E, f, fs, seed=3, gate_scale=8.0)
    r = np.random.RandomState(4)
    x = r.randn(b, h).astype(np.float32)
    kv = (r.randn(L, b, S, 2 * nkv * hd) * 0.05).astype(np.float32)
    pos = 77
    kv[:, :, pos:] = 0.0
    pj = {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()}
    kv_j = jnp.asarray(kv, jnp.bfloat16)
    xj, kvj = jax.jit(lambda x, p, c: jfd._fused_decode_moe_pallas(
        x, p, c, pos, num_heads=nh, num_kv_heads=nkv, head_dim=hd,
        top_k=k, eps=1e-5, interpret=True))(jnp.asarray(x, jnp.bfloat16),
                                            pj, kv_j)
    to_t = lambda a: torch.from_numpy(
        np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    ct, st = trope(S, hd)
    xt, kvt = tfd.fused_decode_step(
        to_t(jnp.asarray(x, jnp.bfloat16)), {n: to_t(v) for n, v in
                                             pj.items()},
        to_t(kv_j), pos, ct[pos:pos + 1], st[pos:pos + 1], num_heads=nh,
        num_kv_heads=nkv, eps=1e-5, arch="moe", top_k=k)
    np.testing.assert_allclose(xt.float().numpy(), np.asarray(xj, np.float32),
                               atol=5e-2, rtol=2 ** -6)
    np.testing.assert_allclose(kvt[:, :, pos].float().numpy(),
                               np.asarray(kvj, np.float32)[:, :, pos],
                               atol=5e-2, rtol=2 ** -6)
    assert torch.equal(kvt[:, :, :pos], to_t(kv_j)[:, :, :pos])


def _tiny_pair(shared=0):
    """A tiny Mixtral (E=8, so the fused plan is eligible) on both sides,
    fp32 weights, the router ×8 (decisive routing, as the JAX tests)."""
    extra = dict(num_experts=8, top_k=2, num_shared_experts=shared)
    paddle_tpu.seed(0)
    jm = JMixtral(dataclasses.replace(JMixtralConfig.tiny(), **extra))
    for layer in jm.model.layers:
        layer.moe.gate.proj.weight = layer.moe.gate.proj.weight * 8.0
    cfg = dataclasses.replace(MixtralConfig.tiny(), **extra)
    tm = MixtralForCausalLM(cfg, device="cpu", seed=0)
    missing, unexpected = load_jax_state(
        tm, {n: np.asarray(v)
             for n, v in jm.state_dict(include_buffers=False).items()})
    assert not missing and not unexpected
    return cfg, jm, tm


@pytest.fixture(scope="module")
def tiny_pair():
    return _tiny_pair(shared=2)


@pytest.mark.parametrize("b", [3, 5], ids=["fused", "layered"])
@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)],
    ids=["greedy", "sampled"])
def test_generate_tokens_equal_jax(tiny_pair, monkeypatch, b, kw):
    """b=3 <= max_batch (4) decodes on the fused path (bf16 cache, the
    plain MoE step on the CPU), b=5 on the layered path: both sides
    agree on the path, and the tokens are identical."""
    cfg, jm, tm = tiny_pair
    plan = tm.fused_decode_plan(tm.state_dict(include_buffers=False),
                                probe=True)
    assert plan["max_batch"] == 4 and plan["arch"] == "moe"
    steps = []
    real = tfd.fused_decode_step
    monkeypatch.setattr(tfd, "fused_decode_step", lambda *a, **k: (
        steps.append(k["arch"]), real(*a, **k))[1])
    ids = np.random.RandomState(b).randint(0, cfg.vocab_size, (b, 6))
    new = 5
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=new,
                              cache_dtype=jnp.bfloat16, **kw))
    ot = tgenerate(tm, ids, max_new_tokens=new, cache_dtype=torch.bfloat16,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()
    assert steps == (["moe"] * (new - 1) if b <= 4 else [])
    assert tfd.fused_decode_moe_cuda.launches == 0


def test_convert_and_stacks_match(tiny_pair):
    """Every key of the JAX state lands in the port (strict load), and
    build_fused_params_moe gives the JAX stacks bit for bit."""
    cfg, jm, tm = tiny_pair
    js = {n: np.asarray(v)
          for n, v in jm.state_dict(include_buffers=False).items()}
    assert set(tm.state_dict(include_buffers=False)) == set(js)
    missing, unexpected = load_jax_state(tm, js)
    assert not missing and not unexpected
    pj = jfd.build_fused_params_moe({n: jnp.asarray(v) for n, v in
                                     js.items()}, cfg.num_layers)
    pt = tfd.build_fused_params_moe(jax_state_to_torch(js), cfg.num_layers)
    assert set(pj) == set(pt) and {"wsg", "wsu", "wsd"} <= set(pt)
    for n in pj:
        assert np.array_equal(pt[n].numpy(), np.asarray(pj[n])), n
