"""The int8 KV mode of the MoE decode step and MoE ``generate`` over an int8
cache, paddle_tpu_torch against paddle_tpu, on the CPU.

* ``fused_decode_reference(arch="moe", kv_scales=...)`` (the plain version
  a CPU tensor runs) against the JAX reference in fp32, MHA and GQA, with
  and without shared experts: x_out atol 2e-5, rtol 1e-5 (sums in another
  order), the appended int8 rows within one int8 step (round(kv / scale)
  of values a few fp32 ulp apart can land on either side of a .5), the
  rest of the cache equal.
* The same plain step in bf16 against the TPU kernel's int8 KV mode, run
  as the JAX package's own tests run it on the CPU
  (``_fused_decode_moe_pallas(..., kv_scales=..., interpret=True)``,
  ``tests/test_fused_decode.py:389-413``), gate ×8 (decisive routing):
  x_out atol 5e-2, rtol 2^-6, no other row touched; layer by layer, each
  fed the kernel's own input, the appended int8 rows exact, as that test
  holds the kernel to its reference.
* ``generate(cache_dtype=int8)`` on a tiny Mixtral and a tiny
  DeepSeek-style model (shared experts), fp32 weights, router ×8: greedy
  and sampled tokens equal the JAX package's, every decode step on the
  fused MoE step with kv scales; the plan's blocks carry
  ``cache_wbytes``; K6 counts no launch.
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
from paddle_tpu_torch.utils.convert import load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(r, L, h, nh, nkv, hd, E, f, fs, gate_scale=1.0):
    w = lambda *s, sc=0.05: (r.randn(*s) * sc).astype(np.float32)
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + w(L, h, sc=0.1), "wqkv": w(L, h, dq + 2 * dkv),
         "wo": w(L, dq, h), "ln2": 1 + w(L, h, sc=0.1),
         "gate": w(L, E, h) * gate_scale, "weg": w(L, E, h, f),
         "weu": w(L, E, h, f), "wed": w(L, E, f, h)}
    if fs:
        p.update(wsg=w(L, h, fs), wsu=w(L, h, fs), wsd=w(L, fs, h))
    return p


def _int8_cache(r, L, b, S, nkv, hd, pos):
    """An int8 cache filled below `pos` and its (L, 1, 2·nkv·hd) lane
    scales, through the JAX package's quantize_kv_cache."""
    kv = r.randn(L, b, S, 2 * nkv * hd).astype(np.float32)
    kv8, sc = jfd.quantize_kv_cache(jnp.asarray(kv), nkv)
    kv8 = np.asarray(kv8).copy()
    kv8[:, :, pos:] = 0
    return kv8, np.array(sc)


@pytest.mark.parametrize("nkv,k,fs", [(4, 2, 0), (2, 4, 0), (2, 2, 96)],
                         ids=["mha-k2", "gqa-k4", "gqa-k2-shared"])
def test_int8_reference_matches_jax_reference_fp32(nkv, k, fs):
    L, b, S, nh, hd, h, E, f, pos = 2, 3, 16, 4, 16, 64, 16, 48, 9
    r = np.random.RandomState(k + nkv + fs)
    p = _params(r, L, h, nh, nkv, hd, E, f, fs, gate_scale=8.0)
    kv8, sc = _int8_cache(r, L, b, S, nkv, hd, pos)
    x = r.randn(b, h).astype(np.float32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch="moe",
              top_k=k)
    cj, sj = jrope(S, hd)
    xj, kvj = jfd.fused_decode_reference(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
        jnp.asarray(kv8), pos, cj[pos:pos + 1], sj[pos:pos + 1],
        kv_scales=jnp.asarray(sc), **kw)
    ct, st = trope(S, hd)
    xt, kvt = tfd.fused_decode_step(
        torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
        torch.from_numpy(kv8.copy()), pos, ct[pos:pos + 1], st[pos:pos + 1],
        kv_scales=torch.from_numpy(sc), **kw)
    assert kvt.dtype == torch.int8
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    kt, kj = kvt.numpy().astype(np.int32), np.asarray(kvj, np.int32)
    assert np.abs(kt[:, :, pos] - kj[:, :, pos]).max() <= 1
    assert np.array_equal(np.delete(kt, pos, axis=2),
                          np.delete(kj, pos, axis=2))
    assert tfd.fused_decode_moe_cuda.launches == 0


#: the least k-th to (k+1)-th router probability gap of the bf16 kernel
#: compare (seed 7: 1.1e-3 routed, 3.4e-3 shared): bf16 noise in the
#: router's input moves a probability by far less, so no choice flips
BF16_MIN_GAP = 1e-3


@pytest.mark.parametrize("fs", [0, 512], ids=["routed", "shared"])
def test_int8_reference_matches_interpret_kernel_bf16(fs):
    """The TPU kernel's int8 KV mode in interpret mode vs the port's plain
    version, bf16, b=2, L=2: x_out of the stack within atol 5e-2, rtol
    2^-6, no row but the append touched; then layer by layer, each fed the
    kernel's x of the layer before, the appended int8 rows EXACT (over two
    layers, layer 1's appends are quantized from x that already carries
    bf16 flips of the other framework's sums, and land a step or two
    apart)."""
    L, b, S, nh, nkv, hd, h, E, f, k = 2, 2, 256, 4, 2, 64, 256, 8, 256, 2
    r = np.random.RandomState(7)
    p = _params(r, L, h, nh, nkv, hd, E, f, fs, gate_scale=8.0)
    pos = 130
    x = jnp.asarray(r.randn(b, h), jnp.bfloat16)
    kv = jnp.asarray(r.randn(L, b, S, 2 * nkv * hd) * 0.05, jnp.bfloat16)
    kv8, sc = jfd.quantize_kv_cache(kv, nkv)
    kv8 = kv8.at[:, :, pos:].set(0)
    pj = {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()}
    kernel = jax.jit(lambda x, p, c, s: jfd._fused_decode_moe_pallas(
        x, p, c, pos, num_heads=nh, num_kv_heads=nkv, head_dim=hd,
        top_k=k, eps=1e-5, kv_scales=s, blocks={"cache_wbytes": 1},
        interpret=True))
    to_t = lambda a: torch.from_numpy(
        np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    ct, st = trope(S, hd)

    def plain(x, p, c, s, routing=None):
        return tfd.fused_decode_reference(
            to_t(x), {n: to_t(v) for n, v in p.items()},
            torch.from_numpy(np.asarray(c).copy()), pos, ct[pos:pos + 1],
            st[pos:pos + 1], num_heads=nh, num_kv_heads=nkv, eps=1e-5,
            arch="moe", top_k=k, kv_scales=torch.from_numpy(np.array(s)),
            routing=routing)

    xj, kvj = kernel(x, pj, kv8, sc)
    routing = {}
    xt, kvt = plain(x, pj, kv8, sc, routing)
    assert float(routing["gap"].min()) > BF16_MIN_GAP
    np.testing.assert_allclose(xt.float().numpy(), np.asarray(xj, np.float32),
                               atol=5e-2, rtol=2 ** -6)
    kv0 = np.asarray(kv8)
    assert np.array_equal(np.delete(kvt.numpy(), pos, axis=2),
                          np.delete(kv0, pos, axis=2))
    xl = x
    for l in range(L):
        sl = slice(l, l + 1)
        pl = {n: v[sl] for n, v in pj.items()}
        xn, kvl = kernel(xl, pl, kv8[sl], sc[sl])
        _, kvp = plain(xl, pl, kv8[sl], sc[sl])
        assert np.array_equal(kvp.numpy()[:, :, pos],
                              np.asarray(kvl)[:, :, pos]), l
        xl = xn


def _tiny_pair(shared):
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


@pytest.fixture(scope="module", params=[0, 2], ids=["mixtral", "shared"])
def tiny_pair(request):
    return _tiny_pair(request.param)


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)],
    ids=["greedy", "sampled"])
def test_generate_int8_cache_tokens_equal_jax(tiny_pair, monkeypatch, kw):
    """b=3 <= max_batch: the bf16 prefill calibrates, then every decode step
    runs the MoE step over the int8 cache with its scales."""
    cfg, jm, tm = tiny_pair
    plan = tm.fused_decode_plan(tm.state_dict(include_buffers=False),
                                probe=True)
    assert plan["arch"] == "moe" and plan["blocks"]["cache_wbytes"] == 2
    steps = []
    real = tfd.fused_decode_step
    monkeypatch.setattr(tfd, "fused_decode_step", lambda *a, **k: (
        steps.append((k["arch"], a[2].dtype, k["kv_scales"] is not None,
                      k["blocks"]["cache_wbytes"])), real(*a, **k))[1])
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (3, 6))
    new = 5
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=new,
                              cache_dtype=jnp.int8, **kw))
    ot = tgenerate(tm, ids, max_new_tokens=new, cache_dtype=torch.int8,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()
    assert steps == [("moe", torch.int8, True, 1)] * (new - 1)
    assert tfd.fused_decode_moe_cuda.launches == 0
