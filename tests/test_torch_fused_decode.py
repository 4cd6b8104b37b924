"""paddle_tpu_torch.ops.fused_decode against paddle_tpu.ops.fused_decode.

* build_fused_params: the same stacks, bit for bit, from the same weights.
* fused_decode_reference (the plain version a CPU tensor runs) against the
  JAX reference in fp32, 3 and 12 rows, at positions 0 and 9 of a 16-row
  cache and at the card attention's chunk edges (511, 512, 513, 1024) of a
  1040-row one: atol 2e-5 (sums in another order).
* The same against the TPU kernel itself, run the way the JAX package's
  own tests run it on the CPU (_fused_decode_pallas(..., interpret=True)),
  bf16, one small case (nkv·hd = 128, S = 128). Tolerance: atol 2e-2,
  rtol 2^-6 — one or two bf16 ulp of the output plus the noise of bf16
  intermediates rounded on either side of a boundary; the kernel also
  derives the rope angles in-kernel where the port takes the table row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu.ops.rope import rope_cos_sin as jrope_cos_sin
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.ops.rope import rope_cos_sin as trope_cos_sin
from paddle_tpu_torch.utils.convert import jax_state_to_torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(nkv, dtype=jnp.float32):
    cfg = JLlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                       num_layers=2, num_heads=4, num_kv_heads=nkv,
                       max_position_embeddings=64)
    m = JLlama(cfg)
    if dtype == jnp.bfloat16:
        m = m.bfloat16()
    sd = {k: np.asarray(v) for k, v in
          m.state_dict(include_buffers=False).items()}
    return cfg, sd


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_build_fused_params_equal(dtype):
    cfg, sd = _state(2, dtype)
    pj = jfd.build_fused_params({k: jnp.asarray(v) for k, v in sd.items()},
                                cfg.num_layers)
    pt = tfd.build_fused_params(jax_state_to_torch(sd), cfg.num_layers)
    assert set(pj) == set(pt)
    for k in pj:
        a = np.asarray(pj[k])
        t = pt[k]
        assert tuple(t.shape) == a.shape, k
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), k
        else:
            assert np.array_equal(t.numpy(), a), k
    padded = tfd.build_fused_params(jax_state_to_torch(sd), cfg.num_layers,
                                    ffn_pad=128)
    assert padded["wg"].shape[2] == 128 and padded["wd"].shape[1] == 128
    assert float(padded["wg"][..., 96:].abs().sum()) == 0.0


@pytest.mark.parametrize("nkv", [4, 2])   # MHA, GQA
# 511 … 1024: where the card's split-KV attention changes its work (512-key
# chunks: the last key of a full chunk, one and two past it, two full), over
# a cache of 1040 rows
@pytest.mark.parametrize("pos", [0, 9, 511, 512, 513, 1024])
@pytest.mark.parametrize("b", [3, 12])    # 12: past the kernels' old 8
def test_reference_matches_jax_reference_fp32(nkv, pos, b):
    cfg, sd = _state(nkv)
    L, S = cfg.num_layers, 16 if pos < 16 else 1040
    dkv = nkv * cfg.head_dim
    r = np.random.RandomState(pos + nkv)
    x = r.randn(b, cfg.hidden_size).astype(np.float32)
    kv = r.randn(L, b, S, 2 * dkv).astype(np.float32)
    kv[:, :, pos:] = 0.0
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=nkv, eps=1e-5)
    cj, sj = jrope_cos_sin(S, cfg.head_dim)
    xj, kvj = jfd.fused_decode_reference(
        jnp.asarray(x), jfd.build_fused_params(
            {k: jnp.asarray(v) for k, v in sd.items()}, L),
        jnp.asarray(kv), pos, cj[pos:pos + 1], sj[pos:pos + 1], **kw)
    ct, st = trope_cos_sin(S, cfg.head_dim)
    kvt = torch.from_numpy(kv.copy())
    xt, kvt = tfd.fused_decode_step(
        torch.from_numpy(x), tfd.build_fused_params(jax_state_to_torch(sd), L),
        kvt, pos, ct[pos:pos + 1], st[pos:pos + 1], **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(kvt.numpy(), np.asarray(kvj), atol=2e-5,
                               rtol=1e-5)
    assert tfd.fused_decode_cuda.launches == 0


def test_reference_matches_interpret_kernel_bf16():
    """The TPU kernel in interpret mode vs the port's plain version."""
    L, b, S, nh, nkv, hd, h, ffn = 2, 2, 128, 4, 2, 64, 128, 256
    dq, dkv = nh * hd, nkv * hd
    r = np.random.RandomState(0)
    f = lambda *s, sc=0.05: (r.randn(*s) * sc).astype(np.float32)
    params = {"ln1": 1 + f(L, h, sc=0.1), "wqkv": f(L, h, dq + 2 * dkv),
              "wo": f(L, dq, h), "ln2": 1 + f(L, h, sc=0.1),
              "wg": f(L, h, ffn), "wu": f(L, h, ffn), "wd": f(L, ffn, h)}
    x = f(b, h, sc=1.0)
    kv = f(L, b, S, 2 * dkv, sc=1.0)
    pos = 77
    kv[:, :, pos:] = 0.0
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    kv_j = jnp.asarray(kv, jnp.bfloat16)
    xj, kvj = jax.jit(lambda x, p, c: jfd._fused_decode_pallas(
        x, p, c, pos, num_heads=nh, num_kv_heads=nkv, head_dim=hd, eps=1e-5,
        interpret=True))(jnp.asarray(x, jnp.bfloat16), pj, kv_j)
    to_t = lambda a: torch.from_numpy(
        np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    pt = {k: to_t(v) for k, v in pj.items()}
    ct, st = trope_cos_sin(S, hd)
    xt, kvt = tfd.fused_decode_step(
        to_t(jnp.asarray(x, jnp.bfloat16)), pt, to_t(kv_j), pos,
        ct[pos:pos + 1], st[pos:pos + 1], num_heads=nh, num_kv_heads=nkv,
        eps=1e-5)
    xj32 = np.asarray(xj, np.float32)
    np.testing.assert_allclose(xt.float().numpy(), xj32, atol=2e-2,
                               rtol=2 ** -6)
    np.testing.assert_allclose(kvt[:, :, pos].float().numpy(),
                               np.asarray(kvj, np.float32)[:, :, pos],
                               atol=2e-2, rtol=2 ** -6)
    # the rest of the cache is untouched by both
    assert torch.equal(kvt[:, :, :pos], to_t(kv_j)[:, :, :pos])


def test_dispatch_refuses_unported_modes():
    """Int8 weights on gpt and moe (the reference has no such mode) refuse,
    naming their Queue B row, on the paged decode (row 5) and verify (row
    6) steps too; so do an unknown arch and a plan made for another cache
    width. The int8 KV modes are ported on every step, the MoE step's too
    (row 7): kv_scales over a cache or pool that is not int8 is a
    ValueError."""
    x = torch.zeros(1, 8)
    kv = torch.zeros(1, 1, 4, 8)
    kw = dict(num_heads=1, num_kv_heads=1)
    with pytest.raises(NotImplementedError, match="llama/gpt/moe"):
        tfd.fused_decode_step(x, {}, kv, 0, None, None, arch="rwkv", **kw)
    with pytest.raises(NotImplementedError, match="row 4"):
        tfd.fused_decode_step(x, {"wqkv_s": None}, kv, 0, None, None,
                              arch="gpt", **kw)
    with pytest.raises(NotImplementedError, match="row 7"):
        tfd.fused_decode_step(x, {"wqkv_s": None}, kv, 0, None, None,
                              arch="moe", **kw)
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_decode_step(x, {}, kv, 0, None, None, arch="moe",
                              kv_scales=torch.ones(1, 1, 8), **kw)
    pool = torch.zeros(1, 2, 4, 8)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    for step, row in ((tfd.fused_paged_decode_step, "row 5"),
                      (tfd.fused_paged_verify_step, "row 6")):
        with pytest.raises(NotImplementedError, match=row):
            step(x, {"wqkv_s": None}, pool, tab, pos, None, None,
                 arch="gpt", **kw)
        for arch in ("llama", "gpt"):
            with pytest.raises(ValueError, match="kv_scales"):
                step(x, {}, pool, tab, pos, None, None, arch=arch,
                     kv_scales=torch.ones(1, 1, 8), **kw)
    with pytest.raises(ValueError, match="cache"):
        tfd.fused_decode_step(x, {}, kv, 0, None, None, num_heads=1,
                              num_kv_heads=1, blocks={"cache_wbytes": 1})


def test_gpt_arch_runs_on_cpu_tensors():
    """arch="gpt" (ported) runs the plain step on CPU tensors, without
    rope rows, and launches nothing."""
    L, b, S, h, nh, ffn, pos = 2, 2, 8, 32, 2, 64, 3
    r = np.random.RandomState(7)
    f = lambda *s: torch.from_numpy((r.randn(*s) * 0.1).astype(np.float32))
    p = {"ln1": 1 + f(L, h), "ln1_b": f(L, h), "wqkv": f(L, h, 3 * h),
         "bqkv": f(L, 3 * h), "wo": f(L, h, h), "bo": f(L, h),
         "ln2": 1 + f(L, h), "ln2_b": f(L, h), "wg": f(L, h, ffn),
         "bg": f(L, ffn), "wd": f(L, ffn, h), "bd": f(L, h)}
    kv = torch.zeros(L, b, S, 2 * h)
    tfd.fused_decode_cuda.launches = 0
    x, kv = tfd.fused_decode_step(f(b, h), p, kv, pos, None, None,
                                  num_heads=nh, num_kv_heads=nh, arch="gpt")
    assert tuple(x.shape) == (b, h) and bool(torch.isfinite(x).all())
    assert bool(kv[:, :, pos].abs().sum() > 0)
    assert float(kv[:, :, pos + 1:].abs().sum()) == 0.0
    assert tfd.fused_decode_cuda.launches == 0
