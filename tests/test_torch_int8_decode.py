"""The int8 modes of the fused decode step and int8 ``generate`` of
paddle_tpu_torch against paddle_tpu, on the CPU.

* ``build_fused_params`` of a quantized state and ``quantize_kv_cache``:
  the same int8 stacks, scale rows, int8 cache and lane scales, bit for bit.
* ``fused_decode_reference`` (the plain version a CPU tensor runs) in each
  int8 mode — llama int8 weights, llama int8 KV, both, gpt int8 KV —
  against the JAX ``fused_decode_reference`` in fp32: x_out atol 2e-5,
  rtol 1e-5 (sums in another order), the appended int8 rows within one
  int8 step (round(kv / scale) of values that differ by a few fp32 ulp can
  land on either side of a .5), the rest of the cache equal.
* The same against the TPU kernel itself, run as the JAX package's tests
  run it on the CPU (``_fused_decode_pallas(..., interpret=True)``), bf16,
  one small case per mode (nkv·hd = 128, S = 128): x_out atol 2e-2, rtol
  2^-6 (K2's bound: one or two bf16 ulp plus bf16 intermediates rounded on
  either side of a boundary; the kernel also derives rope in-kernel and
  folds the k scales into q), appended rows within one int8 step (bf16 KV:
  atol 2e-2, rtol 2^-6).
* ``generate``: tokens EQUAL the JAX ``generate``'s, greedy and sampled,
  on a tiny weight-only int8 Llama with an int8 and a bf16 cache, and on a
  tiny GPT with an int8 cache; ``cache_dtype=int8`` without a fused plan
  raises ValueError in both packages; no kernel counts a launch.
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
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu.ops.rope import rope_cos_sin as jrope
from paddle_tpu.quantization import quantize_model as jquantize_model
from paddle_tpu_torch.core.flags import set_flags as tset_flags
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import (GPTConfig, GPTPretrainModel,
                                     LlamaConfig, LlamaForCausalLM)
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.ops.rope import rope_cos_sin as trope
from paddle_tpu_torch.quantization import quantize_model
from paddle_tpu_torch.utils.convert import jax_state_to_torch, load_jax_state

B, PROMPT, NEW = 2, 7, 6
GPT_CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
               max_position_embeddings=256, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama_pair(quantize=True):
    """(JAX model, port model) with the same fp32 weights, quantized in
    both packages."""
    paddle_tpu.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    if quantize:
        jquantize_model(jm)
        quantize_model(tm)
    return jm, tm


@pytest.fixture(scope="module")
def qllama():
    return _llama_pair()


def _np_state(m):
    return {k: np.asarray(v) for k, v in
            m.state_dict(include_buffers=False).items()}


def test_build_fused_params_int8_equal(qllama):
    jm, tm = qllama
    L = jm.cfg.num_layers
    sd = _np_state(jm)
    pj = jfd.build_fused_params({k: jnp.asarray(v) for k, v in sd.items()},
                                L)
    pt = tfd.build_fused_params(tm.state_dict(include_buffers=False), L)
    assert set(pj) == set(pt) and "wqkv_s" in pt
    for k in pj:
        a = np.asarray(pj[k])
        assert tuple(pt[k].shape) == a.shape, k
        assert np.array_equal(pt[k].numpy(), a), k
    assert pt["wqkv"].dtype == torch.int8
    assert pt["wo_s"].dtype == torch.float32
    assert tuple(pt["wg_s"].shape) == (L, 1, jm.cfg.intermediate_size)


@pytest.mark.parametrize("nkv", [4, 2])
def test_quantize_kv_cache_equal(nkv):
    r = np.random.RandomState(nkv)
    kv = (r.randn(2, 3, 16, 2 * nkv * 16) * r.rand(1, 1, 1, 2 * nkv * 16)
          ).astype(np.float32)
    kv[1, :, :, :16] = 0.0          # an all-zero head: the 1e-8 floor
    qj, sj = jfd.quantize_kv_cache(jnp.asarray(kv), nkv)
    qt, st = tfd.quantize_kv_cache(torch.from_numpy(kv), nkv)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    # bf16 input: the same bits as the JAX package's from the same bf16
    kvb = jnp.asarray(kv, jnp.bfloat16)
    qj, sj = jfd.quantize_kv_cache(kvb, nkv)
    qt, st = tfd.quantize_kv_cache(jax_state_to_torch({"k": kvb})["k"], nkv)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


#: (nh, nkv, hd, h, ffn): small widths for the fp32 comparison, and the
#: interpret-mode kernel's (nkv·hd = 128 lanes)
WIDTHS = {"fp32": {"llama": (4, 2, 16, 64, 96), "gpt": (2, 2, 16, 32, 48)},
          "kernel": {"llama": (4, 2, 64, 128, 256),
                     "gpt": (2, 2, 64, 128, 256)}}


def _case(arch, w8, kv8, r, widths, L=2, b=3, S=16, pos=9):
    """Random fp32 stacks of `arch` (int8 stacks with scale rows when w8)
    and a cache filled below `pos` (int8 with lane scales when kv8), as
    numpy."""
    nh, nkv, hd, h, ffn = widths[arch]
    f = lambda *s, sc=0.05: (r.randn(*s) * sc).astype(np.float32)
    if arch == "gpt":
        params = {"ln1": 1 + f(L, h, sc=0.1), "ln1_b": f(L, h, sc=0.1),
                  "wqkv": f(L, h, 3 * h), "bqkv": f(L, 3 * h, sc=0.1),
                  "wo": f(L, h, h), "bo": f(L, h, sc=0.1),
                  "ln2": 1 + f(L, h, sc=0.1), "ln2_b": f(L, h, sc=0.1),
                  "wg": f(L, h, ffn), "bg": f(L, ffn, sc=0.1),
                  "wd": f(L, ffn, h), "bd": f(L, h, sc=0.1)}
    else:
        dqkv = (nh + 2 * nkv) * hd
        params = {"ln1": 1 + f(L, h, sc=0.1), "wqkv": f(L, h, dqkv),
                  "wo": f(L, nh * hd, h), "ln2": 1 + f(L, h, sc=0.1),
                  "wg": f(L, h, ffn), "wu": f(L, h, ffn), "wd": f(L, ffn, h)}
    if w8:
        for k in ("wqkv", "wo", "wg", "wu", "wd"):
            params[k] = r.randint(-127, 128, params[k].shape).astype(np.int8)
            params[f"{k}_s"] = (r.rand(L, 1, params[k].shape[2]) * 0.0006
                                + 0.0002).astype(np.float32)
    kv = r.randn(L, b, S, 2 * nkv * hd).astype(np.float32)
    kv[:, :, pos:] = 0.0
    scales = None
    if kv8:
        scales = np.repeat((r.rand(L, 1, 2 * nkv) * 0.02 + 0.02)
                           .astype(np.float32), hd, axis=-1)
        kv = np.clip(np.round(kv / scales[:, None]), -127, 127).astype(np.int8)
    return dict(params=params, kv=kv, scales=scales,
                x=r.randn(b, h).astype(np.float32), nh=nh, nkv=nkv, hd=hd,
                S=S, pos=pos)


MODES = [("llama", True, False), ("llama", False, True), ("llama", True, True),
         ("gpt", False, True)]
MODE_IDS = ["llama-int8w", "llama-int8kv", "llama-int8w-int8kv",
            "gpt-int8kv"]


def _rope(arch, c):
    if arch == "gpt":
        return (None, None), (jnp.ones((1, c["hd"])), jnp.ones((1, c["hd"])))
    pos = c["pos"]
    ct, st = trope(c["S"], c["hd"])
    cj, sj = jrope(c["S"], c["hd"])
    return (ct[pos:pos + 1], st[pos:pos + 1]), (cj[pos:pos + 1],
                                                sj[pos:pos + 1])


def _int8_rows_close(kt, kj, pos):
    """Appended int8 rows within one step; everything else equal."""
    kt, kj = kt.astype(np.int32), kj.astype(np.int32)
    assert np.abs(kt[:, :, pos] - kj[:, :, pos]).max() <= 1
    assert np.array_equal(np.delete(kt, pos, axis=2),
                          np.delete(kj, pos, axis=2))


@pytest.mark.parametrize("arch,w8,kv8", MODES, ids=MODE_IDS)
def test_reference_matches_jax_reference_fp32(arch, w8, kv8):
    c = _case(arch, w8, kv8, np.random.RandomState(3), WIDTHS["fp32"])
    kw = dict(num_heads=c["nh"], num_kv_heads=c["nkv"], eps=1e-5, arch=arch)
    (ct, st), (cj, sj) = _rope(arch, c)
    sc = c["scales"]
    xj, kvj = jfd.fused_decode_reference(
        jnp.asarray(c["x"]), {k: jnp.asarray(v) for k, v in c["params"].items()},
        jnp.asarray(c["kv"]), c["pos"], cj, sj,
        kv_scales=None if sc is None else jnp.asarray(sc), **kw)
    xt, kvt = tfd.fused_decode_step(
        torch.from_numpy(c["x"]),
        {k: torch.from_numpy(v) for k, v in c["params"].items()},
        torch.from_numpy(c["kv"].copy()), c["pos"], ct, st,
        kv_scales=None if sc is None else torch.from_numpy(sc), **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5,
                               rtol=1e-5)
    if kv8:
        assert kvt.dtype == torch.int8
        _int8_rows_close(kvt.numpy(), np.asarray(kvj), c["pos"])
    else:
        np.testing.assert_allclose(kvt.numpy(), np.asarray(kvj), atol=2e-5,
                                   rtol=1e-5)
    assert tfd.fused_decode_cuda.launches == 0


def _to_t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("arch,w8,kv8", MODES, ids=MODE_IDS)
def test_reference_matches_interpret_kernel_bf16(arch, w8, kv8):
    """The TPU kernel's int8 modes in interpret mode vs the port's plain
    version; bf16 activations and norms, nkv·hd = 128, S = 128."""
    c = _case(arch, w8, kv8, np.random.RandomState(11), WIDTHS["kernel"],
              b=2, S=128, pos=77)
    nh, nkv, hd, pos = c["nh"], c["nkv"], c["hd"], c["pos"]
    pj = {k: (jnp.asarray(v) if v.dtype != np.float32 or k.endswith("_s")
              else jnp.asarray(v, jnp.bfloat16))
          for k, v in c["params"].items()}
    sc = c["scales"]
    kv_j = (jnp.asarray(c["kv"]) if kv8
            else jnp.asarray(c["kv"], jnp.bfloat16))
    x_j = jnp.asarray(c["x"], jnp.bfloat16)
    xj, kvj = jax.jit(lambda x, p, kv: jfd._fused_decode_pallas(
        x, p, kv, pos, num_heads=nh, num_kv_heads=nkv, head_dim=hd, eps=1e-5,
        arch=arch, kv_scales=None if sc is None else jnp.asarray(sc),
        interpret=True))(x_j, pj, kv_j)
    pt = {k: _to_t(v) for k, v in pj.items()}
    (ct, st), _ = _rope(arch, c)
    kv_t = _to_t(kv_j)
    xt, kvt = tfd.fused_decode_step(
        _to_t(x_j), pt, kv_t.clone(), pos, ct, st, num_heads=nh,
        num_kv_heads=nkv, eps=1e-5, arch=arch,
        kv_scales=None if sc is None else torch.from_numpy(sc))
    np.testing.assert_allclose(xt.float().numpy(),
                               np.asarray(xj, np.float32), atol=2e-2,
                               rtol=2 ** -6)
    if kv8:
        _int8_rows_close(kvt.numpy(), np.asarray(kvj), pos)
    else:
        np.testing.assert_allclose(kvt[:, :, pos].float().numpy(),
                                   np.asarray(kvj, np.float32)[:, :, pos],
                                   atol=2e-2, rtol=2 ** -6)
        assert torch.equal(kvt[:, :, :pos], kv_t[:, :, :pos])


def _ids(seed=2):
    return np.random.RandomState(seed).randint(0, 256, (B, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("kw", [
    dict(),                                                    # greedy
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
])
@pytest.mark.parametrize("int8_cache", [True, False], ids=["int8kv", "bf16kv"])
def test_generate_tokens_equal_jax_quantized_llama(qllama, kw, int8_cache):
    jm, tm = qllama
    ids = _ids()
    oj = np.asarray(jgenerate(
        jm, jnp.asarray(ids), max_new_tokens=NEW,
        cache_dtype=jnp.int8 if int8_cache else jnp.bfloat16, **kw))
    tfd.fused_decode_cuda.launches = 0
    ot = tgenerate(tm, ids, max_new_tokens=NEW,
                   cache_dtype=torch.int8 if int8_cache else torch.bfloat16,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()
    assert tfd.fused_decode_cuda.launches == 0


@pytest.fixture(scope="module")
def gpt():
    paddle_tpu.seed(0)
    jm = JGPT(JGPTConfig(**GPT_CFG))
    jm.eval()
    tm = GPTPretrainModel(GPTConfig(**GPT_CFG), device="cpu", seed=0)
    tm.eval()
    load_jax_state(tm, _np_state(jm))
    return jm, tm


@pytest.mark.parametrize("kw", [
    dict(),
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
])
def test_generate_tokens_equal_jax_gpt_int8_cache(gpt, kw):
    jm, tm = gpt
    ids = _ids(3)
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                              cache_dtype=jnp.int8, **kw))
    ot = tgenerate(tm, ids, max_new_tokens=NEW, cache_dtype=torch.int8,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()


def test_int8_cache_without_a_plan_raises_in_both():
    """A quantized GPT gets no fused plan in either package (the reference
    builds no int8 gpt stacks), and neither does any model with
    FLAGS_fused_decode off: cache_dtype=int8 raises ValueError."""
    paddle_tpu.seed(0)
    jm = JGPT(JGPTConfig(**GPT_CFG))
    jm.eval()
    tm = GPTPretrainModel(GPTConfig(**GPT_CFG), device="cpu", seed=0)
    tm.eval()
    load_jax_state(tm, _np_state(jm))
    jquantize_model(jm)
    quantize_model(tm)
    assert jm.fused_decode_plan(jm.state_dict(include_buffers=False)) is None
    assert tm.fused_decode_plan(tm.state_dict(include_buffers=False)) is None
    ids = _ids(4)
    with pytest.raises(ValueError, match="int8"):
        jgenerate(jm, jnp.asarray(ids), max_new_tokens=2,
                  cache_dtype=jnp.int8)
    with pytest.raises(ValueError, match="int8"):
        tgenerate(tm, ids, max_new_tokens=2, cache_dtype=torch.int8)
    _, tl = _llama_pair(quantize=False)
    jset_flags({"FLAGS_fused_decode": False})
    tset_flags({"FLAGS_fused_decode": False})
    try:
        with pytest.raises(ValueError, match="int8"):
            tgenerate(tl, ids, max_new_tokens=2, cache_dtype=torch.int8)
    finally:
        jset_flags({"FLAGS_fused_decode": True})
        tset_flags({"FLAGS_fused_decode": True})


def test_kernel_wrappers_refuse_int8_they_do_not_take():
    """The plain step refuses an int8 cache without its scales; K5's and
    K7's wrappers refuse an int8 pool without its scales, scales of the
    wrong shape or dtype, and int8 weights on gpt (no reference mode),
    all before any launch, and nothing launches."""
    x = torch.zeros(1, 8)
    kv8 = torch.zeros(1, 1, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_decode_reference(x, {}, kv8, 0, None, None, num_heads=1,
                                   num_kv_heads=1, arch="gpt")
    L, h, hd = 1, 64, 64
    bf = torch.bfloat16
    p = {"ln1": torch.ones(L, h, dtype=bf), "wqkv": torch.zeros(
            L, h, 3 * hd, dtype=bf), "wo": torch.zeros(L, hd, h, dtype=bf),
         "ln2": torch.ones(L, h, dtype=bf), "wg": torch.zeros(
            L, h, 64, dtype=bf), "wu": torch.zeros(L, h, 64, dtype=bf),
         "wd": torch.zeros(L, 64, h, dtype=bf)}
    pool8 = torch.zeros(L, 2, 16, 2 * hd, dtype=torch.int8)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    rope = torch.zeros(1, hd)
    args = (torch.zeros(1, h, dtype=bf), p, pool8, tab, pos, rope, rope)
    kw = dict(num_heads=1, num_kv_heads=1)
    with pytest.raises(ValueError, match="kv_scales"):
        tfd.fused_paged_decode_cuda(*args, **kw)
    for bad in (torch.ones(L, 2, 2 * hd), torch.ones(L, 1, 2 * hd,
                                                     dtype=bf)):
        with pytest.raises((ValueError, TypeError), match="kv_scales"):
            tfd.fused_paged_decode_cuda(*args, kv_scales=bad, **kw)
    with pytest.raises(NotImplementedError, match="row 6"):
        tfd.fused_paged_verify_cuda(
            torch.zeros(1, 2, h, dtype=bf), dict(p, wqkv_s=None), pool8,
            tab, pos, None, None, arch="gpt",
            kv_scales=torch.ones(L, 1, 2 * hd), **kw)
    assert tfd.fused_paged_decode_cuda.launches == 0
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_engine_refuses_a_weight_only_int8_model(qllama):
    """The paged steps take int8 weights (Queue B rows 5 and 6, ported):
    the engine no longer refuses a quantized model; it builds the int8
    stacks and serves, on a bf16 and on an int8 pool. A quantized GPT has
    no fused plan in either package, so the engine refuses it."""
    from paddle_tpu_torch.serving import Request, ServingEngine
    _, tm = qllama
    for cache in (torch.bfloat16, torch.int8):
        eng = ServingEngine(tm, max_slots=2, block_tokens=16,
                            max_seq_len=64, device="cpu", cache_dtype=cache)
        assert eng._plan["params"]["wqkv"].dtype == torch.int8
        rid = eng.submit(Request(np.arange(3, 12), max_new_tokens=3))
        eng.drain()
        assert len(eng.results[rid].tokens) == 3
    gpt = GPTPretrainModel(GPTConfig(**GPT_CFG), device="cpu", seed=0)
    quantize_model(gpt)
    with pytest.raises(ValueError, match="fused_decode_plan"):
        ServingEngine(gpt, max_slots=2, block_tokens=16, max_seq_len=64,
                      device="cpu")
