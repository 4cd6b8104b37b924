"""The int8 serving engine of paddle_tpu_torch against paddle_tpu's.

The tiny llama of tests/test_torch_spec.py (fp32 weights from the JAX
model, carried across with utils/convert.py) serves on the CPU, where each
tick is the paged plain step in its int8 modes:

* an int8 pool (``cache_dtype=torch.int8``), 4 requests through 2 slots:
  tokens EQUAL the JAX int8 engine's and the port's isolated int8
  ``generate``, greedy and sampled, and no block leaks (the JAX package's
  ``test_join_leave_parity_llama_int8`` and its int8 kernel twin);
* a prefix hit on an int8 pool requantizes from the cache's bf16 host
  copies (``kv_host``, copies and not views): the cache holds no pool
  reference, tokens equal the JAX engine's (``test_prefix_reuse_parity_
  int8_requantizes``); hits are not counted as capacity (``test_int8_
  admission_ignores_prefix_hits_as_capacity``);
* preempt and resume on an int8 pool are token-exact, with the slot's
  scales recalibrated to the same bits;
* a weight-only int8 model (``quantize_model`` in both packages) with a
  bf16 and an int8 pool: the JAX engine's tokens;
* the speculative int8 engine (``SpecConfig(k=3)``): the JAX speculative
  int8 engine's tokens and counts and the port's plain int8 engine's
  tokens, greedy and sampled (``tests/test_serving_spec.py``'s parity);
* a steady int8 tick uploads nothing;
* a tiny GPT with an int8 pool: the JAX engine's tokens, plain and
  speculative.
No kernel counts a launch on CPU tensors. The card's twins are in
``tests/test_torch_port_rules.py`` (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainModel as JGPT
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.quantization import quantize_model as jquantize_model
from paddle_tpu.serving import spec as jspec
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import (GPTConfig, GPTPretrainModel,
                                     LlamaConfig, LlamaForCausalLM)
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.quantization import quantize_model
from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
from paddle_tpu_torch.utils.convert import load_jax_state

TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=4, intermediate_size=256,
            max_position_embeddings=512)
GPT = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
ENGINE = dict(max_slots=2, block_tokens=16, max_seq_len=128)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
SPEC_STATS = ("steps", "spec_ticks", "spec_proposed", "spec_accepted",
              "decode_tokens")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama_pair(int8_weights=False):
    paddle_tpu.seed(0)
    jm = JLlama(JLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    if int8_weights:
        jquantize_model(jm)
        quantize_model(tm)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _llama_pair()


def _isolated(tm, prompts, max_new, seeds, **kw):
    return [tgenerate(tm, p[None], max_new_tokens=mn, request_seeds=[s],
                      **kw)[0, len(p):].numpy().tolist()
            for p, mn, s in zip(prompts, max_new, seeds)]


def _serve(eng, request_cls, prompts, max_new, seeds, max_steps=400):
    rids = [eng.submit(request_cls(p, max_new_tokens=mn, seed=s))
            for p, mn, s in zip(prompts, max_new, seeds)]
    eng.drain(max_steps=max_steps)
    return [eng.results[r].tokens.tolist() for r in rids]


def _both(jm, tm, prompts, max_new, seeds, *, jkw=None, **kw):
    """The port's engine (CPU) and the JAX engine over the same requests,
    the int8 pool unless ``kw`` says otherwise: (port tokens, JAX tokens,
    port engine, JAX engine)."""
    kw = dict(ENGINE, **kw)
    tkw = dict(kw, cache_dtype=kw.get("cache_dtype", torch.int8))
    eng = ServingEngine(tm, device="cpu", **tkw)
    got = _serve(eng, Request, prompts, max_new, seeds)
    jkw = dict(kw, **(jkw or {}))
    jkw["cache_dtype"] = (jnp.bfloat16 if tkw["cache_dtype"] == torch.bfloat16
                          else jnp.int8)
    je = jserving.ServingEngine(jm, **jkw)
    ref = _serve(je, jserving.Request, prompts, max_new, seeds)
    return got, ref, eng, je


def _no_launches():
    return (tfd.fused_paged_decode_cuda.launches == 0
            and tfd.fused_paged_verify_cuda.launches == 0)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_int8_pool_engine_matches_jax_and_generate(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, 512, (n,)) for n in (9, 21, 30, 40)]
    max_new, seeds = [8, 12, 6, 7], [5, 4000000000, 7, 9]
    got, ref, eng, _ = _both(jm, tm, prompts, max_new, seeds, **kw)
    assert got == ref
    assert got == _isolated(tm, prompts, max_new, seeds,
                            cache_dtype=torch.int8, **kw)
    assert eng.kv_pool.dtype == torch.int8
    assert eng.block_bytes == 2 * 16 * 2 * 128       # one byte a value
    # the int8 cache holds host copies, never a pool reference
    assert eng.pool.used_blocks == 0 and eng._reserved == 0
    assert all(e.block_id is None and e.kv_host is not None
               for e in eng.prefix_cache._entries.values())
    assert _no_launches()


def test_int8_prefix_hit_requantizes_from_host_copies(pair):
    jm, tm = pair
    rng = np.random.RandomState(6)
    sys_p = rng.randint(3, 512, (32,))
    prompts = [np.concatenate([sys_p, rng.randint(3, 512, (6,))]),
               np.concatenate([sys_p, rng.randint(3, 512, (11,))])]
    iso = _isolated(tm, prompts, [6, 6], [1, 2], cache_dtype=torch.int8)
    eng = ServingEngine(tm, **ENGINE, device="cpu", cache_dtype=torch.int8)
    ra = eng.submit(Request(prompts[0], max_new_tokens=6, seed=1))
    eng.drain()
    entries = list(eng.prefix_cache._entries.values())
    assert len(entries) == 2                        # 38 tokens: 2 blocks
    for e in entries:
        assert e.block_id is None
        assert e.kv_host.dtype == torch.bfloat16
        assert tuple(e.kv_host.shape) == (2, 16, 2 * 128)
        # a copy that owns its bytes, not a view of the prefill's cache
        assert e.kv_host.untyped_storage().nbytes() == \
            e.kv_host.numel() * e.kv_host.element_size()
    rb = eng.submit(Request(prompts[1], max_new_tokens=6, seed=2))
    eng.drain()
    assert eng.results[rb].prefix_hit_blocks == 2
    assert eng.stats["prefill_tokens_reused"] == 32
    assert [eng.results[r].tokens.tolist() for r in (ra, rb)] == iso
    assert eng.pool.used_blocks == 0
    je = jserving.ServingEngine(jm, **ENGINE, cache_dtype=jnp.int8)
    ref = [_serve(je, jserving.Request, [p], [6], [s])[0]
           for p, s in zip(prompts, (1, 2))]
    assert ref == iso
    assert _no_launches()


def test_int8_admission_ignores_prefix_hits_as_capacity(pair):
    """int8 prefix hits share no physical block: a request whose worst
    case exceeds the pool queues even with cached hits, and an unbounded
    drain detects the stall."""
    _, tm = pair
    prompt = np.random.RandomState(21).randint(3, 512, (32,))
    eng = ServingEngine(tm, **dict(ENGINE, max_slots=1), num_blocks=7,
                        device="cpu", cache_dtype=torch.int8)
    ra = eng.submit(Request(prompt, max_new_tokens=2))
    eng.drain(max_steps=50)
    assert eng.results[ra].finish == "length"
    assert eng.pool.used_blocks == 0 and len(eng.prefix_cache) == 2
    rb = eng.submit(Request(prompt, max_new_tokens=80))   # worst 7 > 6
    for _ in range(5):
        eng.step()
    assert eng.queued == 1 and eng.active_slots == 0
    assert rb not in eng.results
    with pytest.raises(tserving.PoolExhausted, match="stalled"):
        eng.drain()


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_int8_preempt_resume_token_exact(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    rng = np.random.RandomState(9)
    lows = [rng.randint(3, 512, (n,)) for n in (37, 21)]
    high = rng.randint(3, 512, (15,))
    iso = _isolated(tm, lows + [high], [20, 20, 6], [5, 6, 7],
                    cache_dtype=torch.int8, **kw)
    eng = ServingEngine(tm, **ENGINE, device="cpu", cache_dtype=torch.int8,
                        **kw)
    rids = [eng.submit(Request(p, max_new_tokens=20, seed=s,
                               priority="low"))
            for p, s in zip(lows, [5, 6])]
    for _ in range(8):                      # both lows mid-generation
        eng.step()
    scales = eng._kv_scales.copy()
    rh = eng.submit(Request(high, max_new_tokens=6, seed=7,
                            priority="high"))
    eng.step()                              # the high request preempts
    assert eng.stats["preemptions"] == 1 and eng.queued == 1
    victim = next(i for i, s in enumerate(eng._slots)
                  if s is not None and s.req.request_id == rh)
    eng.drain(max_steps=200)
    assert eng.stats["requests_resumed"] == 1
    assert eng.stats["replay_tokens"] >= 6
    for rid, ref in zip(rids + [rh], iso):
        assert eng.results[rid].tokens.tolist() == ref
    # the resumed low (back in its old slot once the high retired)
    # recalibrated over its prompt: its first scales, bit for bit
    assert np.array_equal(eng._kv_scales[:, victim], scales[:, victim])
    assert eng.pool.used_blocks == 0 and eng._reserved == 0
    # a preempted int8 slot donates no block to the cache
    assert all(e.block_id is None
               for e in eng.prefix_cache._entries.values())


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_int8_weight_model_engine_matches_jax(cache):
    jm, tm = _llama_pair(int8_weights=True)
    assert "model.layers.0.self_attn.q_proj.weight_q" in \
        tm.state_dict(include_buffers=False)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(3, 512, (n,)) for n in (11, 26, 17)]
    max_new, seeds = [7, 9, 5], [1, 2, 3]
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    got, ref, eng, _ = _both(jm, tm, prompts, max_new, seeds,
                             cache_dtype=dt)
    assert got == ref
    assert got == _isolated(tm, prompts, max_new, seeds, cache_dtype=dt)
    assert "wqkv_s" in eng._plan["params"]
    assert _no_launches()


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_int8_spec_engine_matches_jax(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    rng = np.random.RandomState(31)
    motif = rng.randint(3, 512, (8,))
    prompts = [np.tile(motif, 5), rng.randint(3, 512, (19,)),
               np.concatenate([motif, motif, motif])]
    max_new, seeds = [16, 8, 12], [101, 202, 303]
    got, ref, eng, je = _both(
        jm, tm, prompts, max_new, seeds, speculate=SpecConfig(k=3),
        jkw=dict(speculate=jspec.SpecConfig(k=3)), **kw)
    assert got == ref
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: je.stats[k] for k in SPEC_STATS}
    assert eng.stats["spec_ticks"] > 0
    plain = ServingEngine(tm, **ENGINE, device="cpu",
                          cache_dtype=torch.int8, **kw)
    assert got == _serve(plain, Request, prompts, max_new, seeds)
    if mode == "greedy":
        assert eng.stats["spec_accepted"] > 0
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0
    assert _no_launches()


def test_int8_steady_tick_uploads_nothing(pair, monkeypatch):
    _, tm = pair
    eng = ServingEngine(tm, **ENGINE, device="cpu", cache_dtype=torch.int8)
    for p in np.random.RandomState(2).randint(3, 512, (2, 5)):
        eng.submit(Request(p, max_new_tokens=8))
    eng.step()                              # admit, upload, first decode
    assert eng._dev_scales is not None
    assert eng._dev_scales.dtype == torch.float32
    assert tuple(eng._dev_scales.shape) == (2, 2, 2 * 128)
    uploads = []
    real = eng._up
    monkeypatch.setattr(eng, "_up", lambda a: uploads.append(a) or real(a))
    for _ in range(4):                      # positions 6..9: one block
        eng.step()
    assert uploads == [] and not eng._dirty
    eng.drain()
    assert all(len(r.tokens) == 8 for r in eng.results.values())


@pytest.mark.parametrize("spec", [False, True])
def test_gpt_int8_pool_matches_jax(spec):
    paddle_tpu.seed(0)
    jm = JGPT(JGPTConfig(**GPT))
    jm.eval()
    tm = GPTPretrainModel(GPTConfig(**GPT), device="cpu", seed=0)
    tm.eval()
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    rng = np.random.RandomState(12)
    motif = rng.randint(3, 256, (6,))
    prompts = [np.tile(motif, 4), rng.randint(3, 256, (13,)),
               rng.randint(3, 256, (20,))]
    max_new, seeds = [10, 6, 8], [4, 5, 6]
    kw = (dict(speculate=SpecConfig(k=3),
               jkw=dict(speculate=jspec.SpecConfig(k=3))) if spec else {})
    got, ref, eng, je = _both(jm, tm, prompts, max_new, seeds, **kw)
    assert eng.arch == "gpt" and eng.kv_pool.dtype == torch.int8
    assert got == ref
    assert got == _isolated(tm, prompts, max_new, seeds,
                            cache_dtype=torch.int8)
    if spec:
        assert {k: eng.stats[k] for k in SPEC_STATS} == \
            {k: je.stats[k] for k in SPEC_STATS}
    assert eng.pool.used_blocks == 0
    assert _no_launches()
