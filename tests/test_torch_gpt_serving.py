"""paddle_tpu_torch.serving.ServingEngine on a GPT against paddle_tpu's.

The tiny GPT of tests/test_torch_gpt_generate.py (fp32 weights from the JAX
model, carried across with utils/convert.py) serves through a bf16 paged
pool, block_tokens 16, max_seq_len 128, on the CPU, where the decode step
is the paged plain version of the gpt arch:

* 4 mixed-length requests through 3 slots (joins and leaves interleave):
  every request's tokens EQUAL the JAX engine's and the port's own
  isolated ``generate``, greedy and sampled (per-request seeds);
* ``speculate=SpecConfig(k=3)`` on a tiled-motif prompt (the JAX package's
  ``test_spec_parity_gpt``): tokens equal the JAX speculative engine's and
  isolated ``generate``; the spec stats equal the JAX engine's;
* no kernel counts a launch on CPU tensors, and no block leaks.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainModel as JGPT
from paddle_tpu.serving import SpecConfig as JSpecConfig
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.serving import ServingEngine, SpecConfig
from paddle_tpu_torch.utils.convert import load_jax_state

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
ENGINE = dict(max_slots=3, block_tokens=16, max_seq_len=128)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    paddle_tpu.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTPretrainModel(GPTConfig(**CFG), device="cpu", seed=0)
    tm.eval()
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return jm, tm


def _reset_counts():
    for c in (tfd.fused_decode_cuda, tfd.fused_paged_decode_cuda,
              tfd.fused_paged_verify_cuda, tfa.flash_attention_fwd):
        c.launches = 0


def _no_launches():
    return all(c.launches == 0 for c in (
        tfd.fused_decode_cuda, tfd.fused_paged_decode_cuda,
        tfd.fused_paged_verify_cuda, tfa.flash_attention_fwd))


def _requests(mod, prompts, max_new, seeds):
    return [mod.Request(p, max_new_tokens=mn,
                        **({} if seeds is None else {"seed": s}))
            for p, mn, s in zip(prompts, max_new, seeds or [0] * 4)]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_gpt_tokens_equal_jax_engine_and_isolated_generate(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    seeds = [11, 4000000000, 7, 123] if mode == "sampled" else None
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 256, (n,)) for n in (7, 19, 33, 12)]
    max_new = [10, 6, 14, 9]
    iso = [tgenerate(tm, p[None], max_new_tokens=mn,
                     request_seeds=None if seeds is None else [s],
                     **kw)[0, len(p):].numpy().tolist()
           for p, mn, s in zip(prompts, max_new, seeds or [0] * 4)]
    _reset_counts()
    eng = ServingEngine(tm, **ENGINE, device="cpu", **kw)
    assert eng.arch == "gpt"
    rids = [eng.submit(r) for r in _requests(tserving, prompts, max_new,
                                             seeds)]
    eng.drain(max_steps=200)
    assert _no_launches()
    je = jserving.ServingEngine(jm, **ENGINE, **kw)
    jrids = [je.submit(r) for r in _requests(jserving, prompts, max_new,
                                             seeds)]
    je.drain(max_steps=200)
    for rid, jrid, ref in zip(rids, jrids, iso):
        got = eng.results[rid].tokens.tolist()
        assert got == ref
        assert got == je.results[jrid].tokens.tolist()
    assert eng.stats["decode_tokens"] == je.stats["decode_tokens"]
    assert eng.stats["steps"] == je.stats["steps"]
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0


def test_gpt_spec_tokens_equal_jax_spec_engine(pair):
    """The JAX package's test_spec_parity_gpt, both packages: a tiled motif
    through SpecConfig(k=3), 2 slots."""
    jm, tm = pair
    rng = np.random.RandomState(22)
    motif = rng.randint(3, 256, (6,))
    p = np.tile(motif, 5)
    iso = tgenerate(tm, p[None], max_new_tokens=10,
                    temperature=0.0)[0, len(p):].numpy().tolist()
    spec = dict(ENGINE, max_slots=2)
    _reset_counts()
    eng = ServingEngine(tm, **spec, device="cpu", speculate=SpecConfig(k=3))
    rid = eng.submit(tserving.Request(p, max_new_tokens=10))
    eng.drain(max_steps=200)
    assert _no_launches()
    je = jserving.ServingEngine(jm, **spec, speculate=JSpecConfig(k=3))
    jrid = je.submit(jserving.Request(p, max_new_tokens=10))
    je.drain(max_steps=200)
    got = eng.results[rid].tokens.tolist()
    assert got == iso
    assert got == je.results[jrid].tokens.tolist()
    for key in ("spec_ticks", "spec_proposed", "spec_accepted", "steps"):
        assert eng.stats[key] == je.stats[key], key
    assert eng.stats["spec_ticks"] > 0
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0
