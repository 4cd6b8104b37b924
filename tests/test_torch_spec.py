"""Speculative decoding in paddle_tpu_torch.serving against paddle_tpu's.

The JAX tests' tiny llama (vocab 512, hidden 128, 2 layers, 4 heads; fp32
weights carried across with utils/convert.py) serves through a bf16 paged
pool on the CPU, where each speculative tick is the plain verify step:

* ``ngram_propose`` (torch) equals ``ngram_propose_host`` and the JAX
  ``ngram_propose`` on the JAX tests' five cases; ``SpecConfig`` validates
  and serializes as the JAX one does;
* the JAX tests' speculative workload (a repetitive prompt among others)
  with ``SpecConfig(k=3)``, 2 slots, block 16, greedy and sampled: tokens
  EQUAL the JAX speculative engine's, the port's non-speculative engine's
  and isolated ``generate``; the spec counts equal the JAX engine's; greedy
  commits more tokens than it runs ticks; no block leaks;
* preempt-then-resume under speculation is token-exact;
* adaptive k with ``k_min=0`` on random prompts decays k, runs plain ticks
  (K5's plain path) and probes, with the non-speculative engine's tokens;
* a steady speculative tick uploads nothing;
* the draft proposer and chunked prefill raise NotImplementedError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import spec as jspec
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
from paddle_tpu_torch.serving import spec as tspec
from paddle_tpu_torch.utils.convert import load_jax_state

TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=4, intermediate_size=256,
            max_position_embeddings=512)
ENGINE = dict(max_slots=2, block_tokens=16, max_seq_len=128)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
SPEC_STATS = ("steps", "spec_ticks", "spec_proposed", "spec_accepted",
              "decode_tokens")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run shares the CPU among several test workers: keep this
    file's torch ops on one thread, so they do not crowd out the other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    paddle_tpu.seed(0)
    jm = JLlama(JLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return jm, tm


def _spec_workload(rng):
    """tests/test_serving_spec.py's mix: a repetitive prompt (the n-gram
    proposer fires), a random one and a repeated motif."""
    motif = rng.randint(3, 512, (8,))
    prompts = [np.tile(motif, 5), rng.randint(3, 512, (19,)),
               np.concatenate([motif, motif, motif])]
    return prompts, [16, 8, 12], [101, 202, 303]


def _isolated(tm, prompts, max_new, seeds, **kw):
    return [tgenerate(tm, p[None], max_new_tokens=mn, request_seeds=[s],
                      **kw)[0, len(p):].numpy().tolist()
            for p, mn, s in zip(prompts, max_new, seeds)]


def _serve(eng, request_cls, prompts, max_new, seeds, max_steps=400):
    rids = [eng.submit(request_cls(p, max_new_tokens=mn, seed=s))
            for p, mn, s in zip(prompts, max_new, seeds)]
    eng.drain(max_steps=max_steps)
    return [eng.results[r].tokens.tolist() for r in rids]


def test_ngram_propose_matches_host_and_jax():
    rng = np.random.RandomState(5)
    motif = rng.randint(3, 100, (4,))
    seq = rng.randint(3, 100, (10,))
    cases = [np.tile(motif, 4),                       # periodic
             rng.randint(3, 100, (20,)),              # random
             np.asarray([7] * 12),                    # constant
             np.concatenate([seq, seq[:5]]),          # prefix echo
             np.asarray([3, 4])]                      # too short
    k, nmax, nmin, S = 4, 3, 1, 48
    hist = np.zeros((len(cases), S), np.int32)
    lengths = np.zeros(len(cases), np.int32)
    for i, c in enumerate(cases):
        hist[i, :len(c)] = c
        lengths[i] = len(c)
    props, nprop = tspec.ngram_propose(torch.from_numpy(hist),
                                       torch.from_numpy(lengths), k, nmax,
                                       nmin)
    jprops, jnprop = jspec.ngram_propose(jnp.asarray(hist),
                                         jnp.asarray(lengths), k, nmax, nmin)
    assert props.dtype == torch.int32 and nprop.dtype == torch.int32
    np.testing.assert_array_equal(props.numpy(), np.asarray(jprops))
    np.testing.assert_array_equal(nprop.numpy(), np.asarray(jnprop))
    for i, c in enumerate(cases):
        ref_p, ref_n = tspec.ngram_propose_host(c, k, nmax, nmin)
        jref_p, jref_n = jspec.ngram_propose_host(c, k, nmax, nmin)
        assert ref_n == jref_n and ref_p.tolist() == jref_p.tolist()
        assert int(nprop[i]) == ref_n, i
        assert props[i, :ref_n].tolist() == ref_p[:ref_n].tolist(), i
    assert int(nprop[4]) == 0 and int(nprop[0]) == 4


def test_spec_config_validation_matches_jax(pair):
    for kw in (dict(k=0), dict(k=True), dict(proposer="oracle"),
               dict(ngram_min=3, ngram_max=2), dict(proposer="draft"),
               dict(k=2, k_min=3), dict(acceptance_floor=1.5),
               dict(acceptance_floor=0.8, acceptance_ceiling=0.2),
               dict(adapt_every=0), dict(ngram_max=0)):
        with pytest.raises(ValueError) as jerr:
            jspec.SpecConfig(**kw)
        with pytest.raises(ValueError) as terr:
            SpecConfig(**kw)
        assert str(terr.value) == str(jerr.value), kw
    for kw in (dict(k=3), dict(k=5, adaptive=True, k_min=0, adapt_every=2,
                               acceptance_floor=0.5, ngram_max=4)):
        assert SpecConfig(**kw).to_config() == \
            jspec.SpecConfig(**kw).to_config()
    assert SpecConfig(k=3).to_config() == {
        "k": 3, "proposer": "ngram", "ngram_max": 3, "ngram_min": 1,
        "adaptive": False, "k_min": 1, "acceptance_floor": 0.35,
        "acceptance_ceiling": 0.65, "adapt_every": 4,
        "share_embeddings": True}
    _, tm = pair
    with pytest.raises(ValueError, match="SpecConfig"):
        ServingEngine(tm, **ENGINE, device="cpu", speculate="yes")
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(tm, **ENGINE, device="cpu",
                      speculate=SpecConfig(k=128))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_tokens_equal_jax_nonspec_and_generate(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    prompts, max_new, seeds = _spec_workload(np.random.RandomState(7))
    tfd.fused_paged_verify_cuda.launches = 0
    eng = ServingEngine(tm, **ENGINE, device="cpu",
                        speculate=SpecConfig(k=3), **kw)
    got = _serve(eng, Request, prompts, max_new, seeds)
    je = jserving.ServingEngine(jm, **ENGINE,
                                speculate=jspec.SpecConfig(k=3), **kw)
    jgot = _serve(je, jserving.Request, prompts, max_new, seeds)
    plain = ServingEngine(tm, **ENGINE, device="cpu", **kw)
    pgot = _serve(plain, Request, prompts, max_new, seeds)
    iso = _isolated(tm, prompts, max_new, seeds, **kw)
    assert got == jgot
    assert got == pgot
    assert got == iso
    st = eng.stats
    assert {k: st[k] for k in SPEC_STATS} == \
        {k: je.stats[k] for k in SPEC_STATS}
    assert st["steps"] == st["spec_ticks"] > 0
    assert st["decode_tokens"] == sum(max_new) - len(prompts)
    if mode == "greedy":
        assert st["spec_accepted"] > 0
        assert st["decode_tokens"] > st["steps"]
    assert eng.pool.used_blocks == len(eng.prefix_cache._entries)
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0 and eng._reserved == 0
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_spec_preempt_resume_token_exact(pair):
    _, tm = pair
    rng = np.random.RandomState(3)
    motif = rng.randint(3, 512, (6,))
    lows = [np.tile(motif, 6), rng.randint(3, 512, (21,))]
    high = np.tile(rng.randint(3, 512, (5,)), 4)
    iso = _isolated(tm, lows + [high], [24, 24, 8], [5, 6, 7])
    eng = ServingEngine(tm, **ENGINE, device="cpu",
                        speculate=SpecConfig(k=3))
    rids = [eng.submit(Request(p, max_new_tokens=24, seed=s, priority="low"))
            for p, s in zip(lows, [5, 6])]
    for _ in range(3):                       # both lows mid-generation
        eng.step()
    assert eng.active_slots == 2
    rh = eng.submit(Request(high, max_new_tokens=8, seed=7,
                            priority="high"))
    eng.step()                               # the high request preempts
    assert eng.stats["preemptions"] == 1
    eng.drain(max_steps=200)
    assert eng.stats["requests_resumed"] == 1
    assert eng.stats["replay_tokens"] >= 2
    assert eng.stats["spec_accepted"] > 0
    for rid, ref in zip(rids + [rh], iso):
        assert eng.results[rid].tokens.tolist() == ref
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0 and eng._reserved == 0


def test_adaptive_k_decays_to_plain_ticks_and_probes(pair):
    """Sampled decoding of random prompts rejects the n-gram proposals:
    the slot's acceptance EWMA parks its k at k_min = 0, ticks turn plain
    (no verify tail), the parked slot is probed every adapt_every ticks,
    and the tokens are the non-speculative engine's."""
    _, tm = pair
    rng = np.random.RandomState(11)
    prompts = [rng.randint(3, 512, (n,)) for n in (12, 20)]
    kw = dict(max_slots=1, block_tokens=16, max_seq_len=96, device="cpu",
              temperature=0.8, top_k=20, top_p=0.9)
    eng = ServingEngine(tm, **kw, speculate=SpecConfig(
        k=3, adaptive=True, k_min=0, adapt_every=2, acceptance_floor=0.5))
    rids = [eng.submit(Request(p, max_new_tokens=40, seed=42 + i))
            for i, p in enumerate(prompts)]
    widths = []
    while not eng.idle:
        eng.step()
        widths.append(eng._spec_k_eff)
    plain = ServingEngine(tm, **kw)
    want = _serve(plain, Request, prompts, [40, 40], [42, 43])
    assert [eng.results[r].tokens.tolist() for r in rids] == want
    st = eng.stats
    assert 0 in widths and widths[0] == 3          # k decayed from 3 to 0
    assert st["steps"] > st["spec_ticks"] > 0      # plain ticks ran
    assert st["spec_k_probes"] > 0
    assert st["decode_tokens"] == plain.stats["decode_tokens"]


def test_steady_spec_tick_uploads_nothing(pair, monkeypatch):
    _, tm = pair
    motif = np.random.RandomState(2).randint(3, 512, (4,))
    eng = ServingEngine(tm, **ENGINE, device="cpu",
                        speculate=SpecConfig(k=3))
    # 17- and 18-token prompts: the next two ticks' appends (at most 4
    # tokens each, plus the k-token horizon) stay inside block 1
    for n in (17, 18):
        eng.submit(Request(np.tile(motif, 5)[:n], max_new_tokens=40))
    eng.step()                          # admit, upload, first verify
    uploads = []
    real = eng._up
    monkeypatch.setattr(eng, "_up", lambda a: uploads.append(a) or real(a))
    steps0, committed0 = eng.stats["steps"], eng.stats["decode_tokens"]
    eng.step()
    eng.step()
    assert uploads == [] and not eng._dirty
    assert eng.stats["steps"] == steps0 + 2
    assert eng.stats["decode_tokens"] > committed0 + 2   # accepted runs
    eng.drain()
    assert all(len(r.tokens) == 40 for r in eng.results.values())


def test_unported_spec_options_raise(pair):
    _, tm = pair
    draft = SpecConfig(k=2, proposer="draft", draft_model=tm)
    with pytest.raises(NotImplementedError, match="draft proposer"):
        ServingEngine(tm, **ENGINE, device="cpu", speculate=draft)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(tm, **ENGINE, device="cpu", speculate=SpecConfig(k=2),
                      chunk_tokens=16)
