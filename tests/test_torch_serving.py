"""paddle_tpu_torch.serving.ServingEngine against paddle_tpu.serving's.

A tiny llama (fp32 weights from the JAX model, carried across with
utils/convert.py) serves through a bf16 paged pool, block_tokens 16, on the
CPU, where the decode step is the paged plain version:

* 4 mixed-length requests through 3 slots (joins and leaves interleave):
  every request's tokens EQUAL the JAX engine's and the port's own isolated
  ``generate``, greedy and sampled (per-request seeds);
* 14 greedy requests through 12 slots (past the kernels' old 8 rows): the
  JAX engine's tokens and steps; 66 through 65 slots and 17 through 16
  slots speculating k = 4 (wider than one launch on the card), likewise;
* shared prefix blocks stay byte-unchanged while a second request adopts
  them (copy-on-write), and ``prefill_tokens_reused`` counts them;
* eos retires a slot and frees its blocks at once;
* a high-priority submit preempts a low one, and the resumed request's
  tokens equal an uninterrupted run (greedy and sampled);
* a steady tick uploads nothing (the device twins advance in the step);
* ``drain`` raises PoolExhausted on a stall; deadlines retire; bad
  arguments and unported options raise.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.serving import (PoolExhausted, Request,
                                      ServingEngine)
from paddle_tpu_torch.utils.convert import load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE = dict(max_slots=3, block_tokens=16, max_seq_len=128, device="cpu")
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def pair():
    # the JAX model draws its weights from the package's global seed
    # stream: seed it, so the weights do not depend on what an earlier
    # test file drew in the same worker process
    paddle_tpu.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return jm, tm


def _isolated(tm, prompts, max_new, seeds=None, **kw):
    return [tgenerate(tm, p[None], max_new_tokens=mn,
                      request_seeds=None if seeds is None else [s],
                      **kw)[0, len(p):].numpy().tolist()
            for p, mn, s in zip(prompts, max_new, seeds or [0] * 4)]


def _requests(mod, prompts, max_new, seeds):
    return [mod.Request(p, max_new_tokens=mn,
                        **({} if seeds is None else {"seed": s}))
            for p, mn, s in zip(prompts, max_new, seeds or [0] * 4)]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_tokens_equal_jax_engine_and_isolated_generate(pair, mode):
    jm, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    seeds = [11, 4000000000, 7, 123] if mode == "sampled" else None
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 256, (n,)) for n in (7, 19, 33, 12)]
    max_new = [10, 6, 14, 9]
    iso = _isolated(tm, prompts, max_new, seeds, **kw)
    eng = ServingEngine(tm, **ENGINE, **kw)
    rids = [eng.submit(r) for r in _requests(tserving, prompts, max_new,
                                             seeds)]
    eng.drain(max_steps=200)
    je = jserving.ServingEngine(jm, **{k: v for k, v in ENGINE.items()
                                       if k != "device"}, **kw)
    jrids = [je.submit(r) for r in _requests(jserving, prompts, max_new,
                                             seeds)]
    je.drain(max_steps=200)
    for rid, jrid, ref in zip(rids, jrids, iso):
        got = eng.results[rid].tokens.tolist()
        assert got == ref
        assert got == je.results[jrid].tokens.tolist()
    # leave == immediate slot reuse: no eos-padding steps ran
    assert eng.stats["decode_tokens"] == sum(max_new) - len(prompts)
    assert eng.stats["decode_tokens"] == je.stats["decode_tokens"]
    assert eng.stats["steps"] == je.stats["steps"]
    cache_held = len(eng.prefix_cache._entries)
    assert eng.pool.used_blocks == cache_held
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0
    assert tfd.fused_paged_decode_cuda.launches == 0


def test_serving_engine_twelve_slots_matches_jax(pair):
    """14 greedy requests through 12 slots (two wait for a slot): the
    port's engine on the CPU gives the JAX engine's tokens and steps."""
    jm, tm = pair
    rng = np.random.RandomState(12)
    prompts = [rng.randint(3, 256, (int(n),))
               for n in rng.randint(4, 40, 14)]
    max_new = [int(n) for n in rng.randint(3, 12, 14)]
    engine = dict(max_slots=12, block_tokens=16, max_seq_len=64)
    eng = ServingEngine(tm, **engine, device="cpu")
    rids = [eng.submit(Request(p, max_new_tokens=n))
            for p, n in zip(prompts, max_new)]
    eng.step()
    assert eng.active_slots == 12        # one step admits 12 of the 14
    eng.drain(max_steps=400)
    je = jserving.ServingEngine(jm, **engine)
    jrids = [je.submit(jserving.Request(p, max_new_tokens=n))
             for p, n in zip(prompts, max_new)]
    je.drain(max_steps=400)
    for rid, jrid, n in zip(rids, jrids, max_new):
        got = eng.results[rid].tokens.tolist()
        assert len(got) == n
        assert got == je.results[jrid].tokens.tolist()
    assert eng.stats["steps"] == je.stats["steps"]
    assert tfd.fused_paged_decode_cuda.launches == 0


@pytest.mark.parametrize("case", ["65_slots", "16_slots_spec_k4"])
def test_wide_serving_engines_match_jax(pair, case):
    """Engines wider than one kernel launch (on the card, K5 takes 64 rows
    a launch and K7 64 tail rows, whole slots; wider steps run in groups of
    rows): 65 slots, and 16 slots speculating k = 4 (80 tail rows). Every
    slot is busy at once; the greedy tokens (and the speculative counts)
    equal the JAX engine's."""
    jm, tm = pair
    slots = 65 if case == "65_slots" else 16
    rng = np.random.RandomState(slots)
    motif = rng.randint(3, 256, (6,))
    prompts = [np.tile(motif, 3) if i % 3 == 0 else
               rng.randint(3, 256, (int(rng.randint(4, 24)),))
               for i in range(slots + 1)]
    max_new = [int(n) for n in rng.randint(3, 9, slots + 1)]
    engine = dict(max_slots=slots, block_tokens=16, max_seq_len=48)
    spec = case != "65_slots"
    tspec = dict(speculate=tserving.SpecConfig(k=4)) if spec else {}
    from paddle_tpu.serving import spec as jspec_mod
    jspec = dict(speculate=jspec_mod.SpecConfig(k=4)) if spec else {}
    eng = ServingEngine(tm, **engine, device="cpu", **tspec)
    rids = [eng.submit(Request(p, max_new_tokens=n))
            for p, n in zip(prompts, max_new)]
    eng.step()
    assert eng.active_slots == slots
    eng.drain(max_steps=400)
    je = jserving.ServingEngine(jm, **engine, **jspec)
    jrids = [je.submit(jserving.Request(p, max_new_tokens=n))
             for p, n in zip(prompts, max_new)]
    je.drain(max_steps=400)
    for rid, jrid, n in zip(rids, jrids, max_new):
        got = eng.results[rid].tokens.tolist()
        assert len(got) == n
        assert got == je.results[jrid].tokens.tolist()
    keys = ("steps", "decode_tokens") + (
        ("spec_ticks", "spec_proposed", "spec_accepted") if spec else ())
    assert {k: eng.stats[k] for k in keys} == {k: je.stats[k] for k in keys}
    assert tfd.fused_paged_decode_cuda.launches == 0
    assert tfd.fused_paged_verify_cuda.launches == 0


def test_prefix_reuse_copy_on_write(pair):
    _, tm = pair
    rng = np.random.RandomState(5)
    sys_p = rng.randint(3, 256, (40,))
    pr_a = np.concatenate([sys_p, rng.randint(3, 256, (5,))])
    pr_b = np.concatenate([sys_p, rng.randint(3, 256, (9,))])
    iso = _isolated(tm, [pr_a, pr_b], [8, 8])
    eng = ServingEngine(tm, **ENGINE)
    ra = eng.submit(Request(pr_a, max_new_tokens=8))
    eng.drain()
    shared = eng.prefix_cache.lookup(pr_b, len(pr_b) // 16, record=False)
    assert len(shared) == 2                  # 40 tokens -> 2 full blocks
    bids = [e.block_id for e in shared]
    before = eng.kv_pool[:, bids].clone()
    rb = eng.submit(Request(pr_b, max_new_tokens=8))
    eng.drain()
    assert torch.equal(eng.kv_pool[:, bids], before)   # no writes
    assert eng.results[ra].tokens.tolist() == iso[0]
    assert eng.results[rb].tokens.tolist() == iso[1]
    assert eng.results[rb].prefix_hit_blocks == 2
    assert eng.stats["prefill_tokens_reused"] == 32
    assert eng.stats["prefill_tokens"] == len(pr_a) + len(pr_b) - 32


def test_eos_retires_slot_and_frees_blocks(pair):
    _, tm = pair
    p = np.random.RandomState(4).randint(3, 256, (11,))
    full = _isolated(tm, [p], [12])[0]
    eos = full[4]                            # force an eos 5 tokens in
    assert eos not in full[:4]
    eng = ServingEngine(tm, **ENGINE, eos_token_id=eos, prefix_caching=False)
    rid = eng.submit(Request(p, max_new_tokens=12))
    eng.drain(max_steps=100)
    res = eng.pop_result(rid)
    assert res.finish == "eos" and res.gen_len == 4
    assert res.tokens.tolist() == full[:5]
    assert eng.pool.used_blocks == 0 and eng._reserved == 0
    assert eng.stats["decode_tokens"] == 4   # no eos-padding steps
    assert rid not in eng.results


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_priority_preemption_resume_token_exact(pair, mode):
    _, tm = pair
    kw = SAMPLED if mode == "sampled" else {}
    rng = np.random.RandomState(9)
    lows = [rng.randint(3, 256, (n,)) for n in (37, 21)]
    high = rng.randint(3, 256, (15,))
    iso = _isolated(tm, lows + [high], [20, 20, 6], [5, 6, 7], **kw)
    eng = ServingEngine(tm, **dict(ENGINE, max_slots=2), **kw)
    rids = [eng.submit(Request(p, max_new_tokens=20, seed=s,
                               priority="low"))
            for p, s in zip(lows, [5, 6])]
    for _ in range(8):                       # both lows mid-generation
        eng.step()
    assert eng.active_slots == 2
    rh = eng.submit(Request(high, max_new_tokens=6, seed=7,
                            priority="high"))
    eng.step()                               # the high request preempts
    assert eng.stats["preemptions"] == 1 and eng.queued == 1
    eng.drain(max_steps=200)
    assert eng.stats["requests_resumed"] == 1
    assert eng.stats["replay_tokens"] >= 6
    for rid, ref in zip(rids + [rh], iso):
        assert eng.results[rid].tokens.tolist() == ref
        assert eng.results[rid].finish == "length"
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0 and eng._reserved == 0


def test_steady_tick_uploads_nothing(pair, monkeypatch):
    _, tm = pair
    eng = ServingEngine(tm, **ENGINE)
    prompts = np.random.RandomState(2).randint(3, 256, (2, 5))
    for p in prompts:
        eng.submit(Request(p, max_new_tokens=8))
    eng.step()                               # admit, upload, first decode
    uploads = []
    real = eng._up
    monkeypatch.setattr(eng, "_up", lambda a: uploads.append(a) or real(a))
    for _ in range(4):                       # positions 6..9: one block
        eng.step()
    assert uploads == [] and not eng._dirty
    assert eng.stats["steps"] == 5
    eng.drain()
    assert all(len(r.tokens) == 8 for r in eng.results.values())


def test_drain_raises_pool_exhausted_on_stall(pair):
    _, tm = pair
    # 3 usable blocks; the request needs 4 at worst. submit's check is
    # optimistic about prefix sharing (2 prompt blocks could be shared),
    # so it queues, and admission can never place it.
    eng = ServingEngine(tm, **ENGINE, num_blocks=4)
    eng.submit(Request(np.arange(3, 43), max_new_tokens=20))
    with pytest.raises(PoolExhausted, match="stalled"):
        eng.drain()
    with pytest.raises(PoolExhausted):
        eng.submit(Request(np.arange(3, 13), max_new_tokens=60))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(Request(np.arange(3, 100), max_new_tokens=60))


def test_deadline_retires_and_generate_convenience(pair):
    _, tm = pair
    p = np.random.RandomState(7).randint(3, 256, (10,))
    eng = ServingEngine(tm, **ENGINE, prefix_caching=False)
    rid = eng.submit(Request(p, max_new_tokens=64, deadline_s=1e-9))
    eng.step()
    res = eng.results[rid]
    assert res.finish == "deadline" and len(res.tokens) >= 1
    assert eng.pool.used_blocks == 0 and eng._reserved == 0
    rows = eng.generate([p, p[:6]], max_new_tokens=5)
    assert [r.tolist() for r in rows] == [
        list(p) + _isolated(tm, [p], [5])[0],
        list(p[:6]) + _isolated(tm, [p[:6]], [5])[0]]
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(p)


def test_request_validation_and_unported_options(pair):
    """Bad requests raise ValueError; the options still unported (Queue A
    items 7 and 8) raise NotImplementedError naming ROADMAP; the int8 pool
    and a weight-only int8 model are ported: their engines serve."""
    _, tm = pair
    for bad in (dict(prompt=[]), dict(prompt=[1.5]),
                dict(prompt=[1], max_new_tokens=0),
                dict(prompt=[1], max_new_tokens=True),
                dict(prompt=[1], seed=1.0),
                dict(prompt=[1], deadline_s=0),
                dict(prompt=[1], priority="urgent")):
        with pytest.raises(ValueError):
            Request(**bad)
    big = Request([1], request_id=10 ** 6).request_id
    assert Request([1]).request_id > big    # the id source moves past it
    draft = tserving.SpecConfig(k=2, proposer="draft", draft_model=tm)
    for kw in (dict(chunk_tokens=16),
               dict(speculate=draft), dict(offload=True),
               dict(mesh=object()), dict(sanitize=True),
               dict(max_queue=4), dict(shed_infeasible=True),
               dict(flight_dump_path="x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tm, **ENGINE, **kw)
    # any arch but llama and gpt is refused, as in the reference
    import dataclasses
    from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
    moe = MixtralForCausalLM(dataclasses.replace(
        MixtralConfig.tiny(), num_experts=8), device="cpu", seed=0)
    with pytest.raises(ValueError, match="llama/gpt"):
        ServingEngine(moe, **ENGINE)
    with pytest.raises(ValueError, match="multiple"):
        ServingEngine(tm, **dict(ENGINE, max_seq_len=120))
    with pytest.raises(ValueError, match="bf16-width or int8"):
        ServingEngine(tm, **ENGINE, cache_dtype=torch.float32)
    # ported: the int8 pool, and an int8-weight model over either pool
    import copy
    from paddle_tpu_torch.quantization import quantize_model
    qm = quantize_model(copy.deepcopy(tm))
    for model, dt in ((tm, torch.int8), (qm, torch.bfloat16),
                      (qm, torch.int8)):
        e8 = ServingEngine(model, **ENGINE, cache_dtype=dt)
        rid = e8.submit(Request(np.arange(3, 20), max_new_tokens=3))
        e8.drain()
        assert len(e8.results[rid].tokens) == 3
        assert e8.kv_pool.dtype == dt
    eng = ServingEngine(tm, **ENGINE)
    for call in (eng.snapshot, lambda: eng.save_snapshot("x"),
                 lambda: ServingEngine.restore(tm, {})):
        with pytest.raises(NotImplementedError, match="snapshot"):
            call()


def test_gpt_engine_runs_on_cpu_with_counters_at_zero():
    """A GPT (arch gpt, ported) serves on CPU tensors through the paged
    plain step: K5, K2 and K1 count no launch, no block leaks."""
    from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
    from paddle_tpu_torch.ops import flash_attention as tfa
    gpt = GPTPretrainModel(GPTConfig.tiny(vocab_size=256),
                           dtype=torch.bfloat16, device="cpu", seed=0)
    gpt.eval()
    for c in (tfd.fused_paged_decode_cuda, tfd.fused_decode_cuda,
              tfa.flash_attention_fwd):
        c.launches = 0
    eng = ServingEngine(gpt, **ENGINE, temperature=0.7, top_k=10)
    prompts = np.random.RandomState(1).randint(0, 256, (4, 9))
    rids = [eng.submit(Request(p, max_new_tokens=5)) for p in prompts]
    eng.drain()
    assert eng.arch == "gpt"
    assert all(len(eng.results[r].tokens) == 5 for r in rids)
    assert tfd.fused_paged_decode_cuda.launches == 0
    assert tfd.fused_decode_cuda.launches == 0
    assert tfa.flash_attention_fwd.launches == 0
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0
