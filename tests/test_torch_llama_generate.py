"""Llama and generate() of paddle_tpu_torch against paddle_tpu, tiny GQA model.

The JAX model's weights are carried across with utils/convert.py, so both
packages run the same weights on the same numpy prompts and seeds.

* fp32 model: forward and cache-forward logits agree (atol 1e-5), and the
  greedy AND sampled tokens of generate (fp32 cache: the layered path) are
  identical — the threefry port draws the same tokens.
* bf16 model, bf16 cache (the fused decode path): per-step teacher-forced
  logits agree within atol 2e-2 + 2^-6·|logit| (bf16 logits, one or two
  ulp, plus intermediates rounded on either side of a boundary).
* eos trimming and return_lengths agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import generate as jgenerate
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.ops import fused_decode as jfd
from paddle_tpu.ops.rope import rope_cos_sin as jrope
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.inference import prefill as tprefill
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
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


B, PROMPT, NEW = 2, 7, 6


def _pair(bf16=False):
    jm = JLlama(JLlamaConfig.tiny())
    if bf16:
        jm = jm.bfloat16()
    cfg = LlamaConfig.tiny()
    tm = LlamaForCausalLM(cfg, device="cpu", seed=0,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return cfg, jm, tm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _ids(seed=0, b=B, s=PROMPT):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)


def test_state_keys_equal(fp32_pair):
    _, jm, tm = fp32_pair
    assert list(tm.state_dict(include_buffers=False)) == \
        list(jm.state_dict(include_buffers=False))


def test_forward_and_cache_forward_logits(fp32_pair):
    cfg, jm, tm = fp32_pair
    ids = _ids(1)
    lj = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    total = PROMPT + 3
    cj = jm.init_cache(B, total, dtype=jnp.float32)
    oj, cj = jm(jnp.asarray(ids), cache=cj, start_pos=0)
    nxt = np.argmax(np.asarray(oj)[:, -1], -1).astype(np.int32)[:, None]
    oj2, _ = jm(jnp.asarray(nxt), cache=cj, start_pos=PROMPT)
    with torch.no_grad():
        ot, ct = tprefill(tm, torch.from_numpy(ids).long(), total,
                          cache_dtype=torch.float32)
        ot2, _ = tm(torch.from_numpy(nxt).long(), cache=ct,
                    start_pos=PROMPT)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(ot2.numpy(), np.asarray(oj2), atol=1e-5)


def test_cache_forward_takes_and_ignores_attn_mask(fp32_pair):
    """A cache forward given an attn_mask (once refused) takes it and
    ignores it, as the reference's cache path does: the prefill and the
    next step give the reference's logits with the same mask passed
    (atol 1e-5), and the logits without a mask."""
    cfg, jm, tm = fp32_pair
    ids = _ids(2)
    total = PROMPT + 3
    mask = np.random.RandomState(3).rand(B, 1, PROMPT, PROMPT) > 0.5
    cj = jm.init_cache(B, total, dtype=jnp.float32)
    oj, cj = jm(jnp.asarray(ids), jnp.asarray(mask), cache=cj, start_pos=0)
    nxt = np.argmax(np.asarray(oj)[:, -1], -1).astype(np.int32)[:, None]
    oj2, _ = jm(jnp.asarray(nxt), jnp.asarray(mask[..., :1, :1]), cache=cj,
                start_pos=PROMPT)
    with torch.no_grad():
        ct = tm.init_cache(B, total, dtype=torch.float32)
        ot, ct = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    cache=ct, start_pos=0)
        ot2, _ = tm(torch.from_numpy(nxt).long(),
                    torch.from_numpy(mask[..., :1, :1]), cache=ct,
                    start_pos=PROMPT)
        plain, _ = tm(torch.from_numpy(ids).long(),
                      cache=tm.init_cache(B, total, dtype=torch.float32),
                      start_pos=0)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(ot2.numpy(), np.asarray(oj2), atol=1e-5)
    assert torch.equal(ot, plain)


@pytest.mark.parametrize("kw", [
    dict(),                                                    # greedy
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
    dict(temperature=1.3, top_p=0.7, request_seeds=[11, 4000000000]),
])
def test_generate_tokens_identical_fp32(fp32_pair, kw):
    _, jm, tm = fp32_pair
    ids = _ids(2)
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                              cache_dtype=jnp.float32, **kw))
    ot = tgenerate(tm, ids, max_new_tokens=NEW, cache_dtype=torch.float32,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()


def test_eos_trim_and_lengths(fp32_pair):
    _, jm, tm = fp32_pair
    ids = _ids(3)
    free = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                                cache_dtype=jnp.float32))
    eos = int(free[0, PROMPT + 2])          # row 0 hits eos at step 2
    oj, lj = jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                       cache_dtype=jnp.float32, eos_token_id=eos,
                       return_lengths=True)
    ot, lt = tgenerate(tm, ids, max_new_tokens=NEW, cache_dtype=torch.float32,
                       eos_token_id=eos, return_lengths=True)
    assert ot.numpy().tolist() == np.asarray(oj).tolist()
    assert lt.tolist() == np.asarray(lj).tolist() and lt.dtype == np.int32


def test_bf16_fused_path_teacher_forced_logits():
    cfg, jm, tm = _pair(bf16=True)
    ids = _ids(4)
    total = 128                  # the fused path pads the cache to 128
    steps = 5
    toks = np.random.RandomState(5).randint(0, 256, (steps, B))
    state = jm.state_dict(include_buffers=False)
    plan_j = jm.fused_decode_plan(state)
    cache = jm.init_cache(B, total, dtype=jnp.bfloat16)
    _, cache = functional_call(jm, state, jnp.asarray(ids), cache=cache,
                               start_pos=0)
    kv_j = jnp.stack([jnp.concatenate(
        [c["k"].reshape(B, total, -1), c["v"].reshape(B, total, -1)], -1)
        for c in cache])
    cj, sj = jrope(total, cfg.head_dim)
    ct, st = trope(total, cfg.head_dim)
    plan_t = tm.fused_decode_plan(tm.state_dict(include_buffers=False))
    with torch.no_grad():
        _, kv_t = tprefill(tm, torch.from_numpy(ids).long(), total,
                           fused=True)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
              eps=cfg.rms_norm_eps)
    step_j = jax.jit(lambda x, kv, pos, c, s: jfd.fused_decode_step(
        x, plan_j["params"], kv, pos, c, s, **kw))
    for i in range(steps):
        pos = PROMPT + i
        xj, kv_j = step_j(plan_j["embed"](jnp.asarray(toks[i]), pos), kv_j,
                          pos, cj[pos:pos + 1], sj[pos:pos + 1])
        lj = np.asarray(plan_j["head"](xj), np.float32)
        with torch.no_grad():
            xt, kv_t = tfd.fused_decode_step(
                plan_t["embed"](torch.from_numpy(toks[i]), pos),
                plan_t["params"], kv_t, pos, ct[pos:pos + 1],
                st[pos:pos + 1], **kw)
            lt = plan_t["head"](xt).float().numpy()
        np.testing.assert_allclose(lt, lj, atol=2e-2, rtol=2 ** -6)


def test_bf16_generate_runs_fused_path_on_cpu():
    """The default bf16 generate takes the fused path (plain version on
    the CPU) and agrees with its own layered path on the greedy tokens'
    shape and range; no kernel is launched on CPU tensors."""
    _, _, tm = _pair(bf16=True)
    ids = _ids(6)
    out = tgenerate(tm, ids, max_new_tokens=NEW)
    assert tuple(out.shape) == (B, PROMPT + NEW)
    assert out[:, :PROMPT].numpy().tolist() == ids.tolist()
    assert int(out.max()) < 256 and int(out.min()) >= 0
    assert tfd.fused_decode_cuda.launches == 0


def test_unported_generate_options_raise(fp32_pair):
    _, _, tm = fp32_pair
    ids = _ids(7)
    for kw in (dict(deadline_s=1.0), dict(_kv_chunk=32)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tgenerate(tm, ids, max_new_tokens=2, **kw)
