"""The causal sliding window (Mistral) of paddle_tpu_torch against paddle_tpu.

Under a window w the query at absolute position p sees the keys
p - w < k <= p (the reference's ``q_pos + off - k_pos < window``). On the
CPU the port's attention runs its plain versions, held here to the JAX
package's XLA path (``_xla_attention(window=...)``,
``scaled_dot_product_attention(window_size=...)``), which is what the JAX
package itself runs on the CPU, on the same numpy inputs:

* the plain K1 (``flash_attention_fwd`` on CPU tensors) and the dispatch
  over windows 1, 5, 128, 200 and one past every key, a causal offset
  inside a 128-key tile, sq = 1 with kv_lens, GQA 4, head dims 64 and
  128: out at atol 1e-5 (fp32 sums in another order), lse against the
  log-sum-exp of the visible scores computed in numpy (rtol 1e-6, atol
  1e-5);
* the plain backward against ``jax.vjp`` of the XLA path (atol 1e-5);
* the windowed LlamaAttention (no-cache and cache branches) and a tiny
  windowed Llama (window 5, prompt 12, 16 new, fp32) through both
  packages' ``generate``: logits at atol 1e-5, greedy and sampled tokens
  identical;
* the refusals: the fused decode plans of a windowed Llama and Mixtral
  are None in both packages, so ``generate(cache_dtype=int8)`` and the
  serving engine refuse a windowed model as the reference does;
* on non-CPU tensors a windowed call that needs a gradient hands the
  window to K1, K3 and K4, and K3's and K4's C entry points take it (meta
  tensors, no launch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.inference import generate as jgenerate
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from paddle_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.inference import prefill as tprefill
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     MixtralConfig, MixtralForCausalLM)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_decode as tfd
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils.convert import load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _qkv(seed, b, sq, sk, h, nkv, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32))


def _visible(sq, sk, off, window, lens):
    """(b, sq, sk) bool: off + i - window < k <= off + i, k < lens[b]."""
    q_pos = off + np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    m = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return m[None] & (k_pos[None] < np.asarray(lens)[:, None, None])


def _lse_ref(q, k, mask):
    """log-sum-exp of the visible scaled scores, -1e30 where none."""
    h, nkv, d = q.shape[2], k.shape[2], q.shape[3]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, h // nkv, axis=2).astype(np.float64))
    s = np.where(mask[:, None], s / np.sqrt(d), -np.inf)
    with np.errstate(invalid="ignore"):
        mx = s.max(-1, keepdims=True)
        ref = np.log(np.exp(s - mx).sum(-1)) + mx[..., 0]
    return np.where(mask.any(-1)[:, None], ref, -1e30)


WINDOWS = [1, 5, 128, 200, 10_000]       # the last is past every key
# (b, h, nkv, sq, sk, d, kv_lens): bottom-right aligned, so the causal
# offset is sk - sq: 191 (inside a 128-key tile), 0, and sq = 1 decode
# rows of different kv_lens (row 1 ends inside the window of its query,
# row 2 holds one key: with a small window its rows see nothing)
SHAPES = [
    (2, 4, 1, 9, 200, 64, None),
    (2, 8, 2, 130, 130, 128, None),
    (3, 4, 1, 1, 300, 128, [300, 150, 1]),
]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("b,h,nkv,sq,sk,d,lens", SHAPES,
                         ids=[f"sq{c[3]}-sk{c[4]}-d{c[5]}" for c in SHAPES])
def test_plain_k1_window_matches_jax(window, b, h, nkv, sq, sk, d, lens):
    """The plain K1 (flash_attention_fwd on CPU tensors) and the port's
    _xla_attention against the reference's _xla_attention(window=w): out
    at atol 1e-5 (rows with no visible key give 0 in both), lse against
    the visible scores' log-sum-exp."""
    q, k, v = _qkv(window + sq, b, sq, sk, h, nkv, d)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    oj = np.asarray(jfa._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
        kv_lens=jl, window=window))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    ox = tfa._xla_attention(tq, tk, tv, is_causal=True, kv_lens=tl,
                            window=window)
    np.testing.assert_allclose(ox.numpy(), oj, atol=ATOL)
    tfa.flash_attention_fwd.launches = 0
    ot, lse = tfa.flash_attention_fwd(tq, tk, tv, is_causal=True,
                                      kv_lens=tl, window=window)
    np.testing.assert_allclose(ot.numpy(), oj, atol=ATOL)
    mask = _visible(sq, sk, sk - sq, window, [sk] * b if lens is None
                    else lens)
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, mask),
                               rtol=1e-6, atol=1e-5)
    assert tfa.flash_attention_fwd.launches == 0   # CPU: no kernel launch


@pytest.mark.parametrize("start,s,window", [
    (0, 12, 5), (7, 5, 5), (11, 1, 5), (190, 1, 64), (150, 9, 128),
    (0, 12, 100)])
def test_cache_form_matches_reference_mask(start, s, window):
    """The cache path: the reference's dense mask (k_pos <= start + i and
    k_pos > start + i - window over the whole cache) against the port's
    structured arguments (causal_offset=start, kv_lens=start+s,
    window_size=window) — what LlamaAttention passes — through both
    dispatches and the plain K1, GQA 4 at d 64."""
    total = 200
    q, k, v = _qkv(3 + start, 2, s, total, 8, 2, 64)
    k[:, start + s:] = 1e3          # the unfilled tail must not leak in
    mask = _visible(s, total, start, window, [start + s] * 2)
    oj = np.asarray(jfa.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=jnp.asarray(mask[:, None])))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    kw = dict(is_causal=True, causal_offset=start, kv_lens=start + s)
    ot = tfa.scaled_dot_product_attention(tq, tk, tv, window_size=window,
                                          **kw)
    np.testing.assert_allclose(ot.numpy(), oj, atol=ATOL)
    of, lse = tfa.flash_attention_fwd(tq, tk, tv, window=window, **kw)
    np.testing.assert_allclose(of.numpy(), oj, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, mask),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("window", [1, 7, 40])
def test_dispatch_window_size_matches_jax(window):
    """scaled_dot_product_attention(window_size=w), no-cache self-attention
    (as the training forward calls it), against the reference's."""
    q, k, v = _qkv(11, 2, 40, 40, 4, 4, 32)
    oj = np.asarray(jfa.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
        window_size=window))
    ot = tfa.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), is_causal=True,
        window_size=window)
    np.testing.assert_allclose(ot.numpy(), oj, atol=ATOL)


@pytest.mark.parametrize("window", [1, 6, 64])
def test_plain_backward_through_window_matches_jax_vjp(window):
    """On CPU tensors that require grad the dispatch takes FlashAttention
    (the plain forward and backward): dq, dk, dv with the window equal
    jax.vjp of the reference's XLA path (atol 1e-5; GQA 2)."""
    q, k, v = _qkv(21, 2, 24, 30, 4, 2, 16)
    do = np.random.RandomState(22).randn(*q.shape).astype(np.float32)
    fj = lambda q_, k_, v_: jfa._xla_attention(q_, k_, v_, is_causal=True,
                                               window=window)
    oj, vjp = jax.vjp(fj, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gj = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True)
                  for t in (q, k, v))
    ot = tfa.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                          window_size=window)
    ot.backward(torch.from_numpy(do))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               atol=ATOL)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_window_validation_as_the_reference():
    q = np.zeros((1, 4, 2, 8), np.float32)
    tq = torch.from_numpy(q)
    for kw, msg in ((dict(is_causal=False, window_size=4), "is_causal"),
                    (dict(is_causal=True, window_size=0), ">= 1")):
        with pytest.raises(ValueError, match=msg):
            jfa.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(q),
                                             jnp.asarray(q), **kw)
        with pytest.raises(ValueError, match=msg):
            tfa.scaled_dot_product_attention(tq, tq, tq, **kw)
    with pytest.raises(ValueError, match="is_causal"):
        tfa.flash_attention_fwd(tq, tq, tq, window=3)


def test_windowed_backward_on_the_card_passes_the_window_to_k3_and_k4(
        monkeypatch):
    """On a non-CPU tensor a windowed call that needs a gradient runs K1
    forward and K3/K4 backward, each given the window: nothing refuses it
    and nothing falls back (meta tensors take the CUDA tensors' path; the
    three wrappers are replaced by recorders that launch nothing)."""
    calls = {}

    def recorder(name, result):
        def call(*args, **kw):
            calls.setdefault(name, []).append(kw)
            return result(*args)
        return call

    meta = lambda *shape, dt=torch.bfloat16: torch.empty(
        *shape, dtype=dt, device="meta")
    b, s, h, nkv, d, w = 1, 200, 4, 2, 64, 37
    monkeypatch.setattr(tfa, "flash_attention_fwd", recorder(
        "fwd", lambda q, k, v: (meta(b, s, h, d), meta(b, h, s,
                                                        dt=torch.float32))))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", recorder(
        "dq", lambda q, *a: meta(*q.shape)))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", recorder(
        "dkv", lambda q, k, *a: (meta(*k.shape), meta(*k.shape))))
    q = meta(b, s, h, d).requires_grad_(True)
    k, v = (meta(b, s, nkv, d).requires_grad_(True) for _ in range(2))
    out = tfa.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           window_size=w)
    out.backward(meta(b, s, h, d))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert set(calls) == {"fwd", "dq", "dkv"}
    for name in calls:
        assert [c["window"] for c in calls[name]] == [w], name
        assert all(c["is_causal"] for c in calls[name])


class _Captured(Exception):
    pass


def test_k3_k4_entry_points_take_the_window(monkeypatch):
    """K3's and K4's wrappers check their inputs and hand the C entry
    points the window as the int after the causal offset (0 without one,
    clamped to 2^30); a window without is_causal, or below 1, raises before
    any launch. The tensors are meta tensors taken as the kernels' device;
    the C entry points are recorders that raise, so nothing launches and
    the launch counters stay 0."""
    from paddle_tpu_torch.ops import _build
    ints = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                ints[name] = [a for a in args if isinstance(a, int)]
                raise _Captured
            return entry

    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        fn.launches = fn.windowed = 0
    b, sq, sk, h, nkv, d = 2, 65, 333, 8, 2, 128
    q, do = (torch.empty(b, sq, h, d, dtype=torch.bfloat16, device="meta")
             for _ in range(2))
    k, v = (torch.empty(b, sk, nkv, d, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    rows = torch.empty(b, h, sq, device="meta")
    for window, want in ((4096, 4096), (None, 0), (1 << 40, 1 << 30),
                         (1, 1)):
        for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
            with pytest.raises(_Captured):
                fn(q, k, v, do, rows, rows, is_causal=True,
                   causal_offset=200, window=window)
            # then the dropout arguments: none (no keep words, 0 words a
            # row)
            assert ints[fn.__name__] == [b, sq, sk, h, nkv, d, 1, 200,
                                         want, 0]
    for kw in (dict(is_causal=False, window=5), dict(is_causal=True,
                                                     window=0)):
        for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError):
                fn(q, k, v, do, rows, rows, **kw)
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        assert fn.launches == 0 and fn.windowed == 0


# ---- models ---------------------------------------------------------------------

WINDOW, PROMPT, NEW, B = 5, 12, 16, 2


@pytest.fixture(scope="module")
def windowed_pair():
    """The JAX tiny Llama with a 5-key window, carried into the port."""
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), sliding_window=WINDOW)
    jm = JLlama(jcfg)
    cfg = dataclasses.replace(LlamaConfig.tiny(), sliding_window=WINDOW)
    tm = LlamaForCausalLM(cfg, device="cpu", seed=0)
    load_jax_state(tm, {k: np.asarray(v) for k, v in
                        jm.state_dict(include_buffers=False).items()})
    return cfg, jm, tm


def _ids(seed, b=B, s=PROMPT):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)


def test_mistral_7b_config_equals_reference():
    """mistral_7b() equals the reference's, field by field (the fields the
    port's LlamaConfig has)."""
    ref = JLlamaConfig.mistral_7b()
    got = LlamaConfig.mistral_7b()
    for f in dataclasses.fields(LlamaConfig):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert (got.head_dim, got.kv_heads) == (ref.head_dim, ref.kv_heads)
    assert got.sliding_window == 4096 and got.rope_base == 10000.0


def test_windowed_attention_layer_both_branches(windowed_pair):
    """LlamaAttention of layer 0 on the same weights and input: the
    no-cache branch (window_size to the dispatch) and the cache branch
    (prefill into a cache, then two one-token steps: causal offset,
    kv_lens and the window) against the JAX module's dense-mask path."""
    cfg, jm, tm = windowed_pair
    ja, ta = jm.model.layers[0].self_attn, tm.model.layers[0].self_attn
    x = np.random.RandomState(31).randn(B, PROMPT, cfg.hidden_size).astype(
        np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(ta(torch.from_numpy(x)).numpy(),
                                   np.asarray(ja(jnp.asarray(x))), atol=ATOL)
    total = PROMPT + 4
    shape = (B, total, cfg.kv_heads, cfg.head_dim)
    cj = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    ct = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    steps = [(x, 0)] + [(np.random.RandomState(32 + i).randn(
        B, 1, cfg.hidden_size).astype(np.float32), PROMPT + i)
        for i in range(2)]
    for xs, start in steps:
        oj, cj = ja(jnp.asarray(xs), cache=cj, start_pos=start)
        with torch.no_grad():
            ot, ct = ta(torch.from_numpy(xs), cache=ct, start_pos=start)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]),
                               atol=ATOL)


def test_windowed_state_loads_and_logits_match(windowed_pair):
    """The JAX state of a windowed tiny Llama loads by name (Mistral's names
    are Llama's) and the port computes the JAX model's logits: no-cache
    forward, and the cache forward (prefill, then one step)."""
    cfg, jm, tm = windowed_pair
    assert list(tm.state_dict(include_buffers=False)) == \
        list(jm.state_dict(include_buffers=False))
    ids = _ids(1)
    lj = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(lt, lj, atol=ATOL)
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
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL)
    np.testing.assert_allclose(ot2.numpy(), np.asarray(oj2), atol=ATOL)
    # the window bites: the unwindowed model's logits part past it
    full = dataclasses.replace(cfg, sliding_window=None)
    tm.cfg = full
    for layer in tm.model.layers:
        layer.self_attn.cfg = full
    try:
        with torch.no_grad():
            lf = tm(torch.from_numpy(ids).long()).numpy()
    finally:
        tm.cfg = cfg
        for layer in tm.model.layers:
            layer.self_attn.cfg = cfg
    np.testing.assert_allclose(lf[:, :WINDOW], lt[:, :WINDOW], atol=ATOL)
    assert np.abs(lf[:, WINDOW:] - lt[:, WINDOW:]).max() > 1e-3


@pytest.mark.parametrize("kw", [
    dict(),                                                     # greedy
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
    dict(temperature=1.3, request_seeds=[11, 4000000000]),
])
def test_windowed_generate_tokens_identical(windowed_pair, kw):
    """A tiny windowed Llama (window 5, prompt 12, 16 new tokens, fp32
    weights and cache) through both packages' generate: both take the
    layered path (the fused plan refuses a window) and give the same
    tokens, greedy and sampled."""
    _, jm, tm = windowed_pair
    ids = _ids(2)
    oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=NEW,
                              cache_dtype=jnp.float32, **kw))
    ot = tgenerate(tm, ids, max_new_tokens=NEW, cache_dtype=torch.float32,
                   **kw).numpy()
    assert ot.tolist() == oj.tolist()


def test_windowed_generate_runs_layered_attention_with_window(windowed_pair,
                                                              monkeypatch):
    """generate (default bf16 cache) of a windowed model: every attention
    call carries the window — the prompt once a layer (sq 12), then every
    decode step once a layer (sq 1) — and the fused step never runs."""
    cfg, _, tm = windowed_pair
    calls = []
    sdpa = tfa.scaled_dot_product_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw.get("window_size"),
                      kw.get("causal_offset")))
        return sdpa(q, k, v, **kw)

    def no_fused(*a, **kw):
        raise AssertionError("the fused decode step ran for a windowed model")

    monkeypatch.setattr(tfa, "scaled_dot_product_attention", spy)
    monkeypatch.setattr(tfd, "fused_decode_step", no_fused)
    out = tgenerate(tm, _ids(3), max_new_tokens=NEW)
    assert tuple(out.shape) == (B, PROMPT + NEW)
    L = cfg.num_layers
    assert [c[0] for c in calls] == [PROMPT] * L + [1] * (L * (NEW - 1))
    assert {c[1] for c in calls} == {WINDOW}
    assert [c[2] for c in calls[L::L]] == list(range(PROMPT, PROMPT + NEW - 1))


def test_windowed_models_are_refused_where_the_reference_refuses(
        windowed_pair):
    """The fused plans of a windowed Llama and a windowed Mixtral are None
    in both packages; so generate(cache_dtype=int8) raises ValueError and
    the serving engine refuses the model, in both packages."""
    cfg, jm, tm = windowed_pair
    sj = jm.state_dict(include_buffers=False)
    st = tm.state_dict(include_buffers=False)
    assert jm.fused_decode_plan(sj, probe=True) is None
    assert tm.fused_decode_plan(st, probe=True) is None
    assert tm.fused_decode_plan(st) is None
    with pytest.raises(ValueError, match="int8"):
        jgenerate(jm, jnp.asarray(_ids(4)), max_new_tokens=2,
                  cache_dtype=jnp.int8)
    with pytest.raises(ValueError, match="int8"):
        tgenerate(tm, _ids(4), max_new_tokens=2, cache_dtype=torch.int8)
    engine = dict(max_slots=2, block_tokens=16, max_seq_len=64)
    with pytest.raises(ValueError, match="fused_decode_plan"):
        jserving.ServingEngine(jm, **engine)
    with pytest.raises(ValueError, match="fused_decode_plan"):
        ServingEngine(tm, device="cpu", **engine)
    # the same model without the window rides the plan (the refusal is the
    # window's)
    plain = dataclasses.replace(cfg, sliding_window=None)
    assert LlamaForCausalLM(plain, device="cpu", seed=0).fused_decode_plan(
        st, probe=True) is not None
    # Mixtral: E % 8 == 0, so only the window refuses the plan
    mk = dict(num_experts=8, sliding_window=WINDOW)
    jmx = JMixtral(dataclasses.replace(JMixtralConfig.tiny(), **mk))
    tmx = MixtralForCausalLM(dataclasses.replace(MixtralConfig.tiny(), **mk),
                             device="cpu", seed=0)
    assert jmx.fused_decode_plan(jmx.state_dict(include_buffers=False),
                                 probe=True) is None
    tsx = tmx.state_dict(include_buffers=False)
    assert tmx.fused_decode_plan(tsx, probe=True) is None
    tmx.cfg = dataclasses.replace(tmx.cfg, sliding_window=None)
    assert tmx.fused_decode_plan(tsx, probe=True) is not None
