"""Dropout in paddle_tpu_torch against paddle_tpu, on the CPU.

Hidden dropout (``nn.functional.dropout``, ``nn.Dropout``) and attention
dropout (``scaled_dot_product_attention(dropout_p=...)``) draw their masks
from the named "dropout" stream; with the same key bound on both sides
(``rng_guard(dropout=key)`` here, ``functional_call(..., rngs=...)`` there)
the port's masks are the reference's bit for bit, so:

* hidden dropout's outputs and gradients are bit-equal, fp32 and bf16;
* attention outputs agree within 1e-5 and gradients within 1e-4 (fp32;
  the two frameworks sum the same fp32 products in other orders, which
  leaves ~1e-6 here);
* a tiny GPT with dropout 0.1/0.1 gives the reference's loss (atol 1e-5)
  and gradients (atol 1e-5), and three train steps the reference's losses
  (rtol 1e-5);
* recompute replays the forward's keys.

The JAX side runs its XLA attention path, as on any CPU. The CUDA kernels'
dropout arguments are checked on meta tensors taken as the kernels'
device (nothing launches).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import rng as jrng
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainModel as JGPT
from paddle_tpu.nn import Dropout as JDropout
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import bench
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
from paddle_tpu_torch.nn import Dropout as TDropout
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import dropout as tdrop
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import recompute as rc
from paddle_tpu_torch.utils.convert import load_jax_state

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---- hidden dropout ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f_dropout_bit_equal(dtype, p, mode):
    """Training: two draws under one bound key (the stream's counter
    advances), their outputs and the gradient of a weighted sum bit-equal
    to the reference's; p = 1 gives zeros, no NaN. (At p = 1 in
    upscale_in_train the reference's gradient is NaN, its VJP dividing a
    zero cotangent by keep = 0; the port's is the derivative, zeros.)
    Eval: the identity, or x · (1 - p) in x's dtype for
    downscale_in_infer."""
    x = np.random.RandomState(0).randn(3, 5, 37).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 5, 37).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jf(a):
        with jrng.rng_guard(dropout=key):
            y1 = JF.dropout(a, p, training=True, mode=mode)
            y2 = JF.dropout(a, p, training=True, mode=mode)
        return y1, y2

    (y1j, y2j), pull = jax.vjp(jf, jnp.asarray(x).astype(jdt))
    gj = pull((jnp.asarray(w).astype(jdt), jnp.asarray(w).astype(jdt)))[0]
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    with trng.rng_guard(dropout=_t(key)) as frame:
        y1t = TF.dropout(xt, p, training=True, mode=mode)
        y2t = TF.dropout(xt, p, training=True, mode=mode)
    assert frame.counters == {"dropout": 2}
    wt = torch.from_numpy(w).to(tdt)
    torch.autograd.backward((y1t, y2t), (wt, wt))
    nan_grad = p == 1.0 and mode == "upscale_in_train"
    pairs = ((y1j, y1t), (y2j, y2t)) + (() if nan_grad else ((gj, xt.grad),))
    for a, b in pairs:
        assert b.dtype == tdt
        assert np.array_equal(_bits(a.astype(jnp.float32)),
                              _bits(b.detach().float().numpy()))
    assert not torch.isnan(y1t).any()
    if p == 1.0:
        assert not y1t.any() and not xt.grad.any()
    if nan_grad:
        assert bool(jnp.isnan(gj).all())
    ye = JF.dropout(jnp.asarray(x).astype(jdt), p, training=False, mode=mode)
    te = TF.dropout(torch.from_numpy(x).to(tdt), p, training=False, mode=mode)
    assert np.array_equal(_bits(ye.astype(jnp.float32)),
                          _bits(te.float().numpy()))


def test_dropout_layer_and_rng_name():
    """nn.Dropout(p, mode, name, rng_name): its stream, its training flag;
    the same output as the reference's layer under the same key."""
    x = np.random.RandomState(2).randn(4, 64).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jl = JDropout(0.3, mode="upscale_in_train", rng_name="noise")
    tl = TDropout(0.3, mode="upscale_in_train", name="d", rng_name="noise")
    with jrng.rng_guard(noise=key):
        yj = jl(jnp.asarray(x))
    with trng.rng_guard(noise=_t(key), dropout=trng.PRNGKey(0)) as frame:
        yt = tl(torch.from_numpy(x))
    assert frame.counters == {"noise": 1}
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    tl.eval()
    assert torch.equal(tl(torch.from_numpy(x)), torch.from_numpy(x))


def test_dropout_draws_from_the_global_generator_without_a_stream():
    """With no frame bound, a dropout draws the global generator's next key
    (the reference's eager fallback)."""
    paddle_tpu.seed(3)
    trng.seed(3)
    x = np.ones((5, 9), np.float32)
    yj = JF.dropout(jnp.asarray(x), 0.5)
    yt = TF.dropout(torch.from_numpy(x), 0.5)
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    assert trng.get_rng_state() == jrng.get_rng_state() == (3, 1)


# ---- the kernels' mask ------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5, 0.97])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 17, 130)])
def test_attention_keep_mask_is_the_reference_mask(p, shape):
    """The flat-index mask the kernels implement (attention_keep_mask: each
    (b, h, q, k) hashes ((b·h + hi)·sq + q)·sk + k) equals uniform(key,
    (b, h, sq, sk)) < keep and jax.random.bernoulli(key, keep, shape)."""
    key = jax.random.fold_in(jax.random.PRNGKey(6), 1)
    m = tdrop.attention_keep_mask(_t(key), p, *shape)
    u = trng.uniform(_t(key), shape) < float(np.float32(1.0 - p))
    assert torch.equal(m, u)
    assert torch.equal(m, tdrop.keep_mask(_t(key), p, shape))
    assert np.array_equal(m.numpy(), np.asarray(
        jax.random.bernoulli(key, 1.0 - p, shape)))


def test_keep_threshold_edges():
    """p = 0 keeps every 23-bit value, p = 1 none; the threshold is the
    float32 keep times 2^23, rounded up."""
    assert tdrop.keep_threshold(0.0) == 2 ** 23
    assert tdrop.keep_threshold(1.0) == 0
    assert tdrop.keep_threshold(0.1) == int(np.ceil(
        np.float64(np.float32(0.9)) * 2 ** 23))


# ---- attention dropout -------------------------------------------------------------

# (b, sq, sk, h, nkv, d, causal, kv_lens, window)
ATTN_CASES = [
    (2, 9, 9, 4, 4, 16, True, None, None),        # causal
    (2, 6, 13, 4, 4, 32, False, None, None),      # non-causal, sq < sk
    (2, 8, 8, 4, 2, 16, True, None, None),        # GQA
    (3, 6, 10, 4, 2, 16, False, [10, 4, 0], None),  # kv_lens, a row of 0
    (2, 17, 17, 4, 2, 16, True, None, 5),         # window, GQA
    (2, 5, 12, 2, 1, 32, True, [9, 12], None),    # causal with an offset
]
ATTN_IDS = [f"b{c[0]}-sq{c[1]}-sk{c[2]}-h{c[3]}-kv{c[4]}-d{c[5]}-"
            f"{'causal' if c[6] else 'full'}-{'lens' if c[7] else 'nolens'}"
            f"-w{c[8]}" for c in ATTN_CASES]


def _attn_inputs(case, seed=0):
    b, sq, sk, h, nkv, d = case[:6]
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sq, h, d).astype(np.float32))


def _ref_attention(case, key, q, k, v):
    causal, kv_lens, window = case[6:]
    with jrng.rng_guard(dropout=key):
        return jfa.scaled_dot_product_attention(
            q, k, v, is_causal=causal, dropout_p=0.1, window_size=window,
            kv_lens=None if kv_lens is None else jnp.asarray(kv_lens))


def _port_attention(case, key, q, k, v):
    causal, kv_lens, window = case[6:]
    with trng.rng_guard(dropout=key) as frame:
        out = tfa.scaled_dot_product_attention(
            q, k, v, is_causal=causal, dropout_p=0.1, window_size=window,
            kv_lens=None if kv_lens is None else torch.tensor(kv_lens))
    assert frame.counters == {"dropout": 1}
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_attention_dropout_no_grad(case):
    """No gradient: the plain attention with the draw's mask, and the
    kernels' plain forward twin (flash_attention_fwd on CPU tensors, with
    the same key), equal the reference's within 1e-5; the forward twin's
    lse is the undropped attention's."""
    q, k, v, _ = _attn_inputs(case)
    key = jax.random.PRNGKey(21)
    ref = np.asarray(_ref_attention(case, key, *(jnp.asarray(a)
                                                  for a in (q, k, v))))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with torch.no_grad():
        out = _port_attention(case, _t(key), tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), ref, atol=OUT_ATOL)
    causal, kv_lens, window = case[6:]
    kw = dict(is_causal=causal, window=window,
              kv_lens=None if kv_lens is None else torch.tensor(kv_lens))
    # the stream's first key is fold_in(key, 0)
    drawn = trng.fold_in(_t(key), 0)
    twin, lse = tfa.flash_attention_fwd(tq, tk, tv, dropout_p=0.1,
                                        key=drawn, **kw)
    _, lse0 = tfa.flash_attention_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(twin.numpy(), ref, atol=OUT_ATOL)
    assert torch.equal(lse, lse0)


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_attention_dropout_grad_path(case):
    """With a gradient: FlashAttention's plain forward and backward (the
    regenerated mask, dS = P∘(dP∘Z/keep − Δ), dv = (P∘Z/keep)ᵀ·dO) against
    jax.vjp of the reference under the same key: out within 1e-5, dq, dk
    and dv within 1e-4."""
    q, k, v, do = _attn_inputs(case, 1)
    key = jax.random.PRNGKey(22)
    ref, pull = jax.vjp(lambda *a: _ref_attention(case, key, *a),
                        *(jnp.asarray(a) for a in (q, k, v)))
    gref = pull(jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = _port_attention(case, _t(key), *t)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=OUT_ATOL)
    for name, g, r in zip("qkv", t, gref):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


def test_attention_dropout_eval_draws_nothing():
    """training=False (or dropout_p 0) draws no key and drops nothing, as
    in the reference."""
    q, k, v, _ = _attn_inputs(ATTN_CASES[0])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with trng.rng_guard(dropout=trng.PRNGKey(1)) as frame:
        a = tfa.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                             dropout_p=0.1, training=False)
        b = tfa.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    assert frame.counters == {}
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="key"):
        tfa.flash_attention_fwd(tq, tk, tv, dropout_p=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        tfa.scaled_dot_product_attention(tq, tk, tv, dropout_p=1.5)


class _Captured(Exception):
    pass


def test_kernel_entry_points_take_the_draw(monkeypatch):
    """On the kernels' device, K1's, K3's and K4's C entry points get the
    draw after the general argument as keep words (their pointer,
    ceil(sk / 128)·4 words a row, 1/keep in float32), made from the key by
    ops.dropout.attention_keep_words; without dropout no words, each the
    dropout-free instantiation. The dropout counters count only the
    dropout launches. (Meta tensors stand for CUDA tensors; the entry
    points raise, so nothing launches.)"""
    from paddle_tpu_torch.ops import _build
    got = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                got[name] = args
                raise _Captured
            return entry

    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    b, sq, sk, h, nkv, d = 2, 65, 333, 8, 2, 128
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt,
                                                     device="meta")
    q, do, k, v = meta(b, sq, h, d), meta(b, sq, h, d), meta(b, sk, nkv, d), \
        meta(b, sk, nkv, d)
    rows = meta(b, h, sq, dt=torch.float32)
    key = trng.fold_in(trng.PRNGKey(2 ** 31 - 1), 77)
    inv = float(np.float32(1) / np.float32(0.9))
    calls = ((tfa.flash_attention_fwd, (q, k, v)),
             (tfa.flash_attention_bwd_dq, (q, k, v, do, rows, rows)),
             (tfa.flash_attention_bwd_dkv, (q, k, v, do, rows, rows)))
    ww = tdrop.keep_words_width(sk)
    for fn, args in calls:
        fn.launches = fn.dropout = 0
        for p in (0.1, 0.0):
            with pytest.raises(_Captured):
                fn(*args, is_causal=True, dropout_p=p,
                   key=key if p else None)
            tail = got[fn.__name__]
            if p:
                # the words' pointer (0 on meta: shapes only), then W
                assert tail[-4].value is None and tail[-3:-1] == (ww, inv)
            else:
                assert tail[-4] is None and tail[-3:-1] == (0, 1.0)
        assert fn.launches == 0 and fn.dropout == 0
    assert tdrop.attention_keep_words.launches == 0


def test_dropout_wrapper_on_the_kernel_path(monkeypatch):
    """dropout_cuda on a CPU tensor is the plain version; on a non-CUDA,
    non-CPU tensor it raises before any launch; the C entry gets the key's
    words, the threshold and the divisor (keep in x's dtype, or 1 for
    downscale_in_infer)."""
    key = trng.PRNGKey(5)
    x = torch.randn(4, 8)
    assert torch.equal(tdrop.dropout_cuda(x, key, 0.2),
                       tdrop.dropout_plain(x, key, 0.2))
    with pytest.raises(ValueError, match="cuda"):
        tdrop.dropout_cuda(torch.empty(4, 8, device="meta"), key, 0.2)
    with pytest.raises(TypeError, match="float64"):
        tdrop.dropout_cuda(torch.empty(4, 8, dtype=torch.float64,
                                       device="meta"), key, 0.2)
    assert tdrop.dropout_cuda.launches == 0
    assert tdrop.keep_in_dtype(0.1, torch.bfloat16) == 0.8984375
    assert tdrop.keep_in_dtype(0.1, torch.float32) == float(np.float32(0.9))


# ---- GPT with dropout ----------------------------------------------------------------

B, S = 2, 16
DROP_CFG = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)


def _gpt_pair():
    paddle_tpu.seed(0)
    jm = JGPT(dataclasses.replace(JGPTConfig.tiny(), **DROP_CFG))
    tm = GPTPretrainModel(dataclasses.replace(GPTConfig.tiny(), **DROP_CFG),
                          device="cpu", seed=0)
    missing, unexpected = load_jax_state(
        tm, {k: np.asarray(v)
             for k, v in jm.state_dict(include_buffers=False).items()})
    assert not missing and not unexpected
    return jm, tm


def _batch(seed=0, vocab=1024):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def test_gpt_dropout_loss_and_every_gradient():
    """GPT at dropout 0.1/0.1 under one "dropout" key: the loss (atol
    1e-5: ~2e-6 here, fp32 sums of a loss near 7 in two orders) and every
    parameter's gradient (atol 1e-5) equal
    jax.value_and_grad of functional_call(..., rngs={"dropout": key}), and
    the port draws the reference's 1 + 3·L keys (the embedding's dropout,
    then each block's attention and its two hidden dropouts)."""
    jm, tm = _gpt_pair()
    x, y = _batch()
    key = jax.random.PRNGKey(13)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda s: jm.loss(
        functional_call(jm, s, jnp.asarray(x), rngs={"dropout": key}),
        jnp.asarray(y))))(jm.trainable_state())
    with trng.rng_guard(dropout=_t(key)) as frame:
        loss = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
    assert frame.counters == {"dropout": 1 + 3 * tm.cfg.num_layers}
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5)
    params = dict(tm.named_parameters())
    assert set(params) == set(grads_j)
    for k, g in grads_j.items():
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=k)
    # the same model in eval draws nothing and differs
    tm.eval()
    with trng.rng_guard(dropout=_t(key)) as frame:
        loss_eval = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    assert frame.counters == {} and loss_eval.item() != loss.item()


def test_gpt_dropout_three_train_steps():
    """Three AdamW steps after seed(0), each binding a fresh global_key()
    (the port through bench.train_step, the reference as its train step
    binds one): losses at rtol 1e-5, different masks each step."""
    lr = 1e-3
    jm, tm = _gpt_pair()
    x, y = _batch(3)
    paddle_tpu.seed(0)
    trng.seed(0)

    def vg(state, key):
        return jax.value_and_grad(lambda s: jm.loss(functional_call(
            jm, s, jnp.asarray(x), rngs={"dropout": key}),
            jnp.asarray(y)))(state)

    vg = jax.jit(vg)
    jopt = JAdamW(learning_rate=lr)
    jupdate = jax.jit(jopt.update)
    state = jm.trainable_state()
    ost = jopt.init_state(state)
    losses_j = []
    for _ in range(3):
        loss, grads = vg(state, jrng.global_key())
        state, ost = jupdate(grads, ost, state)
        losses_j.append(float(loss))
    topt = AdamW(learning_rate=lr, parameters=tm.parameters())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = [bench.train_step(tm, topt, xt, yt).item() for _ in range(3)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert trng.get_rng_state() == jrng.get_rng_state() == (0, 3)


def _gpt_loss(tm, x, y, use_recompute):
    """GPTPretrainModel's forward and loss, each block through recompute
    when asked (the reference's GPT has no recompute of its own)."""
    g = tm.gpt
    pos = torch.arange(x.shape[1])[None, :]
    h = g.drop(g.wte(x) + g.wpe(pos))
    for block in g.h:
        h = rc.recompute(block, h) if use_recompute else block(h)
    return tm.loss(tm._head(g.ln_f(h)), y)


def test_recompute_with_dropout_replays_the_keys():
    """Recomputed GPT blocks with dropout: the same loss and gradients, bit
    for bit, as without recompute, and every stream counter and the global
    generator where the unrecomputed step leaves them; also when the
    backward runs after the guard has exited."""
    _, tm = _gpt_pair()
    x, y = (torch.from_numpy(a) for a in _batch(5))
    key = trng.PRNGKey(77)
    results = []
    for use_rc, backward_inside in ((False, True), (True, True),
                                    (True, False)):
        tm.zero_grad(set_to_none=True)
        trng.seed(0)
        with trng.rng_guard(dropout=key) as frame:
            loss = _gpt_loss(tm, x, y, use_rc)
            if backward_inside:
                loss.backward()
        if not backward_inside:
            loss.backward()
        results.append((loss.detach(), {k: p.grad.clone() for k, p in
                                        tm.named_parameters()},
                        dict(frame.counters), trng.get_rng_state()))
    base = results[0]
    assert base[2] == {"dropout": 1 + 3 * tm.cfg.num_layers}
    for got in results[1:]:
        assert torch.equal(got[0], base[0])
        for k in base[1]:
            assert torch.equal(got[1][k], base[1][k]), k
        assert got[2] == base[2] and got[3] == base[3]
