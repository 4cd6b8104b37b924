"""Llama training of paddle_tpu_torch against paddle_tpu, on the CPU.

Both packages build a tiny Llama (``LlamaConfig.tiny()``: 2 layers, hidden
64, 4 heads over 2 kv heads, vocab 256) in fp32; the JAX model's weights
are carried into the port with ``utils.convert.load_jax_state`` (tied and
untied: a tied state has no ``lm_head``). Batches and gradients are made
with numpy from a seed. On the CPU the JAX side takes its XLA attention
path, ``jax.checkpoint`` and ``jax.value_and_grad``; the port takes its
plain attention forward and backward through the ``FlashAttention``
Function and ``torch.utils.checkpoint``. The tolerances are those of
``tests/test_torch_gpt_train.py``: fp32 losses at atol 1e-6, gradients at
atol 1e-5 (fp32 sums in another order), a five-step loss curve at rtol
1e-5; the pure-bf16 AdamW update is compared bit for bit.
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.inference import generate as jgenerate
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.parallel import mp_layers as jmp
from paddle_tpu_torch.inference import generate as tgenerate
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import mp_layers as tmp
from paddle_tpu_torch.utils import recompute as trc
from paddle_tpu_torch.utils.convert import array_to_tensor, load_jax_state

B, S = 2, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(bf16=False, **fields):
    """The JAX tiny Llama with `fields` set (seeded), carried into the
    port."""
    paddle_tpu.seed(0)
    jm = JLlama(dataclasses.replace(JLlamaConfig.tiny(), **fields))
    if bf16:
        jm = jm.bfloat16()
    tm = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), **fields),
                          device="cpu", seed=0,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
    missing, unexpected = load_jax_state(
        tm, {k: np.asarray(v)
             for k, v in jm.state_dict(include_buffers=False).items()})
    assert not missing and not unexpected
    return jm, tm


def _batch(seed=0, vocab=256, ignore=()):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    x, y = ids[:, :-1], ids[:, 1:].copy()
    for b, s in ignore:
        y[b, s] = -100
    return x, y


def _jax_train_loss(jm, x, y):
    return lambda st: functional_call(jm, st, jnp.asarray(x), jnp.asarray(y),
                                      method="train_loss")


def _port_grads(tm, x, y):
    loss = tm.train_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return loss, grads


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
def test_train_loss_and_every_gradient_match_jax(chunks, tied, window):
    """train_loss (plain, or in 4 recomputed sequence chunks) and the
    gradient of every parameter against jax.value_and_grad of the
    reference's train_loss, tied and untied, with and without a 5-key
    window at S=24; ignored labels are left out of the mean in both; the
    model's `loss` over its logits equals the reference's too."""
    jm, tm = _pair(tie_word_embeddings=tied, loss_seq_chunks=chunks,
                   sliding_window=window)
    x, y = _batch(1, ignore=[(0, 3), (1, 20)])
    state = jm.trainable_state()
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        _jax_train_loss(jm, x, y)))(state)
    loss_t, grads_t = _port_grads(tm, x, y)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    assert set(grads_t) == set(grads_j)
    assert ("lm_head.weight" in grads_t) is not tied
    for k, g in grads_j.items():
        np.testing.assert_allclose(grads_t[k].numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=k)
    lj = jm.loss(jm(jnp.asarray(x)), jnp.asarray(y))
    with torch.no_grad():
        lt = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-6)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_train_loss_with_a_padding_mask_matches_jax(kind):
    """train_loss(x, y, attn_mask) under a (b, 1, 1, s) padding mask, bool
    or additive −1e4, which composes with the causal mask (reference
    :185-190, :314), the padded labels ignored: the loss and every
    gradient against jax.value_and_grad (atol 1e-6 / 1e-5). The port's
    plain attention takes the mask through the FlashAttention Function."""
    jm, tm = _pair()
    x, y = _batch(4, ignore=[(1, s) for s in range(15, S)])
    keep = np.arange(S)[None, :] < np.array([S, 15])[:, None]
    mask = (keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(
        np.float32))[:, None, None, :]
    loss_j, grads_j = jax.value_and_grad(
        lambda st: functional_call(jm, st, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mask), method="train_loss"))(
        jm.trainable_state())
    loss_t = tm.train_loss(torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(mask))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads_j[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_windowed_train_loss_on_a_left_padded_batch_matches_jax(recompute,
                                                               monkeypatch):
    """A tiny Mistral (a 5-key sliding window at S=24) on a left-padded
    batch: row 1's first 9 tokens are padding, hidden by a (b, 1, 1, s)
    bool mask beside the window, their labels ignored. Its pad queries
    see no valid key inside their window: dead rows, the mean of v over
    every key in both packages. train_loss(x, y, attn_mask) and every
    gradient against jax.value_and_grad of the reference's (atol 1e-6 /
    1e-5), plain and under per-layer recompute (the masked, windowed
    attention replayed in the backward)."""
    fields = dict(sliding_window=5, loss_seq_chunks=2)
    if recompute:
        fields.update(recompute=True, recompute_granularity="full")
    jm, tm = _pair(**fields)
    pad = 9
    x, y = _batch(6, ignore=[(1, s) for s in range(pad)])
    x[1, :pad] = 0
    mask = (np.arange(S)[None, :] >= np.array([0, pad])[:, None])[
        :, None, None, :]
    loss_j, grads_j = jax.value_and_grad(
        lambda st: functional_call(jm, st, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mask), method="train_loss"))(
        jm.trainable_state())
    from paddle_tpu_torch.ops import flash_attention as tfa
    calls = []
    real = tfa.flash_attention_fwd_plain

    def spy(*args, **kw):
        got = inspect.signature(real).bind(*args, **kw).arguments
        calls.append((got.get("window"), got.get("attn_mask") is not None))
        return real(*args, **kw)
    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", spy)
    loss_t = tm.train_loss(torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(mask))
    loss_t.backward()
    # the forward of each layer, and under recompute its replay
    assert calls == [(5, True)] * (4 if recompute else 2)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads_j[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("gran", ["full", "full_attn", "core_attn"])
def test_recompute_granularities(gran, monkeypatch):
    """Per-layer recompute at each granularity gives the port's gradients
    without recompute, bit for bit, and the JAX package's with it (atol
    1e-5); the names the port's policy keeps from the forward are the names
    the reference's policy saves (none for 'full': boundaries only)."""
    from jax.ad_checkpoint import checkpoint_policies as jcp
    names_j = []
    real = jcp.save_only_these_names

    def spy(*names):
        names_j.append(set(names))
        return real(*names)

    monkeypatch.setattr(jcp, "save_only_these_names", spy)
    x, y = _batch(2)
    jm, tm = _pair(recompute=True, recompute_granularity=gran,
                   loss_seq_chunks=2, sliding_window=7)
    _, plain = _pair(loss_seq_chunks=2, sliding_window=7)
    loss_j, grads_j = jax.value_and_grad(_jax_train_loss(jm, x, y))(
        jm.trainable_state())
    with trc.record_saves() as saved:
        loss_t, grads_t = _port_grads(tm, x, y)
    loss_p, grads_p = _port_grads(plain, x, y)
    assert loss_t.item() == loss_p.item()
    for k in grads_p:
        assert torch.equal(grads_t[k], grads_p[k]), k
        np.testing.assert_allclose(grads_t[k].numpy(),
                                   np.asarray(grads_j[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-6)
    want = set(names_j[0]) if names_j else set()
    assert saved == want
    assert want == set(tllama.RECOMPUTE_SAVES[gran] or ())


def test_recompute_refusals_as_the_reference():
    """An unknown granularity and a chunk count that does not divide the
    sequence raise ValueError in both packages."""
    x, y = _batch(3)
    for fields, msg in ((dict(recompute=True, recompute_granularity="attn"),
                         "recompute_granularity"),
                        (dict(loss_seq_chunks=5), "loss_seq_chunks")):
        jm, tm = _pair(**fields)
        with pytest.raises(ValueError, match=msg):
            _jax_train_loss(jm, x, y)(jm.trainable_state())
        with pytest.raises(ValueError, match=msg):
            tm.train_loss(torch.from_numpy(x), torch.from_numpy(y))


def test_recompute_helpers():
    """recompute, recompute_sequential and recompute_wrapper give the
    gradients of the plain function; a named value under its policy is
    kept, others are not."""
    r = np.random.RandomState(4)
    w1, w2 = (torch.from_numpy(r.randn(8, 8).astype(np.float32))
              .requires_grad_(True) for _ in range(2))
    x0 = torch.from_numpy(r.randn(3, 8).astype(np.float32))

    def f1(t):
        with trc.checkpoint_name("mid"):
            h = t @ w1
        return torch.tanh(h)

    def f2(t):
        return torch.sin(t @ w2)

    def grads(fn):
        out = fn(x0).sum()
        return torch.autograd.grad(out, (w1, w2))

    ref = grads(lambda t: f2(f1(t)))
    with trc.record_saves() as saved:
        got = grads(lambda t: trc.recompute(
            lambda u: f2(f1(u)), t,
            policy=trc.save_only_these_names("mid")))
    assert saved == {"mid"}
    with trc.record_saves() as saved_none:
        seq = grads(lambda t: trc.recompute_sequential([f1, f2], t,
                                                       segments=2))
    assert saved_none == set()
    wrapped = grads(trc.recompute_wrapper(
        policy=trc.save_only_these_names("other"))(lambda t: f2(f1(t))))
    for a in (got, seq, wrapped):
        for g, g0 in zip(a, ref):
            assert torch.equal(g, g0)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_cross_entropy_reductions(reduction):
    """Hard labels over (b, s, vocab) logits with ignore_index: the value
    (and the per-token losses for 'none', 0 where ignored) at atol 1e-6 and
    the gradient of a weighted sum of the result at atol 1e-6 against the
    reference's F.cross_entropy and ParallelCrossEntropy."""
    r = np.random.RandomState(5)
    z = (r.randn(2, 5, 11) * 3).astype(np.float32)
    lab = r.randint(0, 11, (2, 5))
    lab[0, 1] = lab[1, 4] = -7
    wts = r.rand(2, 5).astype(np.float32)

    def weigh(loss, w):
        return (loss * w).sum() if reduction == "none" else loss * 2.0

    for jfn, tfn in (
            (lambda a: JF.cross_entropy(a, jnp.asarray(lab), ignore_index=-7,
                                        reduction=reduction),
             lambda a: TF.cross_entropy(a, torch.from_numpy(lab),
                                        ignore_index=-7,
                                        reduction=reduction)),
            (lambda a: jmp.ParallelCrossEntropy(ignore_index=-7)(
                a, jnp.asarray(lab), reduction=reduction),
             lambda a: tmp.ParallelCrossEntropy(ignore_index=-7)(
                 a, torch.from_numpy(lab), reduction=reduction))):
        lj = jfn(jnp.asarray(z))
        gj = jax.grad(lambda a: weigh(jfn(a), jnp.asarray(wts)))(
            jnp.asarray(z))
        zt = torch.from_numpy(z).requires_grad_(True)
        lt = tfn(zt)
        weigh(lt, torch.from_numpy(wts)).backward()
        assert tuple(lt.shape) == tuple(np.shape(lj))
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                                   atol=1e-6)
        np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gj),
                                   atol=1e-6)
        if reduction == "none":
            assert lt[0, 1] == 0 and lt[1, 4] == 0
    # the port's ParallelCrossEntropy defaults to 'none', as the reference
    lab100 = torch.from_numpy(np.where(lab < 0, -100, lab))
    assert tuple(tmp.ParallelCrossEntropy()(
        torch.from_numpy(z), lab100).shape) == (2, 5)
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        TF.cross_entropy(torch.from_numpy(z), torch.from_numpy(lab),
                         label_smoothing=0.1)


def _bits(t):
    return np.asarray(t).view(np.uint16) if not isinstance(t, torch.Tensor) \
        else t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("opt", ["adamw", "adam_l2"])
def test_pure_bf16_adamw_update_bit_equal(opt):
    """multi_precision=False on bf16 parameters: no masters, bf16 moments;
    two updates (the same bf16 grads to both) give the reference's new
    parameters and moments bit for bit, for AdamW (decoupled decay) and
    Adam with coupled L2 decay."""
    jm, tm = _pair(bf16=True, tie_word_embeddings=True)
    pj = jm.trainable_state()
    r = np.random.RandomState(6)
    grads = {k: (r.randn(*v.shape) * 0.1).astype(np.float32)
             for k, v in pj.items()}
    JO, TO, kw = ((JAdamW, AdamW, {}) if opt == "adamw"
                  else (JAdam, Adam, dict(weight_decay=0.01)))
    jopt = JO(learning_rate=1e-3, multi_precision=False, **kw)
    topt = TO(learning_rate=1e-3, multi_precision=False, **kw)
    sj = jopt.init_state(pj)
    pt = {k: v.detach() for k, v in tm.trainable_state().items()}
    st = topt.init_state(pt)
    assert "master" not in st and "master" not in sj
    assert all(t.dtype == torch.bfloat16 for t in st["moment1"].values())
    for step in range(2):
        gj = {k: jnp.asarray(g * (step + 1), jnp.bfloat16)
              for k, g in grads.items()}
        pj, sj = jopt.update(gj, sj, pj)
        pt, st = topt.update({k: array_to_tensor(np.asarray(v))
                              for k, v in gj.items()}, st, pt)
        for k in pj:
            np.testing.assert_array_equal(_bits(pt[k]), _bits(pj[k]),
                                          err_msg=k)
            for slot in ("moment1", "moment2"):
                np.testing.assert_array_equal(_bits(st[slot][k]),
                                              _bits(sj[slot][k]),
                                              err_msg=f"{slot} {k}")
    assert st["step"] == 2


def test_pure_bf16_eager_step_in_groups(monkeypatch):
    """opt.step() with multi_precision=False writes the new values into the
    parameters group by group (GROUP_NUMEL cut small here): the same bits
    as the functional update over all parameters at once."""
    import paddle_tpu_torch.optimizer as topt_mod
    _, tm = _pair(bf16=True)
    params = {k: v.detach().clone() for k, v in tm.trainable_state().items()}
    r = np.random.RandomState(7)
    grads = {k: torch.from_numpy((r.randn(*v.shape) * 0.1)
                                 .astype(np.float32)).bfloat16()
             for k, v in params.items()}
    ref_opt = AdamW(learning_rate=1e-3, multi_precision=False)
    want, _ = ref_opt.update(grads, ref_opt.init_state(params), params)
    monkeypatch.setattr(topt_mod, "GROUP_NUMEL", 5000)
    assert len(list(topt_mod._groups(list(params), params))) > 3
    opt = AdamW(learning_rate=1e-3, multi_precision=False,
                parameters=tm.parameters())
    for (k, p), g in zip(tm.named_parameters(), grads.values()):
        p.grad = g
    opt.step()
    for k, p in tm.named_parameters():
        assert torch.equal(p.detach(), want[k]), k


def test_five_step_windowed_loss_curve():
    """Five steps on one fixed batch of a windowed (5 keys), tied, chunked
    (4), core_attn-recomputed tiny Llama: the JAX package's functional
    train_loss + value_and_grad + AdamW(multi_precision=False) against the
    port's train_bench.train_step (fp32: the low-precision mode's slots are
    fp32 here); losses at rtol 1e-5, falling."""
    from paddle_tpu_torch import train_bench
    fields = dict(sliding_window=5, tie_word_embeddings=True,
                  loss_seq_chunks=4, recompute=True,
                  recompute_granularity="core_attn")
    jm, tm = _pair(**fields)
    x, y = _batch(8)
    lr, steps = 1e-3, 5
    vg = jax.jit(jax.value_and_grad(_jax_train_loss(jm, x, y)))
    jopt = JAdamW(learning_rate=lr, multi_precision=False)
    jupdate = jax.jit(jopt.update)
    state = jm.trainable_state()
    ost = jopt.init_state(state)
    losses_j = []
    for _ in range(steps):
        loss, grads = vg(state)
        state, ost = jupdate(grads, ost, state)
        losses_j.append(float(loss))
    topt = AdamW(learning_rate=lr, multi_precision=False,
                 parameters=tm.parameters())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses_t = [train_bench.train_step(tm, topt, xt, yt).item()
                for _ in range(steps)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]


def test_tied_model_state_plan_and_generate():
    """A tied Llama: the JAX state (no lm_head) loads strictly, the
    parameter counts agree, and `generate` on the fused plan's path (bf16
    cache; the head is the tied unembedding, as the reference's plan) and
    the layered path (fp32 cache) gives the JAX package's tokens; the
    untied model's plan keeps lm_head."""
    jm, tm = _pair(tie_word_embeddings=True)
    assert not hasattr(tm, "lm_head")
    assert tm.num_params() == jm.num_params()
    assert list(tm.state_dict(include_buffers=False)) == \
        list(jm.state_dict(include_buffers=False))
    ids = np.random.RandomState(9).randint(0, 256, (2, 7)).astype(np.int32)
    state = tm.state_dict(include_buffers=False)
    plan = tm.fused_decode_plan(state)
    h = torch.from_numpy(np.random.RandomState(10).randn(2, 64)
                         .astype(np.float32))
    from paddle_tpu_torch.ops.rms_norm import rms_norm
    np.testing.assert_allclose(
        plan["head"](h).numpy(),
        (rms_norm(h, state["model.norm.weight"], 1e-5)
         @ state["model.embed_tokens.weight"].T).numpy(), atol=1e-6)
    for cdt_j, cdt_t in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
        oj = np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=6,
                                  cache_dtype=cdt_j))
        ot = tgenerate(tm, ids, max_new_tokens=6, cache_dtype=cdt_t).numpy()
        assert ot.tolist() == oj.tolist()
    _, untied = _pair()
    assert untied.fused_decode_plan(
        untied.state_dict(include_buffers=False)) is not None


def test_train_bench_cpu_record(capsys):
    """python -m paddle_tpu_torch.train_bench --device cpu --model
    llama-tiny: the reference's CPU shape (B=2, S=128, 2 steps), one JSON
    line shaped like its record; a CPU run reports no device time and no
    MFU. `config` gives the reference's settings for the 1B shapes."""
    from paddle_tpu_torch import train_bench
    rec = train_bench.main(["--device", "cpu", "--model", "llama-tiny"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["metric"] == "llama-tiny train tokens/sec/chip"
    assert (rec["batch"], rec["seq"], rec["steps"]) == (2, 128, 2)
    assert rec["device"] == "cpu" and rec["mfu"] is None \
        and rec["step_time_ms"] is None
    assert rec["params"] == 459392 and np.isfinite(rec["final_loss"])
    cfg = train_bench.config("llama-1b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.kv_heads,
            cfg.intermediate_size) == (2048, 22, 32, 4, 5632)
    assert cfg.recompute and cfg.recompute_granularity == "core_attn" \
        and cfg.loss_seq_chunks == 4
    assert train_bench.config("llama-1b3", "full").recompute_granularity \
        == "full"
    assert not train_bench.config("llama-tiny").recompute


@pytest.mark.parametrize("name", ["llama-1b3", "llama-1b", "llama-tiny"])
def test_train_bench_config_is_the_reference_s(name):
    """`train_bench.config(name)` is the reference's `examples/
    train_bench.py` `build(name)` field by field (every field both
    LlamaConfigs have), with the settings its `main` adds for the 1B
    shapes: core_attn recompute and 4 loss chunks."""
    import importlib.util
    import pathlib
    from paddle_tpu_torch import train_bench
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "train_bench.py"
    spec = importlib.util.spec_from_file_location("_ref_train_bench", path)
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    ref = ref_mod.build(name)
    if name in ("llama-1b", "llama-1b3"):
        ref.recompute_granularity = "core_attn"
        ref.loss_seq_chunks = 4
    got = train_bench.config(name)
    shared = {f.name for f in dataclasses.fields(got)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"vocab_size", "hidden_size", "num_layers", "num_heads",
            "num_kv_heads", "intermediate_size", "recompute",
            "recompute_granularity", "loss_seq_chunks"} <= shared
    assert {f: getattr(got, f) for f in shared} == \
        {f: getattr(ref, f) for f in shared}
