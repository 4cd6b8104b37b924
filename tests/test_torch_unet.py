"""The SD UNet of paddle_tpu_torch against paddle_tpu's, on the CPU.

Each module the UNet adds to the port (``conv2d``, ``group_norm``,
``interpolate``, ``timestep_embedding``, ``ResBlock``,
``SpatialTransformer``) against the reference's, from seeded numpy inputs,
with the reference's weights carried across; then the whole ``UNetModel``
on a small config with SD-1.5's own head dims (model_channels 40, one head:
head dims 40, 80, 160, the ones K1 reaches padded on the card) at 16×16
latents and a 77-token context: fp32 within 1e-4 + 1e-4·|ref| on ε, bf16
within 2e-2 relative L2. The JAX side runs eagerly on the CPU, as
``tests/test_unet.py`` runs it. Training on the same config: ``ddpm_loss``
and every parameter's gradient against ``jax.value_and_grad`` of the
reference's (jitted), three AdamW steps against the reference's update,
the twin's DDPM draws bit for bit, and ``unet_bench --train`` on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import unet as ju
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import unet as tu
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.utils.convert import load_jax_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
# the small config with SD-1.5's head dims (its eager JAX forward compiles
# per op on first call: ~20 s, then 0.1 s)
SMALL = dict(model_channels=40, channel_mult=(1, 2, 4), num_res_blocks=1,
             attention_levels=(0, 1, 2), num_heads=1, context_dim=32,
             groups=8)
RES, CTX, B = 16, 77, 2


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _state(jm):
    return {k: np.asarray(v)
            for k, v in jm.state_dict(include_buffers=False).items()}


def _kw():
    return dict(dtype=torch.float32, device=torch.device("cpu"),
                generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("k,pad,stride", [
    (3, 1, 1), (3, 1, 2), (1, 0, 1), (3, (2, 0), 1)])
def test_conv2d(k, pad, stride):
    """3×3 pad 1 (the UNet's convs), its stride-2 downsampler, the 1×1
    skip and projections, an (h, w) padding; bias added after the
    convolution (fp32, atol 1e-5). The paddings and layouts not ported
    raise."""
    x, w, b = _rand(0, 2, 6, 9, 9), _rand(1, 8, 6, k, k), _rand(2, 8)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    stride=stride, padding=pad)
    out = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=stride, padding=pad)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    for kw in (dict(padding="SAME"), dict(padding=((1, 0), (0, 1))),
               dict(data_format="NHWC")):
        with pytest.raises(NotImplementedError, match="ported"):
            TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kw)


@pytest.mark.parametrize("dtype,atol", [
    (np.float32, ATOL),
    # bf16 on both sides: the reference rounds the statistics and the
    # normalised value to bf16 before the affine, the port once at the end
    # (|y| < 8 here, where a bf16 ulp is at most 2^-5)
    ("bfloat16", 2.0 ** -4)])
def test_group_norm(dtype, atol):
    """Biased variance, eps 1e-5, per-channel weight and bias; the layer's
    defaults are weight 1, bias 0; NHWC raises."""
    x, w, b = _rand(3, 2, 64, 5, 7), _rand(4, 64), _rand(5, 64)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    ref = JF.group_norm(jnp.asarray(x, jdt), 32, jnp.asarray(w, jdt),
                        jnp.asarray(b, jdt))
    out = TF.group_norm(torch.from_numpy(x).to(tdt), 32,
                        torch.from_numpy(w).to(tdt),
                        torch.from_numpy(b).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol)
    with pytest.raises(NotImplementedError, match="NCHW"):
        TF.group_norm(torch.from_numpy(x), 32, data_format="NHWC")
    layer = tnn.GroupNorm(32, 64, device="cpu")
    assert bool((layer.weight == 1).all() and (layer.bias == 0).all())


def test_interpolate_nearest():
    """Nearest at integer scales equals jax.image.resize's nearest exactly;
    the modes not ported raise."""
    x = _rand(6, 2, 3, 5, 4)
    for kw in (dict(scale_factor=2), dict(size=(10, 12))):
        ref = JF.interpolate(jnp.asarray(x), mode="nearest", **kw)
        out = TF.interpolate(torch.from_numpy(x), mode="nearest", **kw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for kw in (dict(scale_factor=2, mode="bilinear"),
               dict(scale_factor=1.5), dict(size=(4, 4))):
        with pytest.raises(NotImplementedError, match="nearest"):
            TF.interpolate(torch.from_numpy(x), **kw)


@pytest.mark.parametrize("dim", [40, 320, 33])
def test_timestep_embedding(dim):
    """cos then sin over fp32 frequencies (odd dims padded with a zero).
    atol 1e-4, not 1e-5: XLA's and torch's exp may round a frequency one
    fp32 ulp (6e-8 relative) apart, and t·freq reaches 999 rad, where that
    ulp moves the argument, and so cos and sin, by up to 6e-5."""
    t = np.array([0, 3, 500, 999])
    ref = ju.timestep_embedding(jnp.asarray(t), dim)
    out = tu.timestep_embedding(torch.from_numpy(t), dim)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _carry(jm, tm):
    """The reference's state loads into the port's module unchanged (same
    keys and shapes, strict)."""
    st = _state(jm)
    own = tm.state_dict()
    assert set(st) == set(own)
    assert all(tuple(st[k].shape) == tuple(own[k].shape) for k in st)
    load_jax_state(tm, st)


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32)])
def test_resblock(cin, cout):
    """ResBlock with a 1×1 skip conv (cin != cout) and an Identity skip."""
    paddle_tpu.seed(0)
    jm = ju.ResBlock(cin, cout, 64, 8)
    tm = tu.ResBlock(cin, cout, 64, 8, **_kw())
    _carry(jm, tm)
    x, temb = _rand(7, 2, cin, 6, 6), _rand(8, 2, 64)
    ref = jm(jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(temb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("ctx_dim", [24, None])
def test_spatial_transformer(ctx_dim):
    """Self-attention over the pixels, cross-attention to a 77-token
    context (ctx_dim None: self-attention twice), GEGLU with exact GELU; two
    heads of 40 (the head dim K1 reaches padded to 64 on the card)."""
    paddle_tpu.seed(0)
    jm = ju.SpatialTransformer(80, 2, ctx_dim, 8)
    tm = tu.SpatialTransformer(80, 2, ctx_dim, 8, **_kw())
    _carry(jm, tm)
    x = _rand(9, 2, 80, 4, 5)
    ctx = _rand(10, 2, CTX, ctx_dim) if ctx_dim else None
    ref = jm(jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    with torch.no_grad():
        out = tm(torch.from_numpy(x),
                 None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def reference():
    """The JAX UNet on the small config (seeded here: module fixtures are
    built before the conftest reseeds), its fp32 state and ε, then the same
    model in bf16, its state and ε, for one input."""
    paddle_tpu.seed(0)
    jm = ju.UNetModel(ju.UNetConfig(**SMALL))
    jm.eval()
    x, ctx = _rand(11, B, 4, RES, RES), _rand(12, B, CTX, 32)
    t = np.array([3, 700])
    args = lambda dt: (jnp.asarray(x, dt), jnp.asarray(t),
                       jnp.asarray(ctx, dt))
    out = {"x": x, "t": t, "ctx": ctx, "state32": _state(jm),
           "eps32": np.asarray(jm(*args(jnp.float32)))}
    jm = jm.bfloat16()
    out["state16"] = _state(jm)
    out["eps16"] = np.asarray(jm(*args(jnp.bfloat16)).astype(jnp.float32))
    return out


def _port_eps(ref, dtype):
    tm = tu.UNetModel(tu.UNetConfig(**SMALL), dtype=dtype, device="cpu",
                      seed=0)
    st = ref["state32" if dtype == torch.float32 else "state16"]
    own = tm.state_dict()
    assert set(st) == set(own)
    assert all(tuple(st[k].shape) == tuple(own[k].shape) for k in st)
    load_jax_state(tm, st)
    with torch.no_grad():
        eps = tm(torch.from_numpy(ref["x"]).to(dtype),
                 torch.from_numpy(ref["t"]),
                 torch.from_numpy(ref["ctx"]).to(dtype))
    assert eps.dtype == dtype and tuple(eps.shape) == ref["x"].shape
    return eps.float().numpy()


def test_unet_state_carries_across(reference):
    """The JAX UNet's state_dict() keys and shapes are the port's, in fp32
    and bf16, and a bf16 state moves bit for bit."""
    for key in ("state32", "state16"):
        dt = torch.float32 if key == "state32" else torch.bfloat16
        tm = tu.UNetModel(tu.UNetConfig(**SMALL), dtype=dt, device="cpu",
                          seed=1)
        st = reference[key]
        assert set(st) == set(tm.state_dict())
        assert all(tuple(v.shape) == tuple(tm.state_dict()[k].shape)
                   for k, v in st.items())
        load_jax_state(tm, st)
        w = "down_attns.0.attn2.to_k.weight"
        got = tm.state_dict()[w]
        if dt == torch.bfloat16:
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  st[w].view(np.int16))
        else:
            assert np.array_equal(got.numpy(), st[w])


def test_unet_forward_fp32(reference):
    """ε within 1e-4 + 1e-4·|ref| of the reference's."""
    eps = _port_eps(reference, torch.float32)
    ref = reference["eps32"]
    assert np.isfinite(eps).all()
    bad = np.abs(eps - ref) > 1e-4 + 1e-4 * np.abs(ref)
    assert not bad.any(), float(np.abs(eps - ref).max())


def test_unet_forward_bf16(reference):
    """bf16 weights and inputs on both sides: ε within 2e-2 relative L2
    (the two frameworks round bf16 at other places)."""
    eps = _port_eps(reference, torch.bfloat16)
    ref = reference["eps16"]
    rel = np.linalg.norm(eps - ref) / np.linalg.norm(ref)
    assert np.isfinite(eps).all() and rel <= 2e-2, rel


def test_cosine_alphas_cumprod():
    ref = np.asarray(ju.cosine_alphas_cumprod(100))
    out = tu.cosine_alphas_cumprod(100).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


# ---- training: ddpm_loss, its gradients, AdamW, the twin's DDPM step -------

# ddpm_loss on the small config: latents, noise, timesteps, a 77-token
# context, the reference's cosine schedule (one numpy array to both sides)
TRAIN_T = np.array([3, 700])


@pytest.fixture(scope="module")
def ddpm_reference():
    """The JAX UNet on the small config in fp32 (seeded here), its state,
    and jax.value_and_grad of the reference's ddpm_loss over that state
    (jitted: ~35 s to compile here), with the inputs."""
    import jax
    paddle_tpu.seed(0)
    jm = ju.UNetModel(ju.UNetConfig(**SMALL))
    jm.eval()
    x0, noise = _rand(21, B, 4, RES, RES), _rand(22, B, 4, RES, RES)
    ctx = _rand(23, B, CTX, 32)
    alphas = np.asarray(ju.cosine_alphas_cumprod(1000))
    vg = jax.jit(jax.value_and_grad(lambda s: ju.ddpm_loss(
        s, jm, jnp.asarray(x0), jnp.asarray(TRAIN_T), jnp.asarray(noise),
        jnp.asarray(ctx), jnp.asarray(alphas))))
    state = jm.trainable_state()
    loss, grads = vg(state)
    return {"vg": vg, "state": state, "loss": float(loss),
            "grads": {k: np.asarray(g) for k, g in grads.items()},
            "args": (x0, TRAIN_T, noise, ctx, alphas)}


def _port_args(ref):
    return [torch.from_numpy(np.array(a)) for a in ref["args"]]


@pytest.mark.parametrize("form", ["state_dict", "model"])
def test_ddpm_loss_and_every_gradient_match_jax(ddpm_reference, form):
    """The port's ddpm_loss and the gradient of every parameter against
    jax.value_and_grad of the reference's (fp32): through a state dict
    (nn.functional_call) and through the model itself. The loss within
    1e-5 (read: 2.4e-7); each parameter's gradient within 1e-4 of its
    largest entry: both sides sum the same fp32 products in other orders
    through ~60 layers, which here leaves at most 2.8e-6 of it; a wrong
    layer, mask or schedule moves a gradient by O(1) of its size."""
    ref = ddpm_reference
    x0, t, noise, ctx, alphas = _port_args(ref)
    tm = tu.UNetModel(tu.UNetConfig(**SMALL), dtype=torch.float32,
                      device="cpu", seed=1)
    if form == "state_dict":
        state = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
                 for k, v in ref["state"].items()}
        loss = tu.ddpm_loss(state, tm, x0, t, noise, ctx, alphas)
        grads = dict(zip(state, torch.autograd.grad(loss,
                                                    list(state.values()))))
        # the model's own parameters took no part
        assert all(p.grad is None for p in tm.parameters())
    else:
        load_jax_state(tm, {k: np.asarray(v) for k, v in ref["state"].items()})
        loss = tu.ddpm_loss(tm, tm, x0, t, noise, ctx, alphas)
        loss.backward()
        grads = {k: p.grad for k, p in tm.named_parameters()}
    assert abs(loss.item() - ref["loss"]) <= 1e-5, (loss.item(), ref["loss"])
    assert set(grads) == set(ref["grads"])
    for k, g in grads.items():
        r = ref["grads"][k]
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (k, err, np.abs(r).max())


def test_three_adamw_steps_match_jax(ddpm_reference):
    """Three AdamW(1e-4, multi_precision=False) steps (the twin's
    optimizer) on the UNet's fp32 parameters, each on the same gradients
    (the reference's ddpm_loss gradient at the reference's parameters):
    the port's functional update against the reference's AdamW.update,
    parameters and both moments within 1e-6 after every step (fp32 bias
    corrections on both sides); the port's ddpm_loss at its own
    parameters follows the reference's loss within 1e-5."""
    import jax
    from paddle_tpu.optimizer import AdamW as JAdamW
    from paddle_tpu_torch.optimizer import AdamW
    ref = ddpm_reference
    x0, t, noise, ctx, alphas = _port_args(ref)
    tm = tu.UNetModel(tu.UNetConfig(**SMALL), dtype=torch.float32,
                      device="cpu", seed=1)
    jopt = JAdamW(learning_rate=1e-4, multi_precision=False)
    topt = AdamW(learning_rate=1e-4, multi_precision=False)
    jupdate = jax.jit(jopt.update)
    js = ref["state"]
    jst = jopt.init_state(js)
    ts = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
    tst = topt.init_state(ts)
    losses = []
    for step in range(3):
        loss, g = (ref["loss"], ref["grads"]) if step == 0 else ref["vg"](js)
        with torch.no_grad():
            port_loss = tu.ddpm_loss(ts, tm, x0, t, noise, ctx, alphas)
        assert abs(port_loss.item() - float(loss)) <= 1e-5, step
        losses.append(float(loss))
        js, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jst, js)
        ts, tst = topt.update({k: torch.from_numpy(np.array(v))
                               for k, v in g.items()}, tst, ts)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=1e-6, err_msg=f"{step} {k}")
            for slot in ("moment1", "moment2"):
                np.testing.assert_allclose(
                    tst[slot][k].numpy(), np.asarray(jst[slot][k]),
                    atol=1e-6, err_msg=f"{step} {slot} {k}")
    assert losses[-1] < losses[0]


def test_train_inputs_follow_the_reference_draws():
    """unet_bench.train_inputs against examples/unet_bench.py's draws
    (:70-95): x0, t, ctx, then the noise and ᾱ from the same RandomState,
    x_t = √ᾱ·x0 + √(1 − ᾱ)·noise in fp32 from the bf16 x0 and noise, cast
    to bf16; every tensor bit for bit."""
    from paddle_tpu_torch import unet_bench
    cfg = tu.UNetConfig.tiny()
    b, res, n = 2, 16, 8
    rng = np.random.RandomState(0)
    x0 = jnp.asarray(rng.standard_normal((b, cfg.in_channels, res, res)),
                     jnp.bfloat16)
    t = rng.randint(0, 1000, (b,))
    ctx = jnp.asarray(rng.standard_normal((b, n, cfg.context_dim)),
                      jnp.bfloat16)
    noise = jnp.asarray(rng.standard_normal(x0.shape), jnp.bfloat16)
    abar = jnp.asarray(rng.uniform(0.2, 0.98, (b, 1, 1, 1)), jnp.float32)
    xt = (jnp.sqrt(abar) * x0.astype(jnp.float32)
          + jnp.sqrt(1 - abar) * noise.astype(jnp.float32)).astype(
        jnp.bfloat16)
    got = unet_bench.train_inputs(cfg, b, res, n, "cpu")
    assert [g.dtype for g in got] == [torch.bfloat16, torch.int64,
                                      torch.bfloat16, torch.bfloat16]
    bits = lambda a: np.asarray(a).view(np.int16)
    for g, r in zip(got, (xt, t, ctx, noise)):
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          bits(r))
        else:
            np.testing.assert_array_equal(g.numpy(), r)


def test_unet_twin_trains_on_the_cpu():
    """python -m paddle_tpu_torch.unet_bench --train --device cpu: the
    reference's CPU shape (the tiny UNet, 16×16, an 8-token context, b 1),
    two warm-up and two timed DDPM steps: finite losses, falling, and the
    record's fields (MFU on the 3 × forward basis is for the card)."""
    from paddle_tpu_torch import unet_bench
    rec = unet_bench.main(["--train", "--device", "cpu"])
    assert rec["mode"] == "train" and rec["batch"] == 1 and rec["steps"] == 2
    assert rec["res"] == 16 and rec["context_len"] == 8
    losses = rec["losses"]
    assert len(losses) == unet_bench.WARMUP + 2
    assert rec["loss_finite"] and all(np.isfinite(losses))
    assert rec["loss_first"] == losses[0] and rec["loss_last"] == losses[-1]
    assert losses[-1] < losses[0]
    assert rec["optimizer"] == "AdamW(1e-4, multi_precision=False)"
    assert rec["mfu_basis"].startswith("3 x forward_flops")
    assert rec["flops_per_step"]["total"] > 0 and rec["mfu"] is None
