"""The SD UNet of paddle_tpu_torch against paddle_tpu's, on the CPU.

Each module the UNet adds to the port (``conv2d``, ``group_norm``,
``interpolate``, ``timestep_embedding``, ``ResBlock``,
``SpatialTransformer``) against the reference's, from seeded numpy inputs,
with the reference's weights carried across; then the whole ``UNetModel``
on a small config with SD-1.5's own head dims (model_channels 40, one head:
head dims 40, 80, 160, the ones K1 reaches padded on the card) at 16×16
latents and a 77-token context: fp32 within 1e-4 + 1e-4·|ref| on ε, bf16
within 2e-2 relative L2. The JAX side runs eagerly on the CPU, as
``tests/test_unet.py`` runs it.
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
