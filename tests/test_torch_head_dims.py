"""The attention dispatch at head dims K1 is not built for (the port's half of
the reference's ``_pad_for_kernel``, ``paddle_tpu/ops/flash_attention.py:339``).

* The zero pad is exact: K1's plain twin over the padded q, k, v, with the
  scale of the original d, gives the unpadded plain twin's output (sliced)
  and lse, at SD-1.5's head dims 40, 80 and 160.
* On the kernels' device (meta tensors stand for CUDA tensors; the C
  entries are recorders, so nothing launches) the dispatch hands K1 d 64,
  128, 256 for 40, 80, 160, the original d's scale, and native 256 as it
  is, and a gradient there reaches K3 and K4 at the same padded d; d > 256
  and the window or dropout at d 256 (forward or backward) raise, naming
  their ROADMAP items.
* The CPU path (``_xla_attention``) equals the reference's
  ``_xla_attention`` at those head dims over a 77-token context, and the
  kernel path's gradient composition (the pad, FlashAttention at the
  padded d, the slice), run on CPU tensors, equals the unpadded one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# SD-1.5's head dims (8 heads over 320 / 640 / 1280 channels) and the
# kernel d each pads to
SD_DIMS = ((40, 64), (80, 128), (160, 256))


def _qkv(seed, b, sq, sk, h, d, dtype=np.float32):
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy(r.randn(*s).astype(dtype))
                 for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


@pytest.mark.parametrize("d,dt", SD_DIMS)
@pytest.mark.parametrize("sk", [77, 96])
def test_pad_is_exact(d, dt, sk):
    """Padded plain = unpadded plain, out (fp32, atol 1e-6) and lse."""
    q, k, v = _qkv(d + sk, 2, 96, sk, 2, d)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v)
    qp, kp, vp, scale, d0 = tfa._pad_head_dim(q, k, v, None)
    assert d0 == d and qp.shape[-1] == dt and kp.shape[-1] == dt
    assert scale == 1.0 / math.sqrt(d)
    assert bool((qp[..., d:] == 0).all() and (vp[..., d:] == 0).all())
    out, lse = tfa.flash_attention_fwd_plain(qp, kp, vp, scale=scale)
    assert bool((out[..., d:] == 0).all())
    torch.testing.assert_close(out[..., :d], ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=0)
    # the wrong scale (1/√ of the padded d) is not within that
    bad, _ = tfa.flash_attention_fwd_plain(qp, kp, vp)
    assert (bad[..., :d] - ref).abs().max().item() > 1e-3


class _Captured(Exception):
    pass


class _Calls(dict):
    """The recorded C-entry arguments by entry name; with `succeed` set an
    entry returns 0 (success) instead of raising _Captured."""
    succeed = False


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernels' C entries (K1, K3, K4) replaced by a recorder of their
    int and float arguments that raises (or, with ``.succeed``, returns
    success: the meta outputs need no data); meta tensors taken as the
    kernels' device; the wrappers' launch counts restored afterwards."""
    got = _Calls()

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                got[name] = [a for a in args if isinstance(a, (int, float))]
                if not got.succeed:
                    raise _Captured
                return 0
            return entry

    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(tfa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    for w in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
              tfa.flash_attention_bwd_dkv):
        for count in ("launches", "windowed", "dropout"):
            monkeypatch.setattr(w, count, getattr(w, count))
        monkeypatch.setattr(w, "by_d", dict(w.by_d))
    return got


def _meta(*shape, grad=False):
    return torch.empty(*shape, dtype=torch.bfloat16, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("d,dt", SD_DIMS + ((256, 256),))
@pytest.mark.parametrize("sq,sk", [(4096, 4096), (256, 77), (64, 77)])
def test_dispatch_marshals_the_padded_head_dim(kernel_calls, d, dt, sq, sk):
    """b 2, h 8 at the UNet's shapes: K1 gets (b, sq, sk, h, nkv, d_kernel,
    causal 0, q_off sk - sq, window 0, scale 1/√d, no dropout)."""
    b, h = 2, 8
    fa = tfa.flash_attention_fwd
    fa.launches, before = 0, dict(fa.by_d)
    with pytest.raises(_Captured):
        tfa.scaled_dot_product_attention(_meta(b, sq, h, d),
                                         _meta(b, sk, h, d),
                                         _meta(b, sk, h, d))
    assert kernel_calls["flash_attention_fwd"] == [
        b, sq, sk, h, h, dt, 0, sk - sq, 0, 1.0 / math.sqrt(d), 0, 1.0]
    assert fa.launches == 0 and fa.by_d == before


def test_dispatch_refuses_what_k1_does_not_take(kernel_calls):
    """d > 256 raises (no kernel, no fallback); a gradient at kernel d 256
    (native, or 160 padded) reaches K1, K3 and K4's C entries with d 256
    and the scale of the unpadded d, one launch each at 256; the window and
    dropout at d 256 name Queue B row 1 (K1) and rows 2-3 (K3, K4); the
    kernels' own wrappers take no d outside 64, 128, 256. Nothing else
    reaches a C entry."""
    with pytest.raises(ValueError, match="head_dim 300"):
        tfa.scaled_dot_product_attention(*(_meta(1, 8, 2, 300)
                                           for _ in range(3)))
    wraps = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
             tfa.flash_attention_bwd_dkv)
    kernel_calls.succeed = True
    for d in (160, 256):
        before = [dict(w.by_d) for w in wraps]
        leaves = [_meta(1, 8, 2, d, grad=True) for _ in range(3)]
        out = tfa.scaled_dot_product_attention(*leaves)
        assert out.shape == (1, 8, 2, d)
        out.backward(torch.empty_like(out))
        assert all(t.grad.shape == (1, 8, 2, d) for t in leaves)
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            assert kernel_calls[name][5] == 256, (d, name)
            assert kernel_calls[name][9] == 1.0 / math.sqrt(d), (d, name)
        for w, n in zip(wraps, before):
            assert w.by_d == {t: n[t] + (t == 256) for t in n}, w.__name__
    kernel_calls.succeed = False
    kernel_calls.clear()
    q = _meta(1, 8, 2, 256)
    with pytest.raises(NotImplementedError, match="Queue B row 1"):
        tfa.flash_attention_fwd(q, q, q, is_causal=True, window=4)
    with pytest.raises(NotImplementedError, match="Queue B row 1"):
        tfa.flash_attention_fwd(q, q, q, dropout_p=0.1,
                                key=torch.zeros(2, dtype=torch.int64))
    lse = torch.empty(1, 2, 8, device="meta")
    for bwd in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(NotImplementedError, match="Queue B rows 2-3"):
            bwd(q, q, q, q, lse, lse, is_causal=True, window=4)
        with pytest.raises(NotImplementedError, match="Queue B rows 2-3"):
            bwd(q, q, q, q, lse, lse, dropout_p=0.1,
                key=torch.zeros(2, dtype=torch.int64))
    q40 = _meta(1, 8, 2, 40)
    with pytest.raises(ValueError, match="head_dim 64 or 128 or 256"):
        tfa.flash_attention_fwd(q40, q40, q40)
    with pytest.raises(ValueError, match="head_dim 64 or 128 or 256"):
        tfa.flash_attention_bwd_dq(q40, q40, q40, q40, lse, lse)
    assert kernel_calls == {}


@pytest.mark.parametrize("d,dt", SD_DIMS)
def test_gradient_rides_the_padded_kernel_d(kernel_calls, d, dt):
    """A gradient at d 40, 80 or 160 takes FlashAttention (K1 + K3/K4) at
    the padded d: its forward reaches K1 with d 64, 128 or 256, and its
    backward K3 and K4 with the same d, each with the scale of the
    unpadded d."""
    with pytest.raises(_Captured):
        tfa.scaled_dot_product_attention(*(_meta(2, 64, 2, d, grad=True)
                                           for _ in range(3)))
    assert kernel_calls["flash_attention_fwd"][5] == dt
    kernel_calls.succeed = True
    out = tfa.scaled_dot_product_attention(*(_meta(2, 64, 2, d, grad=True)
                                             for _ in range(3)))
    out.backward(torch.empty_like(out))
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert kernel_calls[name][5] == dt, name
        assert kernel_calls[name][9] == 1.0 / math.sqrt(d), name


@pytest.mark.parametrize("d", [d for d, _ in SD_DIMS])
def test_cpu_path_matches_reference(d):
    """The dispatch on CPU tensors (``_xla_attention``) against the
    reference's ``_xla_attention`` (fp32, atol 1e-5): self-attention over
    96 tokens and cross-attention to 77."""
    for sq, sk in ((96, 96), (96, 77)):
        q, k, v = _qkv(d, 2, sq, sk, 2, d)
        ref = jfa._xla_attention(jnp.asarray(q.numpy()),
                                 jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()))
        out = tfa.scaled_dot_product_attention(q, k, v)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _padded_flash(q, k, v):
    """What the dispatch runs on the kernels' device when a gradient is
    needed: the pad, FlashAttention at the padded d, the slice."""
    qp, kp, vp, scale, d = tfa._pad_head_dim(q, k, v, None)
    out = tfa.FlashAttention.apply(qp, kp, vp, False, scale, None, None)
    return out[..., :d]


@pytest.mark.parametrize("d", [40, 80])
def test_gradient_through_the_pad(d):
    """The kernel path's composition with a gradient (pad, FlashAttention at
    the padded d, slice), run on CPU tensors (FlashAttention's plain
    forward and backward): torch's autograd of the pad and the slice gives
    the unpadded attention's out, dq, dk, dv (fp32, atol 1e-5). On CPU
    tensors the dispatch itself takes any head dim without a pad."""
    q, k, v = _qkv(d + 1, 2, 40, 77, 2, d)
    do = torch.from_numpy(np.random.RandomState(d).randn(2, 40, 2, d)
                          .astype(np.float32))
    grads = []
    for fn in (_padded_flash, tfa._xla_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append((out.detach(), *(t.grad for t in leaves)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.scaled_dot_product_attention(*leaves)
    assert out.shape[-1] == d
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
