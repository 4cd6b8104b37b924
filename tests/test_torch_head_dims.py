"""The attention dispatch at head dims other than the kernels' widths (the
port's half of the reference's ``_pad_for_kernel``,
``paddle_tpu/ops/flash_attention.py:339``).

* The zero columns are exact: K1's plain twin over q, k, v zero-padded to
  the kernel width, with the scale of the original d, gives the unpadded
  plain twin's output (sliced) and lse, at SD-1.5's head dims 40, 80 and
  160 (where the kernels read the zeros as TMA's fill, no pad made) and at
  36 and 100 (where ``_pad_head_dim`` still pads).
* On the kernels' device (meta tensors stand for CUDA tensors; the C
  entries are recorders, so nothing launches) the dispatch and
  ``flash_fwd_lse`` hand K1 the true d (40, 80, 160) with its scale and
  make no pad, and a gradient there reaches K3 and K4 at the same d;
  ``by_d`` counts the kernel width (64, 128, 256). A d that is not a
  multiple of 8 is padded to its width first; d > 256, a raw kernel call
  at such a d, and the window or dropout at kernel width 256 (forward or
  backward) raise, naming their ROADMAP items.
* The CPU path (``_xla_attention``) equals the reference's
  ``_xla_attention`` at those head dims over a 77-token context, and the
  gradient through zero columns (the pad, FlashAttention at the padded d,
  the slice), run on CPU tensors, equals the unpadded one.
"""

import math
import types

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
# kernel width each runs at, its columns past d TMA's zero fill
SD_DIMS = ((40, 64), (80, 128), (160, 256))
# head dims that are no multiple of 8 (no TMA row stride) and the kernel
# width the dispatch pads each to
PAD_DIMS = ((36, 64), (100, 128))


def _qkv(seed, b, sq, sk, h, d, dtype=np.float32):
    r = np.random.RandomState(seed)
    return tuple(torch.from_numpy(r.randn(*s).astype(dtype))
                 for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


def _zero_cols(t, dt):
    """t with zero columns up to dt: what the kernels read at width dt."""
    return torch.nn.functional.pad(t, (0, dt - t.shape[-1]))


@pytest.mark.parametrize("d,dt", SD_DIMS + PAD_DIMS)
@pytest.mark.parametrize("sk", [77, 96])
def test_pad_is_exact(d, dt, sk):
    """Zero columns up to the kernel width: plain = unpadded plain, out
    (fp32, atol 1e-6) and lse. ``_pad_head_dim`` leaves a multiple of 8 as
    it is (the kernels' zero fill stands for the pad) and pads any other d
    to its kernel width, with the scale of the original d."""
    q, k, v = _qkv(d + sk, 2, 96, sk, 2, d)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v)
    qp, kp, vp, scale, d0 = tfa._pad_head_dim(q, k, v, None)
    assert d0 == d
    if d % 8 == 0:
        assert (qp, kp, vp, scale) == (q, k, v, None)
        assert tfa.kernel_width(d) == dt
        qp, kp, vp = (_zero_cols(t, dt) for t in (q, k, v))
        scale = 1.0 / math.sqrt(d)
    assert qp.shape[-1] == dt and kp.shape[-1] == dt
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
    kernels' device; the wrappers' launch counts restored afterwards; every
    zero pad (``torch.nn.functional.pad``) counted in ``.pads``."""
    got = _Calls()
    got.pads = 0
    pad = torch.nn.functional.pad

    def counted_pad(*args, **kw):
        got.pads += 1
        return pad(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "pad", counted_pad)

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


@pytest.mark.parametrize("d,dt", SD_DIMS + ((256, 256),) + PAD_DIMS)
@pytest.mark.parametrize("sq,sk", [(4096, 4096), (256, 77), (64, 77)])
def test_dispatch_marshals_the_padded_head_dim(kernel_calls, d, dt, sq, sk):
    """b 2, h 8 at the UNet's shapes: K1 gets (b, sq, sk, h, nkv, d,
    causal 0, q_off sk - sq, window 0, scale 1/√d, no dropout) with d the
    true head dim and no pad made (SD-1.5's 40, 80, 160 and native 256);
    36 and 100 are padded (q, k, v: three pads) and K1 gets their kernel
    width, with the scale of the unpadded d."""
    b, h = 2, 8
    fa = tfa.flash_attention_fwd
    fa.launches, before = 0, dict(fa.by_d)
    with pytest.raises(_Captured):
        tfa.scaled_dot_product_attention(_meta(b, sq, h, d),
                                         _meta(b, sk, h, d),
                                         _meta(b, sk, h, d))
    marshalled = d if d % 8 == 0 else dt
    assert kernel_calls["flash_attention_fwd"] == [
        b, sq, sk, h, h, marshalled, 0, sk - sq, 0, 1.0 / math.sqrt(d), 0,
        1.0]
    assert kernel_calls.pads == (0 if d % 8 == 0 else 3)
    assert fa.launches == 0 and fa.by_d == before


def test_dispatch_refuses_what_k1_does_not_take(kernel_calls):
    """d > 256 raises (no kernel, no fallback); a gradient at kernel width
    256 (native 256, or 160 at its own width) reaches K1, K3 and K4's C
    entries with the true d and its scale, one launch each counted at 256,
    no pad made; the window and dropout at kernel width 256 (d 256 and
    160) name Queue B row 1 (K1) and rows 2-3 (K3, K4), through the
    wrappers and the dispatch; the kernels' own wrappers take no d that is
    not a multiple of 8 (36) or above 256 (264). Nothing else reaches a C
    entry."""
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
            assert kernel_calls[name][5] == d, (d, name)
            assert kernel_calls[name][9] == 1.0 / math.sqrt(d), (d, name)
        for w, n in zip(wraps, before):
            assert w.by_d == {t: n[t] + (t == 256) for t in n}, w.__name__
    assert kernel_calls.pads == 0
    kernel_calls.succeed = False
    kernel_calls.clear()
    lse = torch.empty(1, 2, 8, device="meta")
    for d in (256, 160):
        q = _meta(1, 8, 2, d)
        with pytest.raises(NotImplementedError, match="Queue B row 1"):
            tfa.flash_attention_fwd(q, q, q, is_causal=True, window=4)
        with pytest.raises(NotImplementedError, match="Queue B row 1"):
            tfa.flash_attention_fwd(q, q, q, dropout_p=0.1,
                                    key=torch.zeros(2, dtype=torch.int64))
        with pytest.raises(NotImplementedError, match="Queue B rows 1-3"):
            tfa.scaled_dot_product_attention(q, q, q, is_causal=True,
                                             window_size=4)
        for bwd in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
            with pytest.raises(NotImplementedError, match="Queue B rows 2-3"):
                bwd(q, q, q, q, lse, lse, is_causal=True, window=4)
            with pytest.raises(NotImplementedError, match="Queue B rows 2-3"):
                bwd(q, q, q, q, lse, lse, dropout_p=0.1,
                    key=torch.zeros(2, dtype=torch.int64))
    for d in (36, 264):
        qd = _meta(1, 8, 2, d)
        for call in (lambda: tfa.flash_attention_fwd(qd, qd, qd),
                     lambda: tfa.flash_attention_bwd_dq(qd, qd, qd, qd, lse,
                                                        lse),
                     lambda: tfa.flash_attention_bwd_dkv(qd, qd, qd, qd,
                                                         lse, lse)):
            with pytest.raises(ValueError,
                               match="head_dim a multiple of 8 up to 256"):
                call()
    assert kernel_calls == {}


@pytest.mark.parametrize("d,dt", SD_DIMS)
def test_gradient_rides_the_padded_kernel_d(kernel_calls, d, dt):
    """A gradient at d 40, 80 or 160 takes FlashAttention (K1 + K3/K4) at
    the true d, on the kernel width dt: its forward reaches K1 with d, and
    its backward K3 and K4 with d, each with the scale 1/√d, each launch
    counted at dt; no pad is made either way."""
    wraps = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
             tfa.flash_attention_bwd_dkv)
    with pytest.raises(_Captured):
        tfa.scaled_dot_product_attention(*(_meta(2, 64, 2, d, grad=True)
                                           for _ in range(3)))
    assert kernel_calls["flash_attention_fwd"][5] == d
    kernel_calls.succeed = True
    before = [dict(w.by_d) for w in wraps]
    out = tfa.scaled_dot_product_attention(*(_meta(2, 64, 2, d, grad=True)
                                             for _ in range(3)))
    assert out.shape == (2, 64, 2, d)
    out.backward(torch.empty_like(out))
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert kernel_calls[name][5] == d, name
        assert kernel_calls[name][9] == 1.0 / math.sqrt(d), name
    for w, n in zip(wraps, before):
        assert w.by_d == {t: n[t] + (t == dt) for t in n}, w.__name__
    assert kernel_calls.pads == 0


@pytest.mark.parametrize("d,dt", ((40, 64), (36, 64), (100, 128)))
def test_flash_fwd_lse_marshals_the_true_head_dim(kernel_calls, d, dt):
    """``flash_fwd_lse`` at d 40 hands K1 d 40 with the scale 1/√40, no
    pad made; at 36 and 100 it pads q, k, v to the kernel width and K1
    gets that width, with the unpadded d's scale."""
    with pytest.raises(_Captured):
        tfa.flash_fwd_lse(*(_meta(2, 64, 2, d) for _ in range(3)))
    got = kernel_calls["flash_attention_fwd"]
    assert got[5] == (d if d % 8 == 0 else dt)
    assert got[9] == 1.0 / math.sqrt(d)
    assert kernel_calls.pads == (0 if d % 8 == 0 else 3)


@pytest.mark.parametrize("d,dt", [(8, 64), (40, 64), (48, 64), (64, 64),
                                  (72, 128), (80, 128), (136, 256),
                                  (160, 256), (256, 256), (36, None),
                                  (100, None), (0, None), (264, None)])
def test_kernel_width(d, dt):
    """A multiple of 8 from 8 to 256 runs at the next of 64, 128, 256;
    any other d has no kernel width (the dispatch pads it, or raises)."""
    assert tfa.kernel_width(d) == dt


@pytest.mark.parametrize("d,dt", SD_DIMS + ((64, 64),))
def test_dead_row_sums_marshal_the_true_head_dim(monkeypatch, d, dt):
    """The dead rows' row sums (kernel R) on the kernels' device get the
    true d, and fill a (b, groups, kernel width) buffer, which K1 and K4
    read at that width; the wrapper returns its first d columns. d 36
    raises."""
    got = {}

    def entry(*args):
        got["args"] = [a for a in args if isinstance(a, (int, float))]
        got["out"] = args[1]
        return 0
    entry.argtypes = "set"
    lib = types.SimpleNamespace(attn_row_sums=entry)
    monkeypatch.setattr(tfa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tfa.dead_row_sums, "launches",
                        tfa.dead_row_sums.launches)
    x = _meta(2, 77, 8, d)
    out = tfa.dead_row_sums(x, 8, 1.0 / 77)
    assert got["out"].shape == (2, 8, dt)
    assert out.shape == (2, 8, d) and out.stride(1) == dt
    # b, R, NH, groups, d, nsplit: the true d
    assert got["args"][2:7] == [2, 77, 8, 8, d]
    with pytest.raises(ValueError, match="a multiple of 8 up to 256"):
        tfa.dead_row_sums(_meta(2, 77, 8, 36), 8, 1.0)


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
    """Attention with a gradient through zero columns up to the kernel
    width: the pad, FlashAttention at the padded d, the slice. For a d
    that is no multiple of 8 it is what the dispatch runs on the kernels'
    device (``_pad_head_dim``); for 40 and 80 the zeros stand for those the
    kernels read as TMA's fill."""
    d = q.shape[-1]
    dt = next(t for t in tfa.FWD_DIMS if t >= d)
    qp, kp, vp = (_zero_cols(t, dt) for t in (q, k, v))
    out = tfa.FlashAttention.apply(qp, kp, vp, False, 1.0 / math.sqrt(d),
                                   None, None)
    return out[..., :d]


@pytest.mark.parametrize("d", [40, 80, 36])
def test_gradient_through_the_pad(d):
    """Attention with a gradient through zero columns (pad, FlashAttention
    at the padded d, slice), run on CPU tensors (FlashAttention's plain
    forward and backward): torch's autograd of the pad and the slice gives
    the unpadded attention's out, dq, dk, dv (fp32, atol 1e-5), so the zero
    columns change no gradient. On CPU tensors the dispatch itself takes
    any head dim without a pad."""
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
