"""K1, K3 and K4 at head dims they read in place (a multiple of 8 up to 256,
run at the next kernel width of 64, 128 and 256, the columns past d TMA's
zero fill), on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is False; run on a GPU machine with
``python -m pytest -m cuda --noconftest tests/test_torch_head_dims_cuda.py``
(no jax there: this file imports none).

At the true d each kernel is bitwise the same kernel on the inputs
zero-padded to the kernel width, sliced: the zero columns add +0 to every
score and give zero products. That holds at SD-1.5's UNet shapes (K1's
trimmed Q·Kᵀ there), at other multiples of 8, and in the window, dropout
and general modes (a bool mask with dead rows: the row sums of
``csrc/attn_rows.cu`` at the true d). Two launches give the same bits, the
dispatch makes no pad, and a C entry writes nothing past its output.
"""

import math

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16)


def _qkvo(seed, b, sq, sk, h, nkv, d):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (_rand(gen, b, sq, h, d), _rand(gen, b, sk, nkv, d),
            _rand(gen, b, sk, nkv, d), _rand(gen, b, sq, h, d))


def _pad(t, dt):
    return torch.nn.functional.pad(t, (0, dt - t.shape[-1]))


def _equal(xs, ys):
    return all(bool(torch.equal(x, y)) for x, y in zip(xs, ys))


# SD-1.5's UNet calls at b 2, 8 heads (self-attention and cross-attention to
# the 77-token context) and other multiples of 8: (d, sq, sk)
UNET = [(40, 4096, 4096), (40, 4096, 77), (80, 1024, 1024), (80, 1024, 77),
        (160, 256, 256), (160, 256, 77), (160, 64, 64), (160, 64, 77)]
OTHER = [(8, 200, 333), (24, 129, 77), (48, 300, 300), (56, 128, 200),
         (72, 77, 129), (96, 256, 100), (136, 100, 300), (200, 129, 65),
         (248, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,sk", UNET + OTHER)
def test_true_d_is_the_padded_launch_sliced(cuda, d, sq, sk):
    """K1 (out, lse), K3 (dq) and K4 (dk, dv) at the true d equal the same
    kernels on q, k, v, dO zero-padded to the kernel width, sliced, bit for
    bit (the same lse and Δ in the backward); a second launch at d gives
    the same bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _qkvo(d + sq + sk, 2, sq, sk, 8, 8, d)
    dt = fa.kernel_width(d)
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = (_pad(t, dt) for t in (q, k, v, do))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v)
        out2, lse2 = fa.flash_attention_fwd(q, k, v)
        outp, lsep = fa.flash_attention_fwd(qp, kp, vp, scale=scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        got = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)]
        again = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)]
        padded = [fa.flash_attention_bwd_dq(qp, kp, vp, dop, lse, delta,
                                            scale=scale),
                  *fa.flash_attention_bwd_dkv(qp, kp, vp, dop, lse, delta,
                                              scale=scale)]
    torch.cuda.synchronize()
    assert torch.equal(out, outp[..., :d]) and torch.equal(lse, lsep)
    assert not outp[..., d:].any()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert _equal(got, [t[..., :d] for t in padded])
    assert not any(t[..., d:].any() for t in padded)
    assert _equal(got, again)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got + [out])


# (name, keyword arguments) of the modes that run the full Q·Kᵀ loop at a
# d below the kernel width
MODES = [
    ("causal_gqa_kv_lens", dict(is_causal=True, kv_lens=[300, 0])),
    ("window", dict(is_causal=True, window=70)),
    ("dropout", dict(is_causal=True, dropout_p=0.2)),
    ("bool_mask_dead_rows", dict(attn_mask="bool")),
    ("fp32_mask", dict(attn_mask="float")),
    ("segments_alibi", dict(is_causal=True, seg=True, alibi=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("d", [40, 80])
def test_modes_at_true_d_are_the_padded_launch_sliced(cuda, name, kw, d):
    """The window, dropout (the same keep words), the general mode (a bool
    mask with dead rows, whose mean of v and dsum come from the row sums
    at the true d; an fp32 mask; segment ids with ALiBi), causal GQA with
    kv_lens: K1's out and statistics and K3's and K4's gradients at the
    true d (on one lse and Δ) equal their launches on the zero-padded
    inputs, sliced."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import flash_attention as fa
    b, h, nkv, sq, sk = 2, 8, 2, 300, 300
    q, k, v, do = _qkvo(d + 7, b, sq, sk, h, nkv, d)
    dt = fa.kernel_width(d)
    kw = dict(kw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    if "kv_lens" in kw:
        kw["kv_lens"] = torch.tensor(kw["kv_lens"], dtype=torch.int32,
                                     device="cuda")
    if kw.get("dropout_p"):
        kw["key"] = rng.PRNGKey(5)
    if kw.get("attn_mask") == "bool":
        m = torch.rand(b, 1, sq, sk, generator=gen, device="cuda") > 0.3
        m[:, :, 5:70] = False         # dead rows
        kw["attn_mask"] = m
    elif kw.get("attn_mask") == "float":
        kw["attn_mask"] = torch.randn(b, h, sq, sk, generator=gen,
                                      device="cuda")
    if kw.pop("seg", False):
        seg = (torch.arange(sq, device="cuda") // 97).to(torch.int32)
        kw["seg_q"] = kw["seg_k"] = seg.expand(b, sq).contiguous()
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = torch.linspace(0.05, 0.5, h, device="cuda")
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = (_pad(t, dt) for t in (q, k, v, do))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        outp, lsep = fa.flash_attention_fwd(qp, kp, vp, scale=scale, **kw)
        # one Δ for both: torch's row sum over d and over dt columns may
        # round differently
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        got = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)]
        padded = [fa.flash_attention_bwd_dq(qp, kp, vp, dop, lse, delta,
                                            scale=scale, **kw),
                  *fa.flash_attention_bwd_dkv(qp, kp, vp, dop, lse, delta,
                                              scale=scale, **kw)]
    torch.cuda.synchronize()
    assert torch.equal(out, outp[..., :d])
    assert torch.equal(lse.nan_to_num(), lsep.nan_to_num())
    assert _equal(got, [t[..., :d] for t in padded])


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,sk", [(40, 4096, 77), (80, 1024, 1024),
                                     (160, 64, 77), (24, 129, 77)])
def test_dispatch_makes_no_pad(cuda, monkeypatch, d, sq, sk):
    """A gradient through the dispatch at a d the kernels read in place
    launches K1, K3 and K4 once each, counted at the kernel width, and
    never pads (forward or backward); its gradients are the wrappers'."""
    from paddle_tpu_torch.ops import flash_attention as fa
    pads = []
    pad = torch.nn.functional.pad
    monkeypatch.setattr(torch.nn.functional, "pad",
                        lambda *a, **kw: pads.append(1) or pad(*a, **kw))
    q, k, v, do = _qkvo(d, 2, sq, sk, 8, 8, d)
    wraps = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)
    before = [dict(w.by_d) for w in wraps]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.scaled_dot_product_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert pads == []
    dt = fa.kernel_width(d)
    for w, n in zip(wraps, before):
        assert w.by_d == {t: n[t] + (t == dt) for t in n}, w.__name__
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert torch.equal(out.detach(), o)
    assert _equal([t.grad for t in leaves], [dq, dk, dv])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160, 24])
def test_nothing_written_past_the_outputs(cuda, d):
    """K1's, K3's and K4's C entries on out, dq, dk and dv buffers with
    4096 sentinel elements past their b·s·h·d: the sentinels stay, and the
    buffers hold the wrappers' bits."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    b, sq, sk, h = 2, 200, 77, 8
    q, k, v, do = _qkvo(d + 1, b, sq, sk, h, h, d)
    scale = 1.0 / math.sqrt(d)
    tail, sentinel = 4096, 7.0

    def guarded(like):
        buf = torch.full((like.numel() + tail,), sentinel,
                         dtype=torch.bfloat16, device="cuda")
        return buf, buf[:like.numel()].view(like.shape)

    def intact(buf, like):
        return bool((buf[like.numel():] == sentinel).all())

    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        want = [fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)]
    ints = [b, sq, sk, h, h, d, 0, sk - sq, 0, scale, None, None, 0, 1.0,
            _build.stream_of(q)]
    ptr = _build.ptr
    bo, o2 = guarded(q)
    lse2 = torch.empty_like(lse)
    lib = fa._kernel_lib("flash_attention", "flash_attention_fwd", 6, 9)
    _build.check(lib.flash_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bo),
                                         ptr(lse2), None, *ints), "K1")
    head = [ptr(t) for t in (q, k, v, do, lse, delta)]
    (bq, dq), (bk, dk), (bv, dv) = guarded(q), guarded(k), guarded(v)
    lib = fa._kernel_lib("flash_attention_bwd", "flash_attention_bwd_dq", 8,
                         9)
    _build.check(lib.flash_attention_bwd_dq(*head, ptr(bq), None, *ints),
                 "K3")
    lib = fa._kernel_lib("flash_attention_bwd", "flash_attention_bwd_dkv", 9,
                         9)
    _build.check(lib.flash_attention_bwd_dkv(*head, ptr(bk), ptr(bv), None,
                                             *ints), "K4")
    torch.cuda.synchronize()
    assert intact(bo, o2) and torch.equal(o2, out)
    assert torch.equal(lse2, lse)
    for buf, got, w in zip((bq, bk, bv), (dq, dk, dv), want):
        assert intact(buf, got) and torch.equal(got, w)
