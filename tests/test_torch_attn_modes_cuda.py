"""K1, K3 and K4's general instantiations on the card against their plain
twins: segment ids (self and cross, a row no key matches), ALiBi (alone,
with the window, with kv_lens), the dense mask beside the window (a
left-padded batch row, whose pad queries see no valid key: dead rows), all
of them at once, the left-padded mask alone (the instantiation without the
window, segment ids and ALiBi), each of these beside dropout, and
``flash_fwd_lse`` with a g_lse cotangent. Every case launches each kernel twice with the same
bits. Marked ``cuda``: skipped where torch.cuda.is_available() is False;
run on a GPU machine with
``python -m pytest -m cuda --noconftest tests/test_torch_attn_modes_cuda.py``
(no jax there: this file imports none).
"""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# out within OUT_ATOL of the fp32 twin; the pairs' m + log l within
# LSE_ATOL (+ 2^-22·|m|); each gradient within GRAD_RTOL · max|plain|
OUT_ATOL, LSE_ATOL, GRAD_RTOL = 3e-2, 2e-3, 2.0 ** -6


def _segments(g, b, s, n, dev):
    """(b, s) int32 ids of n packed documents a row, cuts drawn from g."""
    cuts = torch.randint(1, s, (b, n - 1), generator=g, device=dev)
    return (torch.arange(s, device=dev)[None, None] >= cuts[..., None]).sum(
        1).to(torch.int32)


def _slopes(h, dev):
    return torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                        device=dev)


# name: (b, sq, sk, h, nkv, d, causal, modes)
CASES = {
    "seg_self_causal_d128": (2, 384, 384, 8, 2, 128, True, ("seg",)),
    "seg_self_full_d64": (2, 300, 300, 4, 4, 64, False, ("seg",)),
    "seg_cross_unmatched": (2, 256, 320, 4, 2, 64, False, ("seg_cross",)),
    "alibi_d128": (2, 384, 384, 8, 2, 128, True, ("alibi",)),
    "alibi_window_kv_lens": (2, 500, 500, 4, 2, 64, True,
                             ("alibi", "window", "kv_lens")),
    "mask_window_left_pad": (2, 640, 640, 8, 2, 128, True,
                             ("pad", "window")),
    "mask_left_pad": (2, 640, 640, 8, 2, 128, True, ("pad",)),
    "mask_float_window_d64": (2, 320, 320, 4, 1, 64, True,
                              ("float", "window")),
    "everything": (2, 448, 448, 8, 2, 128, True,
                   ("pad", "seg", "alibi", "window", "kv_lens")),
}


def _case(name, dev, seed=0):
    b, sq, sk, h, nkv, d, causal, modes = CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()
    q, k, v, do = mk(b, sq, h, d), mk(b, sk, nkv, d), mk(b, sk, nkv, d), \
        mk(b, sq, h, d)
    kw = dict(is_causal=causal)
    if "seg" in modes:
        kw["seg_q"] = kw["seg_k"] = _segments(g, b, sq, 4, dev)
    if "seg_cross" in modes:
        kw["seg_q"] = _segments(g, b, sq, 3, dev)
        kw["seg_k"] = _segments(g, b, sk, 3, dev)
        kw["seg_q"][1, 40:45] = 7
    if "alibi" in modes:
        kw["alibi_slopes"] = _slopes(h, dev)
    if "window" in modes:
        kw["window"] = 200
    if "kv_lens" in modes:
        kw["kv_lens"] = torch.tensor([sk, sk - 101], dtype=torch.int32,
                                     device=dev)
    if "pad" in modes:
        m = torch.ones(b, 1, 1, sk, dtype=torch.bool, device=dev)
        m[1, ..., :sk // 2 - 7] = False
        kw["attn_mask"] = m
    if "float" in modes:
        m = torch.randn(b, 1, sq, sk, generator=g, device=dev) * 2
        m[:, :, 9] = -1e4
        m[1, :, 100:110, :150] = float("-inf")
        kw["attn_mask"] = m
    return (q, k, v, do), kw


def _check(fa, q, k, v, do, kw):
    out, st = fa.flash_attention_fwd(q, k, v, **kw)
    out2, st2 = fa.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(st, st2)
    ref, ref_st = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_ATOL,
                               rtol=0)
    live = ref_st[..., 1] > -float("inf")
    lerr = (st.double().sum(-1) - ref_st.double().sum(-1)).abs() \
        - 2.0 ** -22 * ref_st[..., 0].double().abs()
    assert lerr[live].max().item() <= LSE_ATOL
    assert torch.equal(st[~live], ref_st[~live])
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **kw)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, st, delta,
                                                     **kw))
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    refs = fa.flash_attention_bwd_plain(q, k, v, out, st, do, **kw)
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        err = (got.float() - r).abs().max().item()
        assert err <= GRAD_RTOL * r.abs().max().item(), (name, err)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_general_mode_matches_plain(cuda, name):
    from paddle_tpu_torch.ops import flash_attention as fa
    (q, k, v, do), kw = _case(name, cuda)
    out = _check(fa, q, k, v, do, kw)
    if name == "seg_cross_unmatched":
        assert bool((out[1, 40:45] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seg_self_causal_d128", "alibi_d128",
                                  "mask_window_left_pad", "mask_left_pad",
                                  "everything"])
def test_general_mode_with_dropout_matches_plain(cuda, name):
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import flash_attention as fa
    (q, k, v, do), kw = _case(name, cuda, seed=1)
    kw.update(dropout_p=0.1, key=rng.PRNGKey(11))
    _check(fa, q, k, v, do, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,s,d,causal", [(8, 2, 384, 128, True),
                                              (4, 4, 300, 64, False)])
def test_flash_fwd_lse_matches_plain(cuda, h, nkv, s, d, causal):
    """K1's out and lse, and K3/K4's gradients under a g_lse beside dO,
    through the Function, against the plain twins."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda *sh: torch.randn(*sh, generator=g, device=cuda).bfloat16()
    q, k, v = mk(2, s, h, d), mk(2, s, nkv, d), mk(2, s, nkv, d)
    do = mk(2, s, h, d)
    g_lse = torch.randn(2, h, s, generator=g, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_fwd_lse(*leaves, is_causal=causal)
    torch.autograd.backward([out, lse], [do, g_lse])
    assert fa.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, is_causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_ATOL,
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    refs = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(),
                                        do, is_causal=causal, g_lse=g_lse)
    for name, t, r in zip(("dq", "dk", "dv"), leaves, refs):
        err = (t.grad.float() - r).abs().max().item()
        assert err <= GRAD_RTOL * r.abs().max().item(), (name, err)
