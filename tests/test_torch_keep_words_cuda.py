"""Kernel W (``ops.dropout.attention_keep_words``, ``csrc/dropout.cu``) on the
card against its plain twin, and K1 / K3 / K4 reading its words. Marked
``cuda``: skipped where torch.cuda.is_available() is False; run on a GPU
machine with
``python -m pytest -m cuda --noconftest tests/test_torch_keep_words_cuda.py``
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


# (b, h, sq, sk, causal, causal_offset, kv_lens, window, everything)
CASES = [
    (2, 4, 1, 1, True, None, None, None, False),        # one key
    (2, 4, 65, 200, True, None, [200, 0], None, False),  # a kv_len-0 row
    (1, 3, 129, 5000, False, None, [4999], None, False),  # two 32-word chunks
    (2, 8, 384, 1084, True, 700, None, 200, False),     # offset, window
    (2, 2, 300, 300, True, -20, None, 1, False),        # rows before key 0
    (1, 2, 257, 257, True, None, None, None, False),    # odd sq: a lone row
    (2, 4, 256, 333, True, None, [333, 100], 64, True),  # every key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", [0.1, 0.9])
def test_keep_words_kernel_matches_plain_bitwise(cuda, case, p):
    """Every word of kernel W equals the plain twin's (torch threefry on
    the card, packed), and two launches are equal."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import dropout as dops
    b, h, sq, sk, causal, off, lens, window, every = case
    key = rng.fold_in(rng.PRNGKey(11), sq)
    kw = dict(is_causal=causal, causal_offset=off, window=window,
              everything=every, device=cuda,
              kv_lens=None if lens is None else torch.tensor(
                  lens, dtype=torch.int32, device=cuda))
    n = dops.attention_keep_words.launches
    w = dops.attention_keep_words(key, p, b, h, sq, sk, **kw)
    assert dops.attention_keep_words.launches == n + 1
    assert w.shape == (b, h, sq, dops.keep_words_width(sk))
    assert torch.equal(w, dops.attention_keep_words_plain(key, p, b, h, sq,
                                                          sk, **kw))
    assert torch.equal(w, dops.attention_keep_words(key, p, b, h, sq, sk,
                                                    **kw))


@pytest.mark.cuda
def test_keep_words_kernel_past_two_to_the_32(cuda):
    """Where the flat index ((bi·h + hi)·sq + q)·sk + k passes 2^32 (1 × 64
    × 8200 × 8200, kv_len 8000: row 523776 crosses it at key 4096, inside
    its visible keys), the crossing row, four rows on each side and the
    last row equal the port's torch threefry of their flat indices, packed,
    bit for bit (the whole plain twin would need 4.3 G indices)."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import dropout as dops
    b, h, sq, sk, kvl = 1, 64, 8200, 8200, 8000
    key = rng.fold_in(rng.PRNGKey(11), 32)
    w = dops.attention_keep_words(
        key, 0.1, b, h, sq, sk, kv_lens=torch.tensor(
            [kvl], dtype=torch.int32, device=cuda), device=cuda)
    ww = w.shape[-1]
    cross = (1 << 32) // sk
    assert cross * sk < 1 << 32 < (cross + 1) * sk
    rows = torch.tensor(list(range(cross - 4, cross + 5)) + [b * h * sq - 1],
                        dtype=torch.int64, device=cuda)
    keys = torch.arange(sk, dtype=torch.int64, device=cuda)
    idx = rows[:, None] * sk + keys[None, :]
    kd = key.to(cuda)
    y1, y2 = rng.threefry2x32(kd[0], kd[1], idx >> 32, idx & 0xFFFFFFFF)
    z = (((y1 ^ y2) >> 9) < dops.keep_threshold(0.1)) & (keys < kvl)
    ref = dops._pack_bits(z, ww * 32).view(torch.int32)
    assert torch.equal(w.view(-1, ww)[rows], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,causal,q_off,lens,window", [
    (4, 4, 256, 256, 64, True, None, None, None),
    (16, 4, 300, 333, 128, True, 33, [333, 100], None),
    (8, 2, 384, 1084, 128, True, 700, None, 200)])
def test_k1_k4_on_given_words_equal_their_own(cuda, h, nkv, sq, sk, d,
                                              causal, q_off, lens, window):
    """K1, K3 and K4 given the call's words (as FlashAttention hands them
    over) give the bits of the same wrappers making their own from the key;
    the autograd Function launches W once a forward and K1, K3, K4 once
    each."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import dropout as dops
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(12)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d), \
        mk(2, sq, h, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda)
    key = rng.fold_in(rng.PRNGKey(3), 2)
    base = dict(is_causal=causal, causal_offset=q_off, kv_lens=kl,
                window=window)
    kw = dict(base, dropout_p=0.1, key=key)
    words = dops.attention_keep_words(key, 0.1, 2, h, sq, sk, causal, q_off,
                                      kl, window, device=cuda)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out_w, lse_w = fa.flash_attention_fwd(q, k, v, keep_words=words, **kw)
    assert torch.equal(out, out_w) and torch.equal(lse, lse_w)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    own = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    given = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                       keep_words=words, **base,
                                       dropout_p=0.1)
    assert all(torch.equal(a, b) for a, b in zip(own, given))
    dq_own = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dq_own, fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, keep_words=words, **base, dropout_p=0.1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counts = lambda: (dops.attention_keep_words.launches,
                      fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)
    before = counts()
    o = fa.FlashAttention.apply(*leaves, causal, None, kl, q_off, window,
                                0.1, key)
    o.backward(do)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]
    assert torch.equal(o.detach(), out)
    assert torch.equal(leaves[0].grad, dq_own)
    assert torch.equal(leaves[1].grad, own[0])
    assert torch.equal(leaves[2].grad, own[1])
