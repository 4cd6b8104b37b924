"""The attention backward of paddle_tpu_torch against paddle_tpu.

On the CPU the JAX package's scaled_dot_product_attention takes its XLA path
(its flash Pallas kernels have no interpret mode: ``use_pallas()`` is False
off the TPU), and ``jax.vjp`` of it is the reference. The port's side is
its plain backward, ``flash_attention_bwd_plain`` fed with the plain
forward's (out, lse), and the autograd Function ``FlashAttention`` that
``scaled_dot_product_attention`` goes through when a gradient is needed.
Inputs are fp32, made with numpy from a seed; dq, dk and dv are held to the
reference at atol 1e-5 (fp32 sums of O(1) terms over at most 333 keys or
200 queries, and scores over at most 256 lanes; fp32 rounding there stays
near 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5

# (b, sq, sk, h, nkv, d, causal, kv_lens)
CASES = [
    (2, 9, 9, 4, 4, 32, True, None),            # causal, sq = sk
    (2, 6, 13, 4, 4, 64, True, None),           # causal, sq < sk
    (2, 12, 5, 4, 2, 32, True, None),           # sq > sk: fully-masked rows
    (2, 7, 11, 4, 4, 64, False, None),          # non-causal
    (2, 8, 8, 4, 2, 128, True, None),           # GQA, d = 128
    (3, 6, 10, 4, 2, 32, False, [10, 4, 0]),    # kv_lens, a row of 0
    (2, 5, 40, 4, 1, 64, True, [33, 0]),        # MQA, causal + kv_lens
    # the edges of the CUDA kernels' tiles (64-query tiles streamed past
    # 128-key blocks, 128-row forward tiles): sq around the tiles, sk off
    # them, a causal offset sk - sq inside a key block, GQA 4 and 8
    (2, 1, 300, 8, 2, 64, True, [300, 0]),      # sq 1, GQA 4
    (2, 65, 333, 8, 1, 128, True, [333, 100]),  # sq 65, GQA 8, d 128
    (2, 127, 127, 8, 2, 64, True, None),        # sq 127
    (2, 129, 200, 8, 1, 128, True, [200, 0]),   # sq 129, GQA 8, a row of 0
    (1, 200, 333, 8, 2, 64, False, [300]),      # sq 200, non-causal
    # K3's edges (128-query blocks, 64 rows a consumer group, past 64-key
    # tiles): sq 193 with an offset inside a key tile; sq 64 (no rows for
    # the second group) with sk 65 (one key in the last tile) and a batch
    # row of one key
    (1, 193, 260, 8, 2, 64, True, [197]),       # sq 193, GQA 4
    (2, 64, 65, 4, 4, 128, True, [65, 1]),      # sq 64, sk 65, d 128
    # head dim 256 (on the card K3's 32-key tiles and K4's 64-key blocks
    # whose consumer groups split the columns) and SD-1.5's 160 (padded to
    # 256 there): the UNet's non-causal cross-attention to 77 keys, a
    # causal offset (sk - sq) with GQA 2 and a batch row of kv_len 0, and a
    # 16 x 16 self-attention at d 160
    (2, 64, 77, 4, 4, 256, False, None),        # cross-attention, d 256
    (2, 9, 40, 4, 2, 256, True, [40, 0]),       # offset, GQA, a row of 0
    (2, 16, 16, 4, 4, 160, False, None),        # d 160
]
IDS = [f"b{c[0]}-sq{c[1]}-sk{c[2]}-h{c[3]}-kv{c[4]}-d{c[5]}"
       f"-{'causal' if c[6] else 'full'}-{'lens' if c[7] else 'nolens'}"
       for c in CASES]



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run shares the CPU among several test workers: keep this
    file's torch ops on one thread, so they do not crowd out the other
    workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _inputs(seed, b, sq, sk, h, nkv, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sq, h, d).astype(np.float32))


def _reference(q, k, v, do, causal, lens):
    """(out, dq, dk, dv) of the JAX package, by jax.vjp (jitted)."""
    kl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def out_and_grads(q_, k_, v_, do_):
        f = lambda a, b, c: jfa.scaled_dot_product_attention(
            a, b, c, is_causal=causal, kv_lens=kl)
        out, pull = jax.vjp(f, q_, k_, v_)
        return (out, *pull(do_))

    res = jax.jit(out_and_grads)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return [np.asarray(t) for t in res]


@pytest.mark.parametrize("b,sq,sk,h,nkv,d,causal,lens", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(b, sq, sk, h, nkv, d, causal, lens):
    """flash_attention_bwd_plain on the plain forward's (out, lse) gives
    jax.vjp's dq, dk, dv (atol 1e-5, fp32); a kv_len of 0 gives zeros."""
    q, k, v, do = _inputs(0, b, sq, sk, h, nkv, d)
    ref = _reference(q, k, v, do, causal, lens)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out, lse = tfa.flash_attention_fwd_plain(*t[:3], is_causal=causal,
                                             kv_lens=kl)
    grads = tfa.flash_attention_bwd_plain(*t[:3], out, lse, t[3],
                                          is_causal=causal, kv_lens=kl)
    np.testing.assert_allclose(out.numpy(), ref[0], atol=ATOL)
    for name, g, r in zip("qkv", grads, ref[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL,
                                   err_msg=f"d{name}")
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert not grads[0][row].any() and not grads[1][row].any() \
            and not grads[2][row].any()


@pytest.mark.parametrize("b,sq,sk,h,nkv,d,causal,lens", CASES, ids=IDS)
def test_autograd_function_matches_jax_vjp(b, sq, sk, h, nkv, d, causal,
                                           lens):
    """scaled_dot_product_attention on CPU tensors that require grad goes
    through FlashAttention (checked on grad_fn) and backward() gives
    jax.vjp's gradients (atol 1e-5, fp32) — here too on the strided views
    a qkv split makes."""
    q, k, v, do = _inputs(1, b, sq, sk, h, nkv, d)
    ref = _reference(q, k, v, do, causal, lens)
    # q, k, v as non-contiguous views of one buffer, as GPT's split gives
    packed = torch.from_numpy(np.concatenate(
        [q.reshape(b, sq, -1), np.zeros((b, sq, 3), np.float32)], -1)
    ).requires_grad_(True)
    qt = packed[..., :h * d].reshape(b, sq, h, d)
    kt = torch.from_numpy(k).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    assert not qt.is_contiguous()
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = tfa.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           kv_lens=kl)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), ref[0], atol=ATOL)
    dq = packed.grad[..., :h * d].reshape(b, sq, h, d)
    for name, g, r in zip("qkv", (dq, kt.grad, vt.grad), ref[1:]):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL,
                                   err_msg=f"d{name}")
    assert not packed.grad[..., h * d:].any()


def test_no_grad_keeps_the_plain_path():
    """Without a gradient the CPU dispatch is unchanged (_xla_attention:
    no grad_fn at all), and the CPU never counts a kernel launch."""
    q, k, v, _ = _inputs(2, 1, 4, 4, 2, 2, 16)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = tfa.scaled_dot_product_attention(*t, is_causal=True)
    assert out.grad_fn is None
    assert tfa.flash_attention_bwd_dq.launches == 0
    assert tfa.flash_attention_bwd_dkv.launches == 0


def test_cpu_grad_path_refuses_dropout_and_keeps_dense_masks():
    """Dropout, once refused here, runs through the Function's plain
    forward and backward: dq, dk and dv equal ``jax.vjp`` of the reference
    with the same "dropout" key (atol 1e-5). A dense mask on the CPU
    differentiates through the Function's plain forward and backward too
    (the Function carries the mask, which gets no gradient)."""
    from paddle_tpu.core import rng as jrng
    from paddle_tpu_torch.core import rng as trng
    q, k, v, do = _inputs(3, 2, 5, 7, 4, 4, 8)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    key = jax.random.PRNGKey(5)
    with trng.rng_guard(dropout=torch.from_numpy(
            np.asarray(key).astype(np.int64))):
        tfa.scaled_dot_product_attention(*t, dropout_p=0.1).backward(
            torch.from_numpy(do))

    def fd(q_, k_, v_):
        with jrng.rng_guard(dropout=key):
            return jfa.scaled_dot_product_attention(q_, k_, v_,
                                                    dropout_p=0.1)
    _, pull = jax.vjp(fd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip((t[0].grad, t[1].grad, t[2].grad), pull(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    mask = np.random.RandomState(3).rand(2, 1, 5, 7) > 0.3
    mask[..., 0] = True
    out = tfa.scaled_dot_product_attention(*t,
                                           attn_mask=torch.from_numpy(mask))
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    f = lambda q_, k_, v_: jfa.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=jnp.asarray(mask))
    _, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip((t[0].grad, t[1].grad, t[2].grad), pull(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
