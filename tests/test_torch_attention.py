"""Attention, RoPE and RMSNorm of paddle_tpu_torch against paddle_tpu.

The port's plain attention (what a CPU tensor runs) is held to the JAX
package's scaled_dot_product_attention — its XLA path on the CPU — in fp32
at atol 1e-5, on the same numpy inputs. The CPU side of the flash-attention
wrapper (flash_attention_fwd on CPU tensors = its plain twin) is held to
the same outputs and to a log-sum-exp computed directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import rms_norm as jrms
from paddle_tpu.ops import rope as jrope
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import rms_norm as trms
from paddle_tpu_torch.ops import rope as trope


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _qkv(seed, b, sq, sk, h, nkv, d):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, h, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32),
            r.randn(b, sk, nkv, d).astype(np.float32))


def _both(q, k, v, jax_kw, torch_kw):
    oj = jfa.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jax_kw)
    ot = tfa.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **torch_kw)
    return np.asarray(oj), ot.numpy()


@pytest.mark.parametrize("nkv", [4, 2, 1])         # MHA, GQA, MQA
@pytest.mark.parametrize("sq,sk", [(9, 9), (5, 12), (12, 5)])
def test_causal_bottom_right(nkv, sq, sk):
    """No-cache causal, sq != sk included (bottom-right aligned; sk < sq
    leaves fully-masked top rows, which both zero)."""
    q, k, v = _qkv(0, 2, sq, sk, 4, nkv, 16)
    oj, ot = _both(q, k, v, dict(is_causal=True), dict(is_causal=True))
    np.testing.assert_allclose(ot, oj, atol=ATOL)


@pytest.mark.parametrize("start,s", [(0, 7), (5, 3), (11, 1)])
def test_cache_prefill_mask_form(start, s):
    """The KV-cache attention: the reference's dense bool mask
    k_pos <= start + i over the whole cache vs the port's structured
    (causal_offset=start, kv_lens=start+s) — the LlamaAttention call."""
    total = 16
    q, k, v = _qkv(1, 2, s, total, 4, 2, 16)
    k[:, start + s:] = 1e3          # the unfilled tail must not leak in
    q_pos = start + np.arange(s)[:, None]
    mask = (np.arange(total)[None, :] <= q_pos)[None, None]
    oj, ot = _both(q, k, v, dict(attn_mask=jnp.asarray(mask)),
                   dict(is_causal=True, causal_offset=start,
                        kv_lens=start + s))
    np.testing.assert_allclose(ot, oj, atol=ATOL)


def test_kv_lens_and_fully_masked_rows():
    q, k, v = _qkv(2, 3, 6, 10, 4, 2, 8)
    lens = np.array([10, 3, 0], np.int32)      # row 2 sees no key at all
    oj, ot = _both(q, k, v, dict(kv_lens=jnp.asarray(lens)),
                   dict(kv_lens=torch.from_numpy(lens)))
    np.testing.assert_allclose(ot, oj, atol=ATOL)
    assert np.all(ot[2] == 0.0)


def test_dense_masks_plain_path():
    q, k, v = _qkv(3, 2, 5, 7, 4, 4, 8)
    r = np.random.RandomState(3)
    bmask = r.rand(2, 1, 5, 7) > 0.3
    bmask[..., 0] = True
    fmask = (r.randn(2, 4, 5, 7) * 2).astype(np.float32)
    for m in (bmask, fmask):
        oj, ot = _both(q, k, v, dict(attn_mask=jnp.asarray(m)),
                       dict(attn_mask=torch.from_numpy(m)))
        np.testing.assert_allclose(ot, oj, atol=ATOL)


@pytest.mark.parametrize("q_off,lens", [(0, [12, 12]), (3, [9, 4]),
                                         (None, [12, 0])])
def test_flash_fwd_cpu_twin(q_off, lens):
    """flash_attention_fwd on CPU tensors = the plain twin: its output
    equals the reference sdpa, its lse equals logsumexp of the visible
    scores, and fully-masked rows give 0 and lse = -1e30."""
    q, k, v = _qkv(4, 2, 6, 12, 4, 2, 16)
    kl = torch.tensor(lens, dtype=torch.int32)
    ot, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True, causal_offset=q_off, kv_lens=kl)
    off = 12 - 6 if q_off is None else q_off
    mask = ((np.arange(12)[None, :] <= off + np.arange(6)[:, None])[None]
            & (np.arange(12)[None, None, :] < np.array(lens)[:, None, None]))
    oj = np.asarray(jfa.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=jnp.asarray(mask[:, None])))
    live = mask.any(-1)                              # (b, sq)
    oj = np.where(live[..., None, None], oj, 0.0)
    np.testing.assert_allclose(ot.numpy(), oj, atol=ATOL)
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(16)
    s = np.where(mask[:, None], s, -np.inf)
    with np.errstate(invalid="ignore"):
        ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
            + s.max(-1)
    ref = np.where(live[:, None], ref, -1e30)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-5)
    assert tfa.flash_attention_fwd.launches == 0   # CPU: no kernel launch


# The edges of the CUDA kernel's tiles (128 query rows a block, 128 keys a
# TMA stage) at which its plain twin is the card's yardstick: sq around the
# tile, sk off it, a causal offset that starts inside a key tile, GQA 4 and
# 8, a batch row of kv_len 0, head dims 64 and 128.
# (b, h, nkv, sq, sk, d, causal_offset, kv_lens)
TILE_EDGES = [
    (2, 8, 2, 1, 300, 128, 299, [300, 0]),
    (2, 8, 1, 65, 333, 64, 200, [333, 100]),
    (2, 8, 2, 127, 127, 128, None, [127, 127]),
    (2, 8, 1, 129, 200, 64, 71, [200, 0]),
    (1, 8, 2, 200, 1000, 128, 777, [1000]),
]


@pytest.mark.parametrize("b,h,nkv,sq,sk,d,q_off,lens", TILE_EDGES,
                         ids=[f"sq{c[3]}-sk{c[4]}-d{c[5]}-gqa{c[1] // c[2]}"
                              for c in TILE_EDGES])
def test_flash_fwd_twin_at_kernel_tile_edges(b, h, nkv, sq, sk, d, q_off,
                                             lens):
    """The plain twin at the kernel's tile edges: out equals the reference
    sdpa over the equivalent dense mask (rows with no visible key 0), lse
    equals logsumexp of the visible scaled scores (-1e30 where none)."""
    q, k, v = _qkv(7, b, sq, sk, h, nkv, d)
    kl = torch.tensor(lens, dtype=torch.int32)
    ot, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True, causal_offset=q_off, kv_lens=kl)
    off = sk - sq if q_off is None else q_off
    mask = ((np.arange(sk)[None, :] <= off + np.arange(sq)[:, None])[None]
            & (np.arange(sk)[None, None, :] < np.array(lens)[:, None, None]))
    oj = np.asarray(jfa.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=jnp.asarray(mask[:, None])))
    live = mask.any(-1)                              # (b, sq)
    oj = np.where(live[..., None, None], oj, 0.0)
    np.testing.assert_allclose(ot.numpy(), oj, atol=ATOL)
    kr = np.repeat(k, h // nkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(d)
    s = np.where(mask[:, None], s, -np.inf)
    with np.errstate(invalid="ignore"):
        ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
            + s.max(-1)
    ref = np.where(live[:, None], ref, -1e30)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_cuda_path_refuses_what_it_does_not_take():
    """Attention dropout, once refused, runs on a CPU tensor: it equals the
    reference's dropped attention under the same "dropout" key (fp32, atol
    1e-5) and draws one key from the stream. The dense mask, once refused,
    runs on the kernels, beside the window and dropout too; what stays
    refused on the kernel path is a mask at head dim 256 (beside the
    window here), asserted by name on a meta tensor (a non-CPU tensor
    takes the kernels' dispatch)."""
    import jax
    from paddle_tpu.core import rng as jrng
    from paddle_tpu_torch.core import rng as trng
    q, k, v = _qkv(11, 1, 5, 5, 2, 2, 16)
    key = jax.random.PRNGKey(3)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    with jrng.rng_guard(dropout=key):
        ref = jfa.scaled_dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), dropout_p=0.1,
            is_causal=True)
    with trng.rng_guard(dropout=tkey) as frame:
        out = tfa.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), dropout_p=0.1,
            is_causal=True)
    assert frame.counters == {"dropout": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    m = torch.zeros(1, 2, 2, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="dense attn_mask"):
        tfa.scaled_dot_product_attention(
            m, m, m, attn_mask=torch.ones(1, 1, 2, 2, dtype=torch.bool,
                                          device="meta"), is_causal=True,
            window_size=1)


@pytest.mark.parametrize("start", [0, 37])
def test_rope(start):
    s, hd = 9, 32
    pos = start + np.arange(s)
    cj, sj = jrope.rope_cos_sin(s, hd, position_ids=jnp.asarray(pos))
    ct, st = trope.rope_cos_sin(s, hd, position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    x = np.random.RandomState(5).randn(2, s, 3, hd).astype(np.float32)
    yj = jrope.apply_rotary_pos_emb(jnp.asarray(x), cj, sj)
    yt = trope.apply_rotary_pos_emb(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    r = np.random.RandomState(6)
    x = r.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * r.randn(64)).astype(np.float32)
    yj = np.asarray(jrms.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                  1e-5), np.float32)
    tdt = getattr(torch, dtype)
    yt = trms.rms_norm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), 1e-5).float().numpy()
    # bf16: the same fp32 normalisation rounded twice (to bf16, and the
    # bf16 product): one bf16 ulp where the fp32 sums straddle a boundary
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-2, rtol=2 ** -7)
    np.testing.assert_allclose(yt, yj, **tol)
