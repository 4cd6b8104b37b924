"""Functional ops — the subset of ``paddle_tpu/nn/functional.py`` Llama calls."""

import torch


def silu(x):
    return torch.nn.functional.silu(x)


def linear(x, weight, bias=None):
    """y = x @ W (+ b). Weight layout (in, out) — matches the reference."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight):
    return weight[ids]


def rms_norm(x, weight=None, epsilon=1e-6):
    from paddle_tpu_torch.ops import rms_norm as _rms
    return _rms.rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 kv_lens=None, causal_offset=None):
    """q/k/v: (batch, seq, heads, head_dim) — the reference's layout.

    On CUDA tensors this runs the hand-written flash-attention kernel; on
    CPU tensors the plain version (see ``ops.flash_attention``)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return fa.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training, scale=scale,
        kv_lens=kv_lens, causal_offset=causal_offset)
