"""Rotary position embedding (port of ``paddle_tpu/ops/rope.py``).

NeoX halves, layout (batch, seq, heads, head_dim). The inverse frequencies
are computed with numpy in float32 exactly as the reference does, so the
cos/sin tables agree with it to the last bit of the angle.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _freqs(head_dim: int, base: float):
    return 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))


def rope_cos_sin(seq_len, head_dim, base=10000.0, position_ids=None,
                 device=None):
    """(seq, head_dim) cos and sin tables (or (..., seq, head_dim) for a
    batched `position_ids`)."""
    if position_ids is not None:
        device = position_ids.device
    inv_freq = torch.from_numpy(_freqs(head_dim, float(base))).to(device)
    if position_ids is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        t = position_ids.to(torch.float32)
    freqs = t[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(x, cos, sin):
    """x: (b, s, h, d); cos/sin: (s, d) or (b, s, d). Computed in the
    promoted dtype of x and the fp32 tables, cast back to x's dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)
