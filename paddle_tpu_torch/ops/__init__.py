"""Ops: RMSNorm, RoPE, attention and the fused decode step, each CUDA kernel
beside its plain PyTorch version; the shared-memory probe; the tied
unembedding; and ``flash_attn``, the reference's ``ops.flash_attn``
(``flash_attention.flash_attention``)."""

import torch


def tied_unembed(x, embed_w):
    """Unembedding against a TIED embedding table (vocab, h): ``x @
    embed_wᵀ`` over a transposed view, never a transposed copy (port of
    ``paddle_tpu/ops/__init__.py:36``). A plain large product outside any
    kernel, so ``torch.matmul``."""
    return torch.matmul(x, embed_w.t())


from paddle_tpu_torch.ops.flash_attention import flash_attention as flash_attn  # noqa: F401,E402
