"""Ops: RMSNorm, RoPE, attention and the fused decode step, each CUDA kernel
beside its plain PyTorch version; the shared-memory probe; and the tied
unembedding."""

import torch


def tied_unembed(x, embed_w):
    """Unembedding against a TIED embedding table (vocab, h): ``x @
    embed_wᵀ`` over a transposed view, never a transposed copy (port of
    ``paddle_tpu/ops/__init__.py:36``). A plain large product outside any
    kernel, so ``torch.matmul``."""
    return torch.matmul(x, embed_w.t())
