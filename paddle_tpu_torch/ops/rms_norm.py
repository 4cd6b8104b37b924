"""RMSNorm, plain PyTorch (port of ``paddle_tpu/ops/rms_norm.py:18``).

The JAX package runs RMSNorm through XLA (its Pallas kernel is
benchmark-only), so on this path it stays plain PyTorch too. The rounding
is copied: normalise in fp32, cast to the input dtype, then multiply by the
weight (a bf16 × bf16 product for a bf16 model).
"""

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y
