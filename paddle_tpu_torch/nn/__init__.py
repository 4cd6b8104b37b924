"""Module system (the subset of ``paddle_tpu.nn`` that Llama serving, GPT
pretraining and the SD UNet use)."""

from torch.nn import ModuleList as LayerList  # noqa: F401

from paddle_tpu_torch.nn import functional, initializer  # noqa: F401
from paddle_tpu_torch.nn.layer import Layer, functional_call  # noqa: F401
from paddle_tpu_torch.nn.layers import (  # noqa: F401
    Conv2D,
    Dropout,
    Embedding,
    GroupNorm,
    Identity,
    LayerNorm,
    Linear,
    RMSNorm,
)
