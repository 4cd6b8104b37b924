"""Module system (the subset of ``paddle_tpu.nn`` the Llama serving path uses)."""

from torch.nn import ModuleList as LayerList  # noqa: F401

from paddle_tpu_torch.nn import functional, initializer  # noqa: F401
from paddle_tpu_torch.nn.layer import Layer  # noqa: F401
from paddle_tpu_torch.nn.layers import Embedding, Linear, RMSNorm  # noqa: F401
