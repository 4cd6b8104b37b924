from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Identity, Linear  # noqa: F401
from paddle_tpu_torch.nn.layers.conv import Conv2D  # noqa: F401
from paddle_tpu_torch.nn.layers.norm import GroupNorm, LayerNorm, RMSNorm  # noqa: F401
