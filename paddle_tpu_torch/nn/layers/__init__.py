from paddle_tpu_torch.nn.layers.common import Dropout, Embedding, Linear  # noqa: F401
from paddle_tpu_torch.nn.layers.norm import LayerNorm, RMSNorm  # noqa: F401
