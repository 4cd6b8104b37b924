from paddle_tpu_torch.nn.layers.common import Embedding, Linear  # noqa: F401
from paddle_tpu_torch.nn.layers.norm import RMSNorm  # noqa: F401
