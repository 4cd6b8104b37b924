"""RMSNorm (port of ``paddle_tpu/nn/layers/norm.py``)."""

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import make_parameter


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, dtype=None, device=None):
        super().__init__()
        self.weight = make_parameter((hidden_size,), init.Constant(1.0),
                                     dtype, device)
        self.epsilon = epsilon

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
