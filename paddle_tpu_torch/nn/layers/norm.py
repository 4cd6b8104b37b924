"""LayerNorm and RMSNorm (port of ``paddle_tpu/nn/layers/norm.py``)."""

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


class LayerNorm(Layer):
    """``weight`` (ones) and ``bias`` (zeros) over ``normalized_shape``."""

    def __init__(self, normalized_shape, epsilon=1e-5, dtype=None,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = make_parameter(self.normalized_shape,
                                     init.Constant(1.0), dtype, device)
        self.bias = make_parameter(self.normalized_shape, init.Constant(0.0),
                                   dtype, device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
