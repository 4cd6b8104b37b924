"""LayerNorm, RMSNorm and GroupNorm (port of ``paddle_tpu/nn/layers/norm.py``)."""

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


class GroupNorm(Layer):
    """``weight`` (ones) and ``bias`` (zeros) over `num_channels`, unless
    `weight_attr` / `bias_attr` is False (port of the reference's
    ``GroupNorm``, ``paddle_tpu/nn/layers/norm.py:82``)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 dtype=None, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = (make_parameter((num_channels,), init.Constant(1.0),
                                      dtype, device)
                       if weight_attr is not False else None)
        self.bias = (make_parameter((num_channels,), init.Constant(0.0),
                                    dtype, device)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)
