"""Conv2D (port of ``paddle_tpu/nn/layers/conv.py:8``)."""

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import make_parameter


class Conv2D(Layer):
    """``weight`` (out_channels, in_channels / groups, kh, kw), drawn by
    ``KaimingUniform(fan_in = in_channels / groups · kh · kw)`` unless
    `weight_attr` is an initializer, and ``bias`` (out_channels,) of
    zeros unless `bias_attr` is False: the reference's names, layout and
    defaults, so a state dict moves between the two unchanged."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", dtype=None, device=None,
                 generator=None):
        super().__init__()
        k = F._pair(kernel_size)
        fan_in = in_channels // groups * k[0] * k[1]
        w_init = weight_attr if isinstance(weight_attr, init.Initializer) \
            else init.KaimingUniform(fan_in=fan_in)
        self.weight = make_parameter(
            (out_channels, in_channels // groups, k[0], k[1]), w_init, dtype,
            device, generator)
        if bias_attr is not False:
            self.bias = make_parameter((out_channels,), init.Constant(0.0),
                                       dtype, device, generator)
        else:
            self.bias = None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
