"""Linear, Embedding, Dropout and Identity (port of
``paddle_tpu/nn/layers/common.py``)."""

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer


def make_parameter(shape, initializer, dtype=None, device=None,
                   generator=None):
    """A parameter drawn directly on `device` in `dtype`."""
    value = initializer(shape, to_torch_dtype(dtype), resolve_device(device),
                        generator)
    return torch.nn.Parameter(value)


class Linear(Layer):
    """y = xW + b with W of shape (in_features, out_features), the
    reference layout (``paddle_tpu/nn/layers/common.py:17``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, dtype=None, device=None, generator=None):
        super().__init__()
        w_init = weight_attr if isinstance(weight_attr, init.Initializer) \
            else init.Normal(0.0, 0.02)
        self.weight = make_parameter((in_features, out_features), w_init,
                                     dtype, device, generator)
        if bias_attr is not False:
            b_init = bias_attr if isinstance(bias_attr, init.Initializer) \
                else init.Constant(0.0)
            self.bias = make_parameter((out_features,), b_init, dtype,
                                       device, generator)
        else:
            self.bias = None
        self.in_features, self.out_features = in_features, out_features

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 dtype=None, device=None, generator=None):
        super().__init__()
        w_init = weight_attr if isinstance(weight_attr, init.Initializer) \
            else init.Normal(0.0, 1.0)
        self.weight = make_parameter((num_embeddings, embedding_dim), w_init,
                                     dtype, device, generator)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(Layer):
    """``F.dropout`` with the layer's training flag (port of
    ``paddle_tpu/nn/layers/common.py:52-62``)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None,
                 rng_name="dropout"):
        super().__init__()
        self.p = p
        self.mode = mode
        self.rng_name = rng_name

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode,
                         rng_name=self.rng_name)


class Identity(Layer):
    def forward(self, x):
        return x
