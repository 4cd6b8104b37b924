"""Initializers (port of ``paddle_tpu/nn/initializer.py``: Normal, Constant,
XavierNormal, KaimingUniform).

Every random draw takes an explicit ``torch.Generator`` that lives on the
device of the tensor, so a 7B model is drawn on the card, in its final
dtype, with no host copy. JAX's and torch's generators give different
numbers from one seed; tests carry weights across with ``utils/convert.py``.
"""

import math

import torch


def _fan_in_out(shape):
    """(fan_in, fan_out) as the reference counts them (:17-27): a Linear
    weight is (in, out), a conv kernel (out_ch, in_ch, *spatial)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype, device, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        return t.normal_(self.mean, self.std, generator=generator)


class XavierNormal(Initializer):
    """N(0, gain·√(2 / (fan_in + fan_out))): the reference's default for a
    Linear weight."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device, generator=None):
        fan_in, fan_out = _fan_in_out(shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    """U(−limit, limit), limit = gain·√(3 / fan_in), gain =
    √(2 / (1 + negative_slope²)): the reference's default for a Conv2D
    kernel (fan_in = in_ch / groups · kh · kw)."""

    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype, device, generator=None):
        fan_in = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fan_in)
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        return t.uniform_(-limit, limit, generator=generator)
