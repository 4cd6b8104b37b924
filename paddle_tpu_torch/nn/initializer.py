"""Initializers (port of ``paddle_tpu/nn/initializer.py``: Normal, Constant).

Every random draw takes an explicit ``torch.Generator`` that lives on the
device of the tensor, so a 7B model is drawn on the card, in its final
dtype, with no host copy. JAX's and torch's generators give different
numbers from one seed; tests carry weights across with ``utils/convert.py``.
"""

import torch


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
