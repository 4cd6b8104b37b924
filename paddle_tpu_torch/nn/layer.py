"""Layer — a minimal ``paddle.nn.Layer`` on ``torch.nn.Module``.

Port of ``paddle_tpu/nn/layer.py``, reduced to what serving and pretraining
use.
Parameter names come from torch's attribute registration, so a model built
with the same attribute names as the JAX package has the same state keys
(``model.layers.0.self_attn.q_proj.weight``); ``state_dict`` and
``set_state_dict`` speak those keys, and ``.bfloat16()`` is torch's own.
Sublayer lists are ``torch.nn.ModuleList`` (the ``LayerList`` analog).
``functional_call`` is the reference's functional bridge (``:369``): a call
as a function of a state dict, on ``torch.func.functional_call``.
"""

from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import rng as rng_mod


class Layer(torch.nn.Module):
    """Base class of the port's modules."""

    def state_dict(self, include_buffers=True, **kwargs) -> Dict[str, torch.Tensor]:
        """Flat {qualified_name: tensor}. ``include_buffers=False`` returns
        the parameters only — the JAX package's inference state."""
        if kwargs:
            return super().state_dict(**kwargs)
        out = {n: p.detach() for n, p in self.named_parameters()}
        if include_buffers:
            out.update({n: b for n, b in self.named_buffers()
                        if b is not None})
        return out

    def trainable_state(self) -> Dict[str, torch.Tensor]:
        """{qualified_name: parameter} of the parameters that require grad
        (the tensors themselves, which an optimizer updates in place)."""
        return {n: p for n, p in self.named_parameters() if p.requires_grad}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def set_state_dict(self, state: Dict, strict: bool = True):
        """Copy `state` (torch tensors or numpy arrays, JAX key names) into
        the parameters and buffers in place, keeping their device and
        dtype. Returns (missing, unexpected) key lists."""
        own = dict(self.named_parameters())
        own.update(dict(self.named_buffers()))
        missing = [k for k in own if k not in state]
        unexpected = [k for k in state if k not in own]
        if strict and (missing or unexpected):
            raise KeyError(f"set_state_dict: missing {missing}, "
                           f"unexpected {unexpected}")
        with torch.no_grad():
            for k, v in state.items():
                if k not in own:
                    continue
                t = own[k]
                if isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(v))
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"set_state_dict: {k} has shape "
                                     f"{tuple(v.shape)}, expected "
                                     f"{tuple(t.shape)}")
                t.copy_(v.to(device=t.device, dtype=t.dtype))
        return missing, unexpected

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def functional_call(layer: torch.nn.Module, state: Dict[str, torch.Tensor],
                    *args, rngs: Optional[Dict[str, torch.Tensor]] = None,
                    mutable: bool = False, method: Optional[str] = None,
                    **kwargs):
    """Run ``layer(*args, **kwargs)`` with `state`'s tensors in place of the
    parameters and buffers of the same names (port of
    ``paddle_tpu/nn/layer.py:369``), on ``torch.func.functional_call``: the
    output is a function of `state`, and a gradient flows to its tensors;
    the layer's own tensors are back in place afterwards. A key of `state`
    that names no parameter or buffer raises KeyError, as in the reference.

    ``rngs`` binds named rng streams for the call (``core.rng.rng_guard``:
    ``{"dropout": key}``). ``method`` calls the named method in place of
    ``forward`` (a model's ``train_loss``, say). With ``mutable=True``
    returns ``(out, new_buffers)``: every buffer's value at the end of the
    call (a buffer the call reassigned, or `state`'s)."""
    own = {n for n, _ in layer.named_parameters()}
    own.update(n for n, _ in layer.named_buffers())
    for k in state:
        if k not in own:
            raise KeyError(f"state key {k!r} not found in "
                           f"{type(layer).__name__}")
    with rng_mod.rng_guard(rngs or {}):
        return torch.func.functional_call(
            _Bound(layer, method, mutable),
            {f"layer.{k}": v for k, v in state.items()}, args, kwargs)


class _Bound(torch.nn.Module):
    """`layer` as the submodule "layer" of a module whose forward calls its
    `method` (forward by default) and, with `mutable`, returns the buffers'
    values at the end of the call beside the output: what
    torch.func.functional_call, which runs a module's forward, calls."""

    def __init__(self, layer, method, mutable):
        super().__init__()
        self.layer, self.method, self.mutable = layer, method, mutable

    def forward(self, *args, **kwargs):
        layer = self.layer
        fn = layer if self.method is None else getattr(layer, self.method)
        out = fn(*args, **kwargs)
        if self.mutable:
            return out, {n: b for n, b in layer.named_buffers()
                         if b is not None}
        return out
