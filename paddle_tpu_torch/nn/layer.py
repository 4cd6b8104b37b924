"""Layer — a minimal ``paddle.nn.Layer`` on ``torch.nn.Module``.

Port of ``paddle_tpu/nn/layer.py``, reduced to what serving and pretraining
use.
Parameter names come from torch's attribute registration, so a model built
with the same attribute names as the JAX package has the same state keys
(``model.layers.0.self_attn.q_proj.weight``); ``state_dict`` and
``set_state_dict`` speak those keys, and ``.bfloat16()`` is torch's own.
Sublayer lists are ``torch.nn.ModuleList`` (the ``LayerList`` analog).
"""

from typing import Dict

import numpy as np
import torch


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
