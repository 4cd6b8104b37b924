"""Carry weights across: a JAX-package state dict (as numpy) → torch tensors.

``paddle_tpu``'s ``state_dict(include_buffers=False)`` keys are the port's
keys, and its layouts are the port's layouts (Linear weights (in, out)), so
the conversion is per tensor. bf16 arrays arrive as ``ml_dtypes.bfloat16``;
they move bit for bit (viewed as uint16, then as ``torch.bfloat16``), never
rounded through float32.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def array_to_tensor(a, device=None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device) if device is not None else t


def jax_state_to_torch(state: Mapping[str, np.ndarray],
                       device=None) -> Dict[str, torch.Tensor]:
    """{key: numpy array} → {key: tensor} with the same keys, on `device`."""
    return {k: array_to_tensor(v, device) for k, v in state.items()}


def load_jax_state(model, state: Mapping[str, np.ndarray]):
    """Copy a JAX-package state (numpy arrays) into `model` in place."""
    dev = model.device
    return model.set_state_dict(jax_state_to_torch(state, dev))
