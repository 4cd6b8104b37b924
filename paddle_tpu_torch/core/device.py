"""Device control (port of ``paddle_tpu/core/device.py``).

The default device is ``cuda``. An entry point called without a device
resolves it here: on a machine without a GPU that raises instead of quietly
running on the CPU. Pass ``device="cpu"`` (or CPU tensors) to run the plain
PyTorch versions, as the tests do.
"""

import torch

_current = ["cuda"]


def set_device(device: str):
    """Accepts 'cuda', 'cuda:0', 'gpu', 'cpu'. Returns the torch.device."""
    dev = _canon(device)
    _current[0] = str(dev)
    return dev


def _canon(device) -> torch.device:
    if isinstance(device, torch.device):
        return device
    name = str(device)
    if name.split(":")[0] == "gpu":
        name = "cuda" + name[3:]
    return torch.device(name)


def get_device() -> str:
    return _current[0]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else the
    default. A CUDA device on a machine without one raises."""
    dev = _canon(device if device is not None else _current[0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default is cuda) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev

