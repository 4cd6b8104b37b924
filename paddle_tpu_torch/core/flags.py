"""Global flag registry — env-overridable runtime knobs.

Port of ``paddle_tpu/core/flags.py`` holding only the flags this package
reads. The kernel dispatch flags of the JAX package (``FLAGS_pallas_*``,
``FLAGS_use_pallas_kernels``) have no counterpart: here the device of the
tensors decides — a CUDA tensor launches the hand-written kernel or raises,
a CPU tensor takes the plain PyTorch version.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _parse_bool(s):
    return str(s).lower() in ("1", "true", "yes", "on")


def define_flag(name, default, help="", parser=None):
    if parser is None:
        if isinstance(default, bool):
            parser = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
    value = default
    env = os.environ.get(name)
    if env is not None:
        value = parser(env)
    _REGISTRY[name] = _Flag(name, default, parser, help, value)
    return value


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"Unknown flag {k!r}. Known: {sorted(_REGISTRY)}")
        f = _REGISTRY[k]
        f.value = f.parser(v) if isinstance(v, str) else v


def get_flags(flags=None):
    if flags is None:
        return {k: f.value for k, f in _REGISTRY.items()}
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[k].value for k in flags}


def flag(name):
    return _REGISTRY[name].value


define_flag("FLAGS_fused_decode", True,
            "Use the fused decode-step path (fused_multi_transformer analog) "
            "in generate()")
