"""Dtype aliases and default-dtype control (port of ``paddle_tpu/core/dtype.py``).

bfloat16 is first-class: the 7B model is built and served in it.
"""

import torch

float32 = torch.float32
float16 = torch.float16
bfloat16 = torch.bfloat16
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64

_STR2DTYPE = {
    "float32": float32,
    "fp32": float32,
    "float16": float16,
    "fp16": float16,
    "bfloat16": bfloat16,
    "bf16": bfloat16,
    "float64": float64,
    "fp64": float64,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "uint8": uint8,
    "bool": bool_,
    "complex64": complex64,
}

_default_dtype = [torch.float32]


def to_torch_dtype(dtype):
    """Normalize a user dtype spec (string / torch dtype) to a torch dtype."""
    if dtype is None:
        return get_default_dtype()
    if isinstance(dtype, str):
        try:
            return _STR2DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        return dtype
    raise ValueError(f"Unknown dtype: {dtype!r}")


def set_default_dtype(dtype):
    _default_dtype[0] = to_torch_dtype(dtype)


def get_default_dtype():
    return _default_dtype[0]


def is_floating(dtype):
    return to_torch_dtype(dtype).is_floating_point
