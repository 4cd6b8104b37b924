"""RMSNorm (port of ``paddle_tpu/ops/rms_norm.py``).

``rms_norm`` is the plain PyTorch version, and the default path, as the
JAX package's ``rms_norm`` is its XLA path: its Pallas kernel
``_rms_norm_pallas`` is benchmark-only (``rms_norm.py:27-31``). The rounding
is copied: normalise in fp32, cast to the input dtype, then multiply by the
weight (a bf16 × bf16 product for a bf16 model).

``rms_norm_cuda`` wraps K8, the hand-written counterpart of
``_rms_norm_pallas`` (``csrc/rms_norm.cu``): one warp per row, 16-byte
loads, an fp32 sum of squares; rows up to 4096 bf16 (2048 fp32) elements
are read into registers once and scaled from there, wider rows take a
two-pass kernel (the C entry picks by width). Like the Pallas kernel it is
off the default path; ``chip_smoke.py`` checks and times it. Given CPU
tensors it runs the plain version; given CUDA tensors it launches the
kernel or raises.
"""

import ctypes

import torch

from paddle_tpu_torch.ops import _build


def rms_norm(x, weight=None, epsilon=1e-6):
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y


def _lib():
    lib = _build.library("rms_norm")
    fn = lib.rms_norm_rows
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def rms_norm_cuda(x, weight=None, epsilon=1e-6):
    """K8 over the rows of x (..., d), bf16 or fp32, with an optional weight
    (d,) of x's dtype; the plain version on CPU tensors. On CUDA tensors:
    contiguous, 16-byte aligned, d a multiple of 8 (bf16) or 4 (fp32); it
    raises on anything else."""
    if x.device.type == "cpu":
        return rms_norm(x, weight, epsilon)
    what = "rms_norm_cuda"
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: x is {x.dtype}, expected bf16 or fp32")
    d = x.shape[-1]
    per = 16 // x.element_size()
    ts = [x] if weight is None else [x, weight]
    if weight is not None and (weight.dtype != x.dtype
                               or tuple(weight.shape) != (d,)):
        raise ValueError(f"{what}: weight {weight.dtype} "
                         f"{tuple(weight.shape)}, expected {x.dtype} ({d},)")
    if d % per or any(not t.is_contiguous() or t.data_ptr() % 16
                      or t.device != x.device or t.device.type != "cuda"
                      for t in ts):
        raise ValueError(f"{what}: needs contiguous, 16-byte aligned CUDA "
                         f"tensors on one device and d % {per} == 0 "
                         f"(d = {d})")
    y = torch.empty_like(x)
    n = x.numel() // d
    if n == 0:
        return y
    p = _build.ptr
    err = _lib().rms_norm_rows(
        p(x), ctypes.c_void_p(0) if weight is None else p(weight), p(y), n, d,
        int(x.dtype == torch.float32), float(epsilon), _build.stream_of(x))
    rms_norm_cuda.launches += 1
    _build.check(err, "rms_norm_rows")
    return y


rms_norm_cuda.launches = 0
