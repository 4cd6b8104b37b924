"""Shared-memory probe (K9), the Hopper form of ``paddle_tpu/ops/
vmem_probe.py`` (``_fits`` :32, ``probe_usable_vmem_mib`` :63).

The reference bisects the largest VMEM scratch that Mosaic compiles and
runs, because a TPU runtime exposes no VMEM attribute. A CUDA device
exposes its budget: the shared memory one block may opt in to
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``; torch's
``shared_memory_per_block_optin``; 232,448 bytes on an H100). The probe
reads it, makes one launch of ``csrc/smem_probe.cu``'s kernel with that
much dynamic shared memory (it writes the first and last rows and reads
them back), and checks that a launch one 1 KB step above is refused. The
result is cached per device name. It raises on a non-CUDA device, as the
reference raises off a TPU, and on any failure: there is no table to fall
back to. ``ops/fused_decode.dynamic_smem_bytes`` gives the requests of the
kernels that opt in, to hold against it.
"""

import ctypes
import functools

import torch

from paddle_tpu_torch.ops import _build

STEP = 1024     # the probe's granularity, as the reference's 4 MiB step


def _lib():
    lib = _build.library("smem_probe")
    fn = lib.smem_probe
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        lib.smem_optin_bytes.argtypes = [ctypes.c_int]
        lib.smem_optin_bytes.restype = ctypes.c_int
    return lib


def smem_probe_cuda(nbytes: int, device) -> bool:
    """One launch of the probe kernel with `nbytes` of dynamic shared memory
    on CUDA `device`: True when it was accepted and ran (both rows read
    back), False when the launch was refused."""
    out = torch.zeros((2, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        err = _lib().smem_probe(_build.ptr(out), int(nbytes),
                                _build.stream_of(out))
    if err != 0:
        return False
    smem_probe_cuda.launches += 1
    rows = float(nbytes // 16)
    got = out.cpu().tolist()
    if got != [[1.0, 2.0, 3.0, rows], [5.0, 6.0, 7.0, rows]]:
        raise RuntimeError(f"smem probe at {nbytes} B launched but read back "
                           f"{got}")
    return True


smem_probe_cuda.launches = 0


def _cuda_device(device):
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the shared-memory probe needs a CUDA device, got {dev} "
            f"(CUDA available: {torch.cuda.is_available()})")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _probe(name: str, index: int) -> int:
    del name                    # the cache key: one probe per device kind
    optin = _lib().smem_optin_bytes(index)
    if optin <= 0:
        raise RuntimeError(f"cuda:{index}: no opt-in shared memory size")
    dev = torch.device("cuda", index)
    if not smem_probe_cuda(optin, dev):
        raise RuntimeError(f"cuda:{index}: a launch with the opt-in "
                           f"{optin} B of shared memory was refused")
    if smem_probe_cuda(optin + STEP, dev):
        raise RuntimeError(f"cuda:{index}: a launch with {optin + STEP} B, "
                           f"above the opt-in {optin} B, was accepted")
    return optin


def probe_usable_smem_bytes(device=None) -> int:
    """The dynamic shared memory one block can use on CUDA `device` (the
    current one by default): the opt-in size, checked by one launch at it
    and a refused one a step above. Cached per device name; raises on a
    non-CUDA device or when the check fails."""
    dev = _cuda_device(device)
    return _probe(torch.cuda.get_device_name(dev.index), dev.index)
