"""Build the hand-written CUDA kernels from the package's sources at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The library name carries a hash of the source
and of the shared headers (``csrc/*.cuh``), so an edited source or header
rebuilds and an unchanged one is reused. The build
directory is ``paddle_tpu_torch/_kernels_build/`` (listed in .gitignore).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0, so a
refused launch (too many threads, too much shared memory) is never silent.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_kernels_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs = {}
build_seconds = {}   # source stem -> nvcc wall seconds, for sources built here


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of paddle_tpu_torch are built at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):   # headers a source may include
        h.update(hdr.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(verbose: bool = False):
    """Compile every csrc/*.cu not built yet, in parallel. Returns
    {name: ctypes.CDLL}. Raises with the compiler's output on failure."""
    with _lock:
        srcs = sorted(CSRC.glob("*.cu"))
        todo = [s for s in srcs if s.stem not in _libs]
        if not todo:
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs, t0 = [], time.perf_counter()
        for src in todo:
            out = _target(src)
            if out.exists():
                procs.append((src, out, None))
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-lineinfo", "-o", str(tmp),
                   str(src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, out, (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))))
        # drain every compiler's output at once (a full pipe would stall
        # it) and note when each finishes
        logs = {}

        def drain(src, p):
            logs[src.stem] = p.communicate()[0]
            build_seconds[src.stem] = time.perf_counter() - t0

        waiters = [threading.Thread(target=drain, args=(src, job[1]))
                   for src, _, job in procs if job is not None]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        errors = []
        for src, out, job in procs:
            if job is None:
                continue
            tmp, p = job
            log = logs[src.stem]
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
                continue
            if verbose and log:
                print(log)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for src, out, _ in procs:
            _libs[src.stem] = ctypes.CDLL(str(out))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (building everything first)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
