"""Where the time of a GPT-2 345M train step goes, per CUDA kernel.

    PYTHONPATH=. python3 examples/torch_train_profile.py

Builds the bench twin's configuration (paddle_tpu_torch.bench: GPT-2 345M,
bf16, AdamW 1e-4, B=8, S=1024, random weights from seed 0), warms up, times
STEPS (3) steps with CUDA events and the wall clock, then traces as many
steps with torch.profiler and prints one JSON line: device time per step by
kernel family (the flash-attention kernels K1, K3, K4 each on their own;
matrix products; the optimizer's multi-tensor kernels; the rest), the
share of device time in K1+K3+K4, the device-busy time per step and the
idle share (1 − busy / wall).

Needs a CUDA GPU; imports nothing of jax or paddle_tpu.
"""

import json
import subprocess
import time

import torch

from paddle_tpu_torch import bench
from paddle_tpu_torch.ops import _build

FAMILIES = (("K1 flash_attention_fwd", ("flash_fwd_kernel",)),
            ("K3 flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
            ("K4 flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
            ("matrix products (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                          "gemv")),
            ("optimizer (multi-tensor)", ("multi_tensor_apply",)))
STEPS = 3


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    if "copy" in low:
        return "copies and dtype casts"
    return "other (elementwise, reductions)"


def device_ms(prof):
    """Device time (ms) of every CUDA kernel in a trace, by kernel name."""
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        if dt:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dt / 1e3
    return per_kernel


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg, b, s, _ = bench.config()
    model, opt, x, y = bench.build(cfg, b, s, "cuda")
    bench.run_steps(model, opt, x, y, 3).tolist()          # warm
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    bench.run_steps(model, opt, x, y, STEPS)
    e1.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    step_ms = e0.elapsed_time(e1) / STEPS
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        bench.run_steps(model, opt, x, y, STEPS)
        torch.cuda.synchronize()
    per_kernel = {k: v / STEPS for k, v in device_ms(prof).items()}
    busy = sum(per_kernel.values())
    by_family = {}
    for k, v in per_kernel.items():
        by_family[family(k)] = by_family.get(family(k), 0.0) + v
    attn = sum(v for f, v in by_family.items() if f.startswith("K"))
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12])
    print(json.dumps({
        "card": card, "model": "gpt2_medium", "batch": b, "seq": s,
        "step_ms_events": step_ms, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1 - busy / wall_ms if busy else None,
        "device_ms_per_step_by_family": by_family,
        "flash_attention_share_of_busy": attn / busy if busy else None,
        "top_kernels_ms_per_step": top}))


if __name__ == "__main__":
    main()
