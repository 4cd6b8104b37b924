"""MoE training throughput on one card (the port's twin of the JAX
package's ``examples/moe_bench.py``).

    python -m paddle_tpu_torch.moe_bench                     # cuda, fused
    python -m paddle_tpu_torch.moe_bench --dispatch dropless
    python -m paddle_tpu_torch.moe_bench --xplane_breakdown  # + kernel split
    python -m paddle_tpu_torch.moe_bench --device cpu        # the CPU shape

The reference's configuration and flags: a Mixtral-style model (top-2
GShard routing, ``num_heads = max(4, h // 64)``, ``num_kv_heads =
max(4, h // 128)``, vocab 32000) of ``--layers`` (12) layers of
``--experts`` (8) experts, h ``--hidden`` (1024), expert ffn ``--ffn``
(2816), B ``--batch`` (4), S ``--seq`` (1024), ``--steps`` (10), dispatch
``--dispatch`` (fused; scatter, sort, einsum, dropless; alltoall raises:
it needs an expert-parallel mesh, ROADMAP Queue A item 10), capacity
factor ``--capacity_factor`` (1.0). bf16 parameters, pure-bf16 AdamW
(``AdamW(1e-4, multi_precision=False)``), the same batch every step (ids
from ``numpy.random.RandomState(0)``, shape (B, S+1), x/y shifted). On the
CPU the reference's CPU shape: 2 layers, h 128, ffn 256, S 128, 2 steps,
vocab 512.

One warm-up step, then the timed steps under CUDA events (device) and the
wall clock; the loss is read back once, after the last. Prints one JSON
line shaped like the reference's record: tokens/s, MFU on the activated
basis (the top-k of E experts a token: n_params − L·E·3hf + L·k·3hf
activated parameters, 6·N_act + 12·L·h·S FLOPs a token, the reference's
:150-156) against the card's bf16 peak, the parameter counts, step time
and the final loss. Dropless reads its group sizes on the host once a
layer a forward (``host_reads_per_step``). ``--xplane_breakdown`` adds a
``torch.profiler`` split of one more step by kernel bucket
(``step_breakdown``).

``config``, ``build`` and ``train_step`` are what ``chip_smoke.py`` drives
DeepSeekMoE-16B through.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.bench import peak_rates
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from paddle_tpu_torch.nn.layers.moe import GroupedSwiGLUExperts
from paddle_tpu_torch.optimizer import AdamW

DISPATCH = ("scatter", "sort", "fused", "einsum", "alltoall", "dropless")

#: a step's device time by kernel bucket, matched on the kernel's name in
#: this order (the rest: elementwise and reductions)
BUCKETS = (
    ("attention (K1, K3, K4)", ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                                "flash_bwd_dkv_sm90")),
    ("matrix products (cuBLAS: experts and dense)",
     ("nvjet", "gemm", "xmma", "cutlass", "gemv")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("dispatch and combine (gathers, sorts, scans, index ops)",
     ("index", "gather", "scatter", "sort", "radix", "scan", "histogram",
      "nonzero", "cumsum")),
)


def config(layers=12, experts=8, hidden=1024, ffn=2816, seq=1024,
           capacity_factor=1.0, dispatch="fused", on_card=True):
    """The reference's MixtralConfig for these flags."""
    if dispatch not in DISPATCH:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    return MixtralConfig(
        vocab_size=32000 if on_card else 512, hidden_size=hidden,
        intermediate_size=ffn, num_layers=layers,
        num_heads=max(4, hidden // 64), num_kv_heads=max(4, hidden // 128),
        max_position_embeddings=max(2048, seq), num_experts=experts,
        top_k=2, capacity_factor=capacity_factor,
        moe_dispatch="scatter" if dispatch == "dropless" else dispatch,
        moe_dropless=dispatch == "dropless")


def build(cfg, batch, seq, device=None, dtype=torch.bfloat16, seed=0):
    """(model, optimizer, x, y): `cfg`'s model with random weights from
    `seed` in `dtype`, pure-low-precision AdamW(1e-4), and the reference's
    batch (ids from RandomState(0), shifted)."""
    dev = resolve_device(device)
    model = MixtralForCausalLM(cfg, dtype=dtype, device=dev, seed=seed)
    opt = AdamW(learning_rate=1e-4, multi_precision=False,
                parameters=model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq + 1))).to(dev)
    return model, opt, ids[:, :-1], ids[:, 1:]


def train_step(model, opt, x, y):
    """One step: forward, the loss (cross-entropy + the weighted aux),
    backward, AdamW. Returns the loss (a device tensor: no host sync)."""
    loss = model.loss(model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def activated_params(cfg, n_params):
    """Parameters a token runs through: all but the E − k routed experts it
    skips (the reference's accounting)."""
    expert = 3 * cfg.hidden_size * cfg.intermediate_size
    return n_params - cfg.num_layers * (cfg.num_experts - cfg.top_k) * expert


def flops_per_token(cfg, n_params, seq):
    """6·N_act + 12·L·h·S: the activated basis of the reference's MFU."""
    return (6 * activated_params(cfg, n_params)
            + 12 * cfg.num_layers * cfg.hidden_size * seq)


def bucket(name):
    low = name.lower()
    for fam, keys in BUCKETS:
        if any(k.lower() in low for k in keys):
            return fam
    return "elementwise and reductions"


def step_breakdown(step):
    """One call of `step` (after one untraced) under torch.profiler: its
    device time by ``BUCKETS``, the device-busy time (the union of the
    kernels' intervals), the wall time and the idle share (1 − busy /
    wall). None where the trace holds no device activity (not measured)."""
    step()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    by = {}
    for name, a, b in evs:
        fam = bucket(name)
        by[fam] = by.get(fam, 0.0) + (b - a) / 1e3
    busy, start, end = 0.0, None, None
    for _, a, b in sorted(evs, key=lambda e: e[1]):
        if end is None or a > end:
            busy += 0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy = (busy + end - start) / 1e3
    return {"device_ms_by_bucket": dict(sorted(by.items(),
                                               key=lambda kv: -kv[1])),
            "busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms, "kernels": len(evs)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--ffn", type=int, default=2816)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dispatch", default="fused", choices=DISPATCH)
    ap.add_argument("--xplane_breakdown", action="store_true",
                    help="add one traced step's device time by kernel "
                    "bucket (dispatch / products / optimizer / attention)")
    ap.add_argument("--capacity_factor", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    on_cuda = dev.type == "cuda"
    if not on_cuda:
        a.layers, a.hidden, a.ffn, a.seq, a.steps = 2, 128, 256, 128, 2
    cfg = config(a.layers, a.experts, a.hidden, a.ffn, a.seq,
                 a.capacity_factor, a.dispatch, on_card=on_cuda)
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    model, opt, x, y = build(cfg, a.batch, a.seq, dev)
    n_params = model.num_params()
    step = lambda: train_step(model, opt, x, y)

    float(step())                                    # warm-up, host sync
    reads0 = GroupedSwiGLUExperts.host_reads
    if on_cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
        ev[0].record()
    t0 = time.perf_counter()
    losses = [step() for _ in range(a.steps)]
    if on_cuda:
        ev[1].record()
    final_loss = float(losses[-1])                   # full host sync
    wall = time.perf_counter() - t0
    reads = (GroupedSwiGLUExperts.host_reads - reads0) / a.steps

    fpt = flops_per_token(cfg, n_params, a.seq)
    rec = {"metric": f"mixtral-{a.layers}L-{a.experts}e train "
                     "tokens/s/chip",
           "unit": "tokens/s",
           "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
           "dispatch": a.dispatch, "mfu_basis": "activated",
           "params": n_params,
           "params_activated": activated_params(cfg, n_params),
           "batch": a.batch, "seq": a.seq, "steps": a.steps,
           "capacity_factor": a.capacity_factor,
           "wall_step_time_ms": 1e3 * wall / a.steps,
           "host_reads_per_step": reads, "final_loss": final_loss}
    if on_cuda:
        dt = ev[0].elapsed_time(ev[1]) / 1e3
        tok_s = a.batch * a.seq * a.steps / dt
        rec.update(value=tok_s, step_time_ms=1e3 * dt / a.steps,
                   timing="device(cuda events)",
                   mfu=tok_s * fpt / peak_rates(rec["device"])[1],
                   memory={"max_memory_allocated":
                           torch.cuda.max_memory_allocated(dev)})
        if a.xplane_breakdown:
            rec["breakdown_ms_per_step"] = step_breakdown(step)
    else:
        rec.update(value=a.batch * a.seq * a.steps / wall, step_time_ms=None,
                   timing="wall (cpu)", mfu=None, memory=None)
        if a.xplane_breakdown:
            rec["breakdown_ms_per_step"] = None     # no device: not measured
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
