"""SD-1.5 UNet denoise-step throughput on one card (the port's twin of the
JAX package's ``examples/unet_bench.py``).

    python -m paddle_tpu_torch.unet_bench                   # cuda, b 2
    python -m paddle_tpu_torch.unet_bench --batch 4 --steps 20
    python -m paddle_tpu_torch.unet_bench --device cpu      # the CPU shape

The reference's sampling hot loop: ``UNetConfig.sd15()`` in bf16 (random
weights from seed 0), latents (b, 4, 64, 64), a text context (b, 77, 768)
and timesteps, all from ``numpy.random.RandomState(0)`` in the reference's
order, and ``--steps`` (10) forwards with each ε fed back as the next input
(``examples/unet_bench.py:60-112``). On the CPU the reference's CPU shape:
``UNetConfig.tiny()``, 16×16 latents, an 8-token context, b 1, 2 steps.

Two warm-up steps, then the timed steps under CUDA events (device) and the
wall clock. Prints one JSON line shaped like the reference's record: steps
a second, images a second, ms a denoise step, peak memory, and MFU over an
analytic count of one forward's FLOPs (``forward_flops``: the convolutions,
the linear products and the attention's two products at the model's own
head dims 40 / 80 / 160, not the padded 64 / 128 / 256 K1 computes) against
the card's bf16 peak. Elementwise work, norms and the pad are not counted.
``--train`` (the DDPM step) raises: it needs K3/K4 at head dim 256, the
next slice (ROADMAP Queue A step 11, Queue B rows 2-3).

``build``, ``inputs``, ``denoise`` and ``forward_flops`` are what
``chip_smoke.py`` drives the UNet through.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.bench import peak_rates
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.unet import (
    UNetConfig,
    UNetModel,
    _CrossAttention,
)
from paddle_tpu_torch.nn import Conv2D, Linear

WARMUP = 2


def build(cfg, device=None, dtype=torch.bfloat16, seed=0):
    """The UNet with random weights drawn from `seed` on `device`."""
    model = UNetModel(cfg, dtype=dtype, device=resolve_device(device),
                      seed=seed)
    model.eval()
    return model


def inputs(cfg, batch, res, ctx_len, device, dtype=torch.bfloat16, seed=0):
    """(x0, t, ctx) as the reference draws them: latents, timesteps in
    [0, 1000), the text context, from RandomState(seed) in that order."""
    rng = np.random.RandomState(seed)
    x0 = rng.standard_normal((batch, cfg.in_channels, res, res))
    t = rng.randint(0, 1000, (batch,))
    ctx = rng.standard_normal((batch, ctx_len, cfg.context_dim))
    put = lambda a, dt: torch.from_numpy(a).to(device=device, dtype=dt)
    return put(x0, dtype), put(t, torch.int64), put(ctx, dtype)


@torch.no_grad()
def denoise(model, x, t, ctx, steps):
    """`steps` forwards, each ε fed back as the next x (the reference's
    scan); returns the last ε."""
    for _ in range(steps):
        x = model(x, t, ctx).to(x.dtype)
    return x


@torch.no_grad()
def forward_flops(model, x, t, ctx):
    """FLOPs of one forward, counted from the shapes each layer sees (one
    forward under hooks): {"conv", "linear", "attention", "total"}. A
    convolution 2·(output elements)·(in / groups)·kh·kw, a linear
    2·rows·in·out, an attention call 4·b·heads·sq·sk·head_dim at the
    model's head dim."""
    count = {"conv": 0, "linear": 0, "attention": 0}

    def conv(m, args, out):
        w = m.weight
        count["conv"] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    def linear(m, args, out):
        count["linear"] += 2 * out.numel() * m.in_features

    def attention(m, args, out):
        q, ctx_ = args[0], args[1] if len(args) > 1 else None
        b, sq, _ = q.shape
        sk = sq if ctx_ is None else ctx_.shape[1]
        count["attention"] += 4 * b * m.num_heads * sq * sk * m.head_dim

    hooks = []
    for m in model.modules():
        if isinstance(m, Conv2D):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, _CrossAttention):
            hooks.append(m.register_forward_hook(attention))
    try:
        model(x, t, ctx)
    finally:
        for h in hooks:
            h.remove()
    count["total"] = sum(count.values())
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--train", action="store_true",
                    help="a DDPM training step (not ported yet: raises)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    if a.train:
        raise NotImplementedError(
            "unet_bench --train: the DDPM training step needs ddpm_loss and "
            "K3/K4 at head dim 256, the next slice (ROADMAP Queue A step 11, "
            "Queue B rows 2-3)")
    dev = resolve_device(a.device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        cfg, res, ctx_len = UNetConfig.sd15(), 64, 77
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        cfg, res, ctx_len = UNetConfig.tiny(), 16, 8
        a.batch, a.steps = 1, 2
    model = build(cfg, dev)
    x0, t, ctx = inputs(cfg, a.batch, res, ctx_len, dev)
    flops = forward_flops(model, x0, t, ctx)
    float(denoise(model, x0, t, ctx, WARMUP).float().sum())   # host sync
    if on_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    eps = denoise(model, x0, t, ctx, a.steps)
    if on_cuda:
        ev[1].record()
    finite = bool(torch.isfinite(eps.float()).all())          # host sync
    wall = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    rec = {"metric": f"sd15-unet denoise steps/s (batch={a.batch})"
                     if on_cuda else
                     f"unet-tiny denoise steps/s (batch={a.batch})",
           "unit": "steps/s", "device": kind,
           "params": model.num_params(), "batch": a.batch, "res": res,
           "context_len": ctx_len, "steps": a.steps,
           "wall_step_time_ms": 1e3 * wall / a.steps,
           "flops_per_step": flops, "eps_finite": finite,
           "mfu_basis": "analytic: convolutions, linears, attention at the "
                        "model's head dims (forward_flops)"}
    if on_cuda:
        step_s = ev[0].elapsed_time(ev[1]) / 1e3 / a.steps
        rec.update(value=1.0 / step_s, step_time_ms=1e3 * step_s,
                   images_per_sec=a.batch / step_s,
                   timing="device(cuda events)",
                   mfu=flops["total"] / step_s / peak_rates(kind)[1],
                   memory={"max_memory_allocated":
                           torch.cuda.max_memory_allocated(dev)})
    else:
        rec.update(value=a.steps / wall, step_time_ms=None,
                   images_per_sec=a.batch * a.steps / wall,
                   timing="wall (cpu)", mfu=None, memory=None)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
