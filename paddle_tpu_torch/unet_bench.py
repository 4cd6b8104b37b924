"""SD-1.5 UNet denoise-step and training-step throughput on one card (the
port's twin of the JAX package's ``examples/unet_bench.py``).

    python -m paddle_tpu_torch.unet_bench                   # cuda, b 2
    python -m paddle_tpu_torch.unet_bench --batch 4 --steps 20
    python -m paddle_tpu_torch.unet_bench --train           # DDPM steps
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

``--train`` runs the reference's DDPM step (``examples/unet_bench.py:
81-108``): after ``inputs``' draws, from the same RandomState, the noise
and ᾱ ~ U(0.2, 0.98) per image (``train_inputs``), x_t = √ᾱ·x0 +
√(1 − ᾱ)·noise in fp32 cast to bf16, and each step the fp32 ε-MSE
mean((ε(x_t) − noise)²), its backward (every attention backward on K3/K4
on the card, head dim 160 on their d-256 kernels) and pure-bf16
``AdamW(1e-4, multi_precision=False)`` (``train_step``). Its line adds the
first and last loss; MFU counts 3 × ``forward_flops`` a step (forward +
backward ≈ 3 forwards, the reference's basis, ``mfu_basis``).

``build``, ``inputs``, ``denoise``, ``forward_flops``, ``optimizer``,
``train_inputs`` and ``train_step`` are what ``chip_smoke.py`` drives the
UNet through.
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
from paddle_tpu_torch.optimizer import AdamW

WARMUP = 2


def build(cfg, device=None, dtype=torch.bfloat16, seed=0):
    """The UNet with random weights drawn from `seed` on `device`."""
    model = UNetModel(cfg, dtype=dtype, device=resolve_device(device),
                      seed=seed)
    model.eval()
    return model


def _draw(cfg, batch, res, ctx_len, rng):
    """Latents, timesteps in [0, 1000) and the text context, drawn from
    `rng` in the reference's order (numpy arrays)."""
    return (rng.standard_normal((batch, cfg.in_channels, res, res)),
            rng.randint(0, 1000, (batch,)),
            rng.standard_normal((batch, ctx_len, cfg.context_dim)))


def _put(a, device, dtype):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def inputs(cfg, batch, res, ctx_len, device, dtype=torch.bfloat16, seed=0):
    """(x0, t, ctx) as the reference draws them: latents, timesteps in
    [0, 1000), the text context, from RandomState(seed) in that order."""
    x0, t, ctx = _draw(cfg, batch, res, ctx_len, np.random.RandomState(seed))
    return (_put(x0, device, dtype), _put(t, device, torch.int64),
            _put(ctx, device, dtype))


def train_inputs(cfg, batch, res, ctx_len, device, dtype=torch.bfloat16,
                 seed=0):
    """(xt, t, ctx, noise) of the reference's DDPM step: ``inputs``' draws,
    then from the same RandomState(seed) the noise (x0's shape) and ᾱ ~
    U(0.2, 0.98) per image; x0 and the noise in `dtype`, then xt = √ᾱ·x0 +
    √(1 − ᾱ)·noise in fp32, cast to `dtype`."""
    rng = np.random.RandomState(seed)
    x0, t, ctx = _draw(cfg, batch, res, ctx_len, rng)
    noise = rng.standard_normal(x0.shape)
    abar = _put(rng.uniform(0.2, 0.98, (batch, 1, 1, 1)), device,
                torch.float32)
    x0, noise = _put(x0, device, dtype), _put(noise, device, dtype)
    xt = (torch.sqrt(abar) * x0.float()
          + torch.sqrt(1 - abar) * noise.float()).to(dtype)
    return (xt, _put(t, device, torch.int64), _put(ctx, device, dtype),
            noise)


def optimizer(model):
    """The reference's optimizer of the DDPM step: pure low-precision
    AdamW(1e-4), no fp32 masters."""
    return AdamW(learning_rate=1e-4, multi_precision=False,
                 parameters=model.parameters())


def train_step(model, opt, xt, t, ctx, noise):
    """One DDPM step: ε = model(xt, t, ctx), the loss mean((ε − noise)²) in
    fp32, its backward and the optimizer's step. Returns the loss (a device
    tensor: no host sync)."""
    eps = model(xt, t, ctx)
    loss = torch.mean(torch.square(eps.float() - noise.float()))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


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
                    help="DDPM training steps in place of denoise steps")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
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
    if a.train:
        xt, t, ctx, noise = train_inputs(cfg, a.batch, res, ctx_len, dev)
        opt = optimizer(model)
        flops = forward_flops(model, xt, t, ctx)
        step = lambda: train_step(model, opt, xt, t, ctx, noise)
        warm = [step() for _ in range(WARMUP)]
        run = lambda: [step() for _ in range(a.steps)]
    else:
        x0, t, ctx = inputs(cfg, a.batch, res, ctx_len, dev)
        flops = forward_flops(model, x0, t, ctx)
        warm = [denoise(model, x0, t, ctx, WARMUP)]
        run = lambda: [denoise(model, x0, t, ctx, a.steps)]
    float(torch.stack(warm).float().sum())                  # host sync
    if on_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    out = run()
    if on_cuda:
        ev[1].record()
    finite = bool(torch.isfinite(torch.stack(out).float()).all())  # sync
    wall = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    mode = "train" if a.train else "denoise"
    name = "sd15-unet" if on_cuda else "unet-tiny"
    # a training step is a forward and a backward: 3 forwards' FLOPs
    step_flops = 3 * flops["total"] if a.train else flops["total"]
    rec = {"metric": f"{name} {mode} steps/s (batch={a.batch})",
           "unit": "steps/s", "device": kind, "mode": mode,
           "params": model.num_params(), "batch": a.batch, "res": res,
           "context_len": ctx_len, "steps": a.steps,
           "wall_step_time_ms": 1e3 * wall / a.steps,
           "flops_per_step": flops,
           "mfu_basis": ("3 x forward_flops (forward + backward), "
                         if a.train else "")
           + "analytic: convolutions, linears, attention at the model's "
             "head dims (forward_flops)"}
    if a.train:
        losses = [float(v) for v in warm + out]
        rec.update(losses=losses, loss_first=losses[0],
                   loss_last=losses[-1], loss_finite=finite,
                   optimizer="AdamW(1e-4, multi_precision=False)")
    else:
        rec["eps_finite"] = finite
    if on_cuda:
        step_s = ev[0].elapsed_time(ev[1]) / 1e3 / a.steps
        rec.update(value=1.0 / step_s, step_time_ms=1e3 * step_s,
                   images_per_sec=a.batch / step_s,
                   timing="device(cuda events)",
                   mfu=step_flops / step_s / peak_rates(kind)[1],
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
