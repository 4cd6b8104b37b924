"""GPT-2 345M pretraining throughput on one card (the port's twin of the
JAX package's ``bench.py``).

    python -m paddle_tpu_torch.bench                      # on cuda
    python -m paddle_tpu_torch.bench --device cpu --tiny  # a short CPU run

The same configuration as ``bench.py``: ``GPTConfig.gpt2_medium()`` with
both dropouts 0 (``config``; ``train_step`` takes a model at any dropout,
binding one "dropout" key a step), bf16 parameters, ``AdamW(learning_rate=1e-4)`` with fp32
masters and moments, B=8, S=1024, the same batch every step (ids from
``numpy.random.RandomState(0)``, shape (B, S+1), x/y shifted), and
``n_steps`` = 20. One warm-up pass of ``n_steps``, then a timed pass, timed
with CUDA events (device) and the wall clock. ``--tiny`` takes
``bench.py``'s CPU shape (hidden 256, 4 layers, 8 heads, B=2, S=256, 3
steps).

Prints one JSON line shaped like ``bench.py``'s record. MFU uses the dense
6N + 12·L·h·S FLOPs per token (``bench.py:116``) against the card's bf16
peak (``PEAKS``); a CPU run reports no MFU and no device time.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
from paddle_tpu_torch.optimizer import AdamW

# (card name key, device-memory bytes/s, bf16 dense FLOP/s), from NVIDIA's
# data sheets; the first key found in the card's name wins
PEAKS = (("H100 PCIe", 2.0e12, 756e12), ("H100 NVL", 3.9e12, 835e12),
         ("H200", 4.8e12, 989e12), ("H100", 3.35e12, 989e12))


def peak_rates(kind):
    """(bytes/s, bf16 FLOP/s) of the card named `kind`."""
    for key, bw, flops in PEAKS:
        if key in kind:
            return bw, flops
    raise RuntimeError(f"no peak rates known for {kind!r}")


def config(tiny=False):
    """(cfg, B, S, n_steps) of bench.py: the full run, or its CPU shape."""
    if tiny:
        return (GPTConfig(vocab_size=50304, hidden_size=256, num_layers=4,
                          num_heads=8, max_position_embeddings=1024,
                          hidden_dropout_prob=0.0,
                          attention_dropout_prob=0.0), 2, 256, 3)
    cfg = GPTConfig.gpt2_medium()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_dropout_prob = 0.0
    return cfg, 8, 1024, 20


def build(cfg, B, S, device=None, dtype=torch.bfloat16, seed=0):
    """(model, optimizer, x, y): random weights from `seed`, AdamW 1e-4,
    and bench.py's batch."""
    dev = resolve_device(device)
    model = GPTPretrainModel(cfg, dtype=dtype, device=dev, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    return model, opt, ids[:, :-1], ids[:, 1:]


def train_step(model, opt, x, y):
    """One step: forward, loss, backward, AdamW, under a fresh "dropout"
    key from the global generator, bound for the step as the reference's
    train step binds one (``make_train_step(rng_streams=("dropout",))``,
    ``paddle_tpu/parallel/fleet.py:391-396``). Returns the loss (a device
    tensor: no host sync)."""
    with rng.rng_guard(dropout=rng.global_key()):
        loss = model.loss(model(x), y)
        loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def run_steps(model, opt, x, y, n_steps):
    return torch.stack([train_step(model, opt, x, y)
                        for _ in range(n_steps)])


def flops_per_token(cfg, n_params, S):
    return 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * S


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="bench.py's CPU shape")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cfg, B, S, n_steps = config(a.tiny)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    model, opt, x, y = build(cfg, B, S, dev)
    n_params = model.num_params()

    losses = run_steps(model, opt, x, y, n_steps)     # warm-up pass
    float(losses[-1])
    if on_cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
        ev[0].record()
    t0 = time.perf_counter()
    losses = run_steps(model, opt, x, y, n_steps)
    if on_cuda:
        ev[1].record()
    final_loss = float(losses[-1])                    # full host sync
    wall = time.perf_counter() - t0

    rec = {"metric": "gpt2-345m tokens/sec/chip", "unit": "tokens/s",
           "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
           "params": n_params, "batch": B, "seq": S, "steps": n_steps,
           "wall_step_time_ms": 1e3 * wall / n_steps,
           "final_loss": final_loss}
    if on_cuda:
        dt = ev[0].elapsed_time(ev[1]) / 1e3
        peak = peak_rates(rec["device"])[1]
        tok_s = B * S * n_steps / dt
        rec.update(value=tok_s, step_time_ms=1e3 * dt / n_steps,
                   timing="device(cuda events)",
                   mfu=tok_s * flops_per_token(cfg, n_params, S) / peak,
                   mfu_basis="dense_6n", peak_flops=peak,
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    else:
        rec.update(value=B * S * n_steps / wall, step_time_ms=None,
                   timing="wall (cpu)", mfu=None, mfu_basis="dense_6n",
                   max_memory_allocated=None)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
