"""Llama training throughput on one card (the port's twin of the JAX
package's ``examples/train_bench.py``).

    python -m paddle_tpu_torch.train_bench                    # llama-1b3, cuda
    python -m paddle_tpu_torch.train_bench --model llama-1b    # TinyLlama-1.1B
    python -m paddle_tpu_torch.train_bench --device cpu        # llama-tiny

The reference's configuration: its three shapes (``SHAPES``), per-layer
recompute for the 1B shapes with ``recompute_granularity="core_attn"`` and
``loss_seq_chunks=4`` (the (b, s, 32000) logits never exist at once), bf16
parameters, pure-bf16 AdamW (``AdamW(1e-4, multi_precision=False)``:
moments in bf16, no fp32 master), the same batch every step (ids from
``numpy.random.RandomState(0)``, shape (B, S+1), x/y shifted). Defaults:
llama-1b3 at B=2 on the card (4 for the others), S=2048, 10 steps; a CPU
run takes the reference's CPU shape (llama-tiny, B=2, S=128, 2 steps).

One warm-up step, then the timed steps, timed with CUDA events (device) and
the wall clock; ``--per_step_dispatch`` (the default for the 1B shapes, as
in the reference) reads the loss back after every step. Prints one JSON
line shaped like the reference's record. MFU uses the dense 6N + 12·L·h·S
FLOPs per token against the card's bf16 peak (``bench.PEAKS``); a CPU run
reports no MFU and no device time.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.bench import flops_per_token, peak_rates
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

SHAPES = {
    # ~1.36 B parameters, a GPT-3 XL-like shape
    "llama-1b3": dict(vocab_size=32000, hidden_size=2048, num_layers=24,
                      num_heads=32, num_kv_heads=32, intermediate_size=5632,
                      max_position_embeddings=2048),
    # TinyLlama-1.1B (GQA 32/4)
    "llama-1b": dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                     num_heads=32, num_kv_heads=4, intermediate_size=5632,
                     max_position_embeddings=2048),
    "llama-tiny": dict(vocab_size=512, hidden_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=4, intermediate_size=256,
                       max_position_embeddings=512),
}
BIG = ("llama-1b", "llama-1b3")


def config(name, granularity=None):
    """The reference's LlamaConfig of `name`: recompute on the 1B shapes,
    `granularity` or core_attn there, and 4 loss chunks."""
    cfg = LlamaConfig(**SHAPES[name])
    cfg.recompute = name != "llama-tiny"
    if granularity is not None:
        cfg.recompute_granularity = granularity
    elif name in BIG:
        cfg.recompute_granularity = "core_attn"
    if name in BIG:
        cfg.loss_seq_chunks = 4
    return cfg


def build(cfg, batch, seq, device=None, dtype=torch.bfloat16, seed=0):
    """(model, optimizer, x, y): `cfg`'s Llama with random weights from
    `seed` in `dtype`, pure-low-precision AdamW, and the reference's batch
    (ids from RandomState(0), shifted)."""
    dev = resolve_device(device)
    model = LlamaForCausalLM(cfg, dtype=dtype, device=dev, seed=seed)
    opt = AdamW(learning_rate=1e-4, multi_precision=False,
                parameters=model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq + 1))).to(dev)
    return model, opt, ids[:, :-1], ids[:, 1:]


def train_step(model, opt, x, y, attn_mask=None):
    """One step: train_loss (over `attn_mask`, a padded batch's mask, when
    given), backward, AdamW, under a fresh "dropout" key from the global
    generator (``bench.train_step``'s binding, the reference's train
    step's). Returns the loss (a device tensor: no host sync)."""
    with rng.rng_guard(dropout=rng.global_key()):
        loss = model.train_loss(x, y, attn_mask)
        loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=None,
                    help="default 2 for llama-1b3, 4 otherwise")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--per_step_dispatch", action="store_true",
                    help="read the loss back after every step (the default "
                    "for the 1B shapes unless --granularity is given)")
    ap.add_argument("--granularity", default=None,
                    choices=["full", "full_attn", "core_attn"],
                    help="recompute_granularity: default core_attn for the "
                    "1B shapes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    on_cuda = dev.type == "cuda"
    name = a.model or ("llama-1b3" if on_cuda else "llama-tiny")
    if a.batch is None:
        a.batch = 2 if name == "llama-1b3" else 4
    if not on_cuda:
        a.batch, a.seq, a.steps = 2, 128, 2
    cfg = config(name, a.granularity)
    if a.granularity is None and name in BIG:
        a.per_step_dispatch = True
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    model, opt, x, y = build(cfg, a.batch, a.seq, dev)
    n_params = model.num_params()

    float(train_step(model, opt, x, y))              # warm-up, host sync
    if on_cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
        ev[0].record()
    t0 = time.perf_counter()
    losses = []
    for _ in range(a.steps):
        loss = train_step(model, opt, x, y)
        losses.append(float(loss) if a.per_step_dispatch else loss)
    if on_cuda:
        ev[1].record()
    final_loss = float(losses[-1])                   # full host sync
    wall = time.perf_counter() - t0

    rec = {"metric": f"{name} train tokens/sec/chip", "unit": "tokens/s",
           "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
           "params": n_params, "batch": a.batch, "seq": a.seq,
           "steps": a.steps, "granularity": cfg.recompute_granularity
           if cfg.recompute else None,
           "loss_seq_chunks": cfg.loss_seq_chunks,
           "per_step_dispatch": a.per_step_dispatch,
           "wall_step_time_ms": 1e3 * wall / a.steps,
           "final_loss": final_loss}
    fpt = flops_per_token(cfg, n_params, a.seq)
    if on_cuda:
        dt = ev[0].elapsed_time(ev[1]) / 1e3
        peak = peak_rates(rec["device"])[1]
        tok_s = a.batch * a.seq * a.steps / dt
        mfu = tok_s * fpt / peak
        rec.update(value=tok_s, step_time_ms=1e3 * dt / a.steps,
                   timing="device(cuda events)", mfu=mfu,
                   mfu_basis="dense_6n", vs_baseline=mfu / 0.45,
                   peak_flops=peak,
                   memory={"max_memory_allocated":
                           torch.cuda.max_memory_allocated(dev)})
    else:
        rec.update(value=a.batch * a.seq * a.steps / wall, step_time_ms=None,
                   timing="wall (cpu)", mfu=None, mfu_basis="dense_6n",
                   vs_baseline=None, memory=None)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
