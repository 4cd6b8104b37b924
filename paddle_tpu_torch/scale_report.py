"""ERNIE-3.0 Titan's training step at full width on one card (the port's twin
of ``examples/scale_report.py ernie-titan-step``).

    python -m paddle_tpu_torch.scale_report ernie-titan-step
    python -m paddle_tpu_torch.scale_report ernie-titan-step --seq 512 --batch 8
    python -m paddle_tpu_torch.scale_report ernie-titan-step --device cpu --tiny

``execute_titan_step`` (``examples/scale_report.py:211-255``):
``ErnieConfig.ernie3_titan()`` (hidden 12288, 96 heads of d 128, ffn 49152,
vocab 40000) cut in depth to ``--layers`` shared + ``--task_layers`` task
layers (the reference's 1 + 1 of 48 + 12), ``max_position_embeddings``
max(seq, 512), no dropout, bf16 parameters drawn from a seed,
``SGD(learning_rate=1e-4)`` with fp32 masters, the batch ``(batch, seq + 1)``
of ``numpy.random.RandomState(0)`` ids with the next tokens as labels, the
same batch every step. A step is the reference's ``Engine.fit`` step: the
NLU branch ``model(input)``, ``model.loss``, the gradients of every
parameter the loss reaches, the SGD update. (The NLG task layers and the
token types get no gradient; with no weight decay the reference's update
leaves them as they are, so the twin does not step them.) Two warm-up
steps (the reference's compile-and-run pass), then ``--steps`` counted ones
(6), each timed with CUDA events.

Prints one JSON line: step ms, tokens/s, MFU, peak memory and every loss.
MFU is dense 6N: 6 × the parameters the step trains (those with a
gradient, the embedding included) × tokens, against the card's bf16 peak;
attention's score products are left out (at seq 128 they are 0.1 % of it).
``--tiny`` takes ``ErnieConfig.tiny()`` for a CPU run, which reports no
device time, no MFU and no memory.

The script's other subcommands (``7b``, ``65b``, ``ernie-l2`` …, ``--report``)
are XLA ahead-of-time memory reports of the JAX package's sharded programs;
they have no counterpart here and exit non-zero.
"""

import argparse
import json
import sys

import numpy as np
import torch

from paddle_tpu_torch.bench import peak_rates
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.optimizer import SGD

# untimed steps before the counted ones (the reference's compile-and-run
# pass over two batches)
WARMUP = 2


def config(layers=1, task_layers=1, seq=128, tiny=False):
    """The reference's Titan cut: ernie3_titan() at `layers` + `task_layers`
    depth (or ErnieConfig.tiny()), positions for max(seq, 512) (tiny: its
    own 64 at least seq), no dropout."""
    cfg = ErnieConfig.tiny() if tiny else ErnieConfig.ernie3_titan()
    cfg.num_hidden_layers = layers
    cfg.num_task_layers = task_layers
    cfg.max_position_embeddings = max(seq, 64 if tiny else 512)
    cfg.hidden_dropout_prob = 0.0
    return cfg


def build(cfg, device=None, dtype=torch.bfloat16, seed=0):
    """(model, optimizer, its state): random weights from `seed` in
    `dtype`, SGD(1e-4) with fp32 masters."""
    model = ErnieForPretraining(cfg, dtype=dtype, device=device, seed=seed)
    opt = SGD(learning_rate=1e-4)
    state = opt.init_state({k: p.detach() for k, p in
                            model.trainable_state().items()})
    return model, opt, state


def batch(cfg, b, s, device, seed=0):
    """(input, labels): (b, s + 1) ids of RandomState(seed), shifted."""
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s + 1))).to(device)
    return ids[:, :-1], ids[:, 1:]


def train_step(model, opt, state, x, y):
    """One Engine.fit step: the NLU forward, the loss, the gradients, SGD
    in place on the parameters the loss reaches (their masters advance in
    `state`). Returns (the loss as a device tensor, the number of
    parameters stepped)."""
    params = model.trainable_state()
    loss = model.loss(model(x), y)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    if opt.weight_decay:
        # the decay reaches a parameter without a gradient too
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
    reached = {k: g for k, g in zip(params, grads) if g is not None}
    values = {k: params[k].detach() for k in reached}
    opt.update_(reached, state, values, out=values)
    return loss.detach(), sum(params[k].numel() for k in reached)


def run(a):
    dev = resolve_device(a.device)
    on_cuda = dev.type == "cuda"
    cfg = config(a.layers, a.task_layers, a.seq, a.tiny)
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    model, opt, state = build(cfg, dev)
    x, y = batch(cfg, a.batch, a.seq, dev)
    losses, times = [], []
    for _ in range(WARMUP + a.steps):
        if on_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        loss, trained = train_step(model, opt, state, x, y)
        if on_cuda:
            ev[1].record()
            times.append(ev)
        losses.append(loss)
    losses = [float(l) for l in losses]               # full host sync
    rec = {"metric": "ernie-3.0-titan-width step", "subcommand":
           "ernie-titan-step",
           "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
           "config": "ernie3_titan" if not a.tiny else "tiny",
           "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "ffn": cfg.intermediate_size, "vocab": cfg.vocab_size,
           "layers": cfg.num_hidden_layers,
           "task_layers": cfg.num_task_layers,
           "depth_cut": f"{cfg.num_hidden_layers} + {cfg.num_task_layers} "
                        "of 48 + 12 layers (the reference's cut)",
           "optimizer": "SGD(learning_rate=1e-4), fp32 masters",
           "params": model.num_params(), "trained_params": trained,
           "batch": a.batch, "seq": a.seq, "warmup_steps": WARMUP,
           "steps": a.steps, "warmup_losses": losses[:WARMUP],
           "losses": losses[WARMUP:]}
    if on_cuda:
        ms = [e[0].elapsed_time(e[1]) for e in times[WARMUP:]]
        step_ms = sum(ms) / len(ms)
        peak = peak_rates(rec["device"])[1]
        tok_s = a.batch * a.seq / (step_ms / 1e3)
        rec.update(step_ms=step_ms, step_ms_each=ms,
                   timing="device (cuda events around each step)",
                   tokens_per_s=tok_s, mfu=tok_s * 6 * trained / peak,
                   mfu_basis="6 x trained params (with a gradient, "
                             "embedding included) x tokens; bf16 dense "
                             "peak",
                   peak_flops=peak,
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    else:
        rec.update(step_ms=None, tokens_per_s=None, mfu=None,
                   max_memory_allocated=None, timing="not measured (cpu)")
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "ernie-titan-step":
        what = argv[0] if argv else "(none)"
        print(f"scale_report: subcommand {what!r} has no counterpart in the "
              "port: the reference's other subcommands are XLA "
              "ahead-of-time memory reports of sharded JAX programs; the "
              "port runs `ernie-titan-step`", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--task_layers", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                                                   "cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="ErnieConfig.tiny() for a CPU run")
    run(ap.parse_args(argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
