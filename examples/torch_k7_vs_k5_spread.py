"""The spread of chip_smoke.py's K7-against-K5 check over seeds.

    PYTHONPATH=. python3 examples/torch_k7_vs_k5_spread.py [--seeds 8]

``chip_smoke.k7_vs_k5`` runs one all-accepted K7 step (8 rows x a 5-token
tail, Llama-2-7B width, 2 layers, random weights and pool) against 5
sequential K5 steps over a clone of the same pool, and holds each token's
x_out and appended row to K2's tolerance. This runs it once per seed, each
seed drawing every input from a generator of its own, and prints one JSON
line: per seed the largest x_out and appended-row differences over the 5
tokens and whether the check passed, then their spread. The tolerance is
the check's own (``K2_ATOL``, ``K2_RTOL``), unchanged.

Needs a CUDA GPU; imports nothing of jax or paddle_tpu.
"""

import argparse
import json
import subprocess

import torch

import chip_smoke as cs
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_decode as fd
from paddle_tpu_torch.ops import rope


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _build.build_all()
    runs = []
    for seed in range(a.seeds):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        r = cs.k7_vs_k5(fd, rope, gen)
        runs.append({
            "seed": seed,
            "x_out_max_abs_diff": max(t["x_out_max_abs_diff"]
                                      for t in r["per_token"]),
            "appended_row_max_abs_diff": max(
                t["appended_row_max_abs_diff"] for t in r["per_token"]),
            "ok": r["ok"]})
    xs = [r["x_out_max_abs_diff"] for r in runs]
    rows = [r["appended_row_max_abs_diff"] for r in runs]
    print(json.dumps({"card": card, "seeds": a.seeds, "atol": cs.K2_ATOL,
                      "rtol": cs.K2_RTOL, "runs": runs,
                      "x_out_max_abs_diff": {"min": min(xs), "max": max(xs)},
                      "appended_row_max_abs_diff": {"min": min(rows),
                                                    "max": max(rows)},
                      "passed": sum(r["ok"] for r in runs)}))


if __name__ == "__main__":
    main()
