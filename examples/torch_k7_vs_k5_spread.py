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

Each seed also holds both kernels to the exact function: the plain verify
in fp32 (weights, pool and x upcast to fp32) on the same inputs, x_out of
every active row and token. ``k7_vs_fp32`` and ``k5_vs_fp32`` are the
largest differences per seed; ``k7_minus_k5_in_bf16_ulps`` compares them in
units of one bf16 ulp at the largest |x_out| (where the gap between the two
kernels is read): at most 1 means K7 strays from the exact function no
further than K5 does, so the two kernels' gap is their rounding, not a
fault of either.

Needs a CUDA GPU; imports nothing of jax or paddle_tpu.
"""

import argparse
import json
import math
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
        r = cs.k7_vs_k5(fd, rope, gen, fp32=True)
        tok = r["per_token"]
        runs.append({
            "seed": seed,
            "x_out_max_abs_diff": max(t["x_out_max_abs_diff"] for t in tok),
            "appended_row_max_abs_diff": max(
                t["appended_row_max_abs_diff"] for t in tok),
            "k7_vs_fp32": max(t["k7_vs_fp32"] for t in tok),
            "k5_vs_fp32": max(t["k5_vs_fp32"] for t in tok),
            "x_out_absmax": r["x_out_absmax"],
            "ok": r["ok"]})
        ulp = 2.0 ** (math.floor(math.log2(r["x_out_absmax"])) - 7)
        runs[-1]["k7_minus_k5_in_bf16_ulps"] = (
            runs[-1]["k7_vs_fp32"] - runs[-1]["k5_vs_fp32"]) / ulp
    xs = [r["x_out_max_abs_diff"] for r in runs]
    rows = [r["appended_row_max_abs_diff"] for r in runs]
    gaps = [r["k7_minus_k5_in_bf16_ulps"] for r in runs]
    print(json.dumps({"card": card, "seeds": a.seeds, "atol": cs.K2_ATOL,
                      "rtol": cs.K2_RTOL, "runs": runs,
                      "x_out_max_abs_diff": {"min": min(xs), "max": max(xs)},
                      "appended_row_max_abs_diff": {"min": min(rows),
                                                    "max": max(rows)},
                      "k7_vs_fp32_max": max(r["k7_vs_fp32"] for r in runs),
                      "k5_vs_fp32_max": max(r["k5_vs_fp32"] for r in runs),
                      "k7_minus_k5_in_bf16_ulps_max": max(gaps),
                      "passed": sum(r["ok"] for r in runs)}))


if __name__ == "__main__":
    main()
