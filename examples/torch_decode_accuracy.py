"""How far the decode kernels stray from their plain versions, and why.

    PYTHONPATH=. python3 examples/torch_decode_accuracy.py --case moe
    PYTHONPATH=. python3 examples/torch_decode_accuracy.py --case int8kv

Run from the root of a tree (PYTHONPATH=<tree> for another one, the tree's
own chip_smoke.py and package are imported), so two trees can be held to
the same draws in one call. One JSON line a case.

--case moe: K6 at each of chip_smoke's K6 widths (Mixtral-8x7B: GQA 32/8,
8 experts of 14336, top-2; DeepSeekMoE-16B: MHA, 64 experts of 1408,
top-6, 2 shared), 2 layers, b=4, pos 1056, random bf16 weights with the
router's gate as drawn (x1) and scaled by 8 (phase k6's strict case), run
three ways on the same inputs: K6, the plain version in bf16 (what phase k6
holds K6 to) and the plain version in fp32 with the bf16 run's experts
forced (the exact function of the bf16 weights and inputs). Each line: K6
routes as the plain version, the largest |K6 − plain|, whether it is within
phase k6's tolerance (K2_ATOL + K2_RTOL·|plain|) and how many elements are
past it, and each path's largest and mean distance from fp32.

--case int8kv: K2 at Llama-2-7B width (MHA) over an int8 cache with scales
from random rows at every position (the rows from pos on zeroed), b=2, S
1501, at positions 1, 2, 5, 600 and 1500, with 2 layers and with 1: the
largest |x_out − plain| and whether it is within K2's tolerance, and the
appended lanes a layer that land an int8 step away from the plain
version's.

Needs a CUDA GPU; imports nothing of jax or paddle_tpu.
"""

import argparse
import json

import torch

import chip_smoke as cs
from paddle_tpu_torch.ops import fused_decode as fd
from paddle_tpu_torch.ops import rope


def moe_case(width, seed, gate_scale, L=2, b=4, S=1152, pos=1056):
    w = cs.K6_WIDTHS[width]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000 + seed)
    p = cs.moe_params(gen, L, **w)
    p["gate"] = p["gate"] * gate_scale        # exact in bf16
    nh, nkv, hd, k = w["nh"], w["nkv"], w["hd"], w["k"]
    kv = torch.zeros((L, b, S, 2 * nkv * hd), dtype=torch.bfloat16,
                     device="cuda")
    kv[:, :, :pos] = cs.rand((L, b, pos, 2 * nkv * hd), gen)
    x = cs.rand((b, w["h"]), gen)
    cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, top_k=k)
    kr, pr = {}, {}
    xk, _ = fd.fused_decode_moe_cuda(x, p, kv.clone(), pos, c, s, routing=kr,
                                     **kw)
    xp, _ = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s,
                                      arch="moe", routing=pr, **kw)
    xe, _ = fd.fused_decode_reference(
        x.float(), {n: t.float() for n, t in p.items()}, kv.float(), pos, c,
        s, arch="moe", routing={"force_ids": pr["ids"]}, **kw)
    xk, xp = xk.float(), xp.float()
    err, ok = cs.close(xk, xp, cs.K2_ATOL, cs.K2_RTOL)
    past = (xk - xp).abs() > cs.K2_ATOL + cs.K2_RTOL * xp.abs()
    ke, pe = (xk - xe).abs(), (xp - xe).abs()
    return {"case": "moe", "width": width, "seed": seed,
            "gate_scale": gate_scale,
            "routing_as_plain": bool(torch.equal(
                kr["ids"].long().sort(-1).values,
                pr["ids"].long().sort(-1).values)),
            "k6_vs_plain": err, "within_tolerance": ok,
            "elements_past_tolerance": int(past.sum()),
            "k6_vs_fp32_max": ke.max().item(),
            "plain_vs_fp32_max": pe.max().item(),
            "k6_vs_fp32_mean": ke.mean().item(),
            "plain_vs_fp32_mean": pe.mean().item()}


def int8kv_cases(seed, L, nkv=32, b=2, S=1501):
    w = cs.WIDTHS["llama"]
    h, nh, hd = w["h"], w["nh"], w["hd"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(500 + seed)
    params = cs.stack_params(gen, "llama", L, nkv)
    cos, sin = rope.rope_cos_sin(S, hd, device="cuda")
    for pos in (1, 2, 5, 600, 1500):
        src = cs.rand((L, b, S, 2 * nkv * hd), gen)
        kv, scales = fd.quantize_kv_cache(src, nkv)
        kv[:, :, pos:] = 0
        x = cs.rand((b, h), gen)
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
        kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5,
                  kv_scales=scales)
        xk, kk = fd.fused_decode_cuda(x, params, kv.clone(), pos, c, s, **kw)
        xr, kr = fd.fused_decode_reference(x, params, kv.clone(), pos, c, s,
                                           **kw)
        err, ok = cs.close(xk, xr, cs.K2_ATOL, cs.K2_RTOL)
        d = (kk[:, :, pos].int() - kr[:, :, pos].int()).abs()
        yield {"case": "int8kv", "layers": L, "seed": seed, "pos": pos,
               "x_out_vs_plain": err, "within_tolerance": ok,
               "append_lanes_off_by_layer": [int((d[l] > 0).sum())
                                             for l in range(L)],
               "append_max_int8_steps": int(d.max())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("moe", "int8kv"), required=True)
    ap.add_argument("--seeds", type=int, default=6)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.case == "moe":
        for width in cs.K6_WIDTHS:
            for seed in range(a.seeds):
                for gate_scale in (1.0, 8.0):
                    print(json.dumps(moe_case(width, seed, gate_scale)),
                          flush=True)
        return
    for L in (2, 1):
        for seed in range(a.seeds):
            for row in int8kv_cases(seed, L):
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
