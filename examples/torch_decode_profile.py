"""Where the time of a decode step goes, per CUDA kernel.

    PYTHONPATH=. python3 examples/torch_decode_profile.py [--layers 32]
        [--batch 4] [--pos 1056] [--kv_heads 32]
    PYTHONPATH=. python3 examples/torch_decode_profile.py --generate
    PYTHONPATH=. python3 examples/torch_decode_profile.py --paged
    PYTHONPATH=. python3 examples/torch_decode_profile.py --verify
    PYTHONPATH=. python3 examples/torch_decode_profile.py --serve
    PYTHONPATH=. python3 examples/torch_decode_profile.py --moe
    PYTHONPATH=. python3 examples/torch_decode_profile.py --gpt [--paged]
    PYTHONPATH=. python3 examples/torch_decode_profile.py --int8

Default: builds a Llama-2-7B-width stack (random bf16 weights, seed 0) and
a KV cache filled up to `pos`, times paddle_tpu_torch's fused decode step
with CUDA events, then traces a few steps with torch.profiler and prints
one JSON line: device time per kernel name (sum per step), the step time,
and the byte bound of each kernel family at the card's memory rate.

--generate: traces a whole `inference.generate` call of Llama-2-7B (b=4,
prompt 1024, 64 new tokens) and the same call with one new token, and
prints the wall time and the device-busy time of the 63 decode steps
(their difference), so the device's idle share during decode shows.

--paged: the same split for the paged decode step (K5) at 8 rows (or
--rows) whose positions run evenly from 100 to 1300 (700 cached tokens on
average), each through its own shuffled blocks of 128 tokens.

Each line also carries "products": the products' kernel (engine_kernel:
K2's, K5's and K7's products, K6's attention half), the weight bytes it
streams per step, its device time and its exclusive share of the step (the step time less every
other kernel's device time: an engine launch starts while the kernel
before it still runs, so its device time overlaps that kernel's), and the
rate in TB/s over the exclusive share; and "device_ms_over_step_ms", the
trace's sum against the CUDA-event step time (a trace that lost kernel
records reads low; overlapping kernels read above 1).

--verify: the same split for the paged verify step (K7) at the same 8 rows
with a tail of 5 tokens each (the last token and k = 4 proposals, the
speculative engine's step), 40 tail rows in all, the products on the
engine at N = 64.

Every line carries "attention": the device time of the split-KV attention
kernel (split_attn_kernel; K2, K5 and K6 append and merge inside it, K7
adds its appends kernel and its merge kernel, split_merge_kernel), each
launched as the programmatic dependent of the kernel before it, so it
starts early and waits and the sum of device times counts overlaps twice:
"exclusive_ms", the time only they run (the step's busy time less the time
any other kernel runs), and "span_ms", the union of their intervals,
beside their byte bound (the filled KV).

--moe: the same split for the MoE decode step (K6) at DeepSeekMoE-16B's
shape (28 layers, h 2048, 16 heads, 64 experts of 1408, top-6, 2 shared
experts as one 2816-wide SwiGLU), b=4, pos 1056; the routed experts' bound
counts the distinct experts the step's routing used. The tensor-core
product kernel serves the shared (DenseOps) and the routed (MoEOps)
products.

--gpt: the same split for the gpt mode of K2 at GPT-2 345M's shape (24
layers, h 1024, 16 heads of 64, ffn 4096; random bf16 weights and biases),
b=8, pos 576 (the mean position of a 512 + 128-token generate). Its step
is 1 + 11 × 24 launches of small products, so the device-busy time beside
the step time shows how much of the step is launch gaps. --gpt --paged:
K5's gpt mode at 8 rows, positions 150 … 1000 (the gpt_serve cell's span).

--int8: the same split for K2's int8 mode at the default shape: the layer
weights of a random model quantized per out channel to int8 (quantize_model,
stacked by its fused decode plan) and the cache quantized per (layer, kv
head) to int8 (quantize_kv_cache, as generate(cache_dtype=int8) does); the
byte bounds count one byte a weight and a cached value.

--serve: a Llama-2-7B ServingEngine (8 slots, block 128) with 8 requests
of 500-token prompts decoding; traces 32 ticks and prints the wall time
and device-busy time per tick, its idle share, and the top kernels.

Needs a CUDA GPU; imports nothing of jax or paddle_tpu.
"""

import argparse
import json
import subprocess
import time

import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_decode as fd
from paddle_tpu_torch.ops.rope import rope_cos_sin

BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
               "H100": 3.35e12}
VERIFY_TAIL = 5             # --verify: the last token and k = 4 proposals


def kernel_name(key):
    # "void (anonymous namespace)::engine_kernel<8, bf16>(...)" ->
    # "engine_kernel<8, __nv_bfloat16>"
    return key.replace("void ", "").replace("(anonymous namespace)::",
                                            "").split("(")[0]


def device_ms(prof):
    """Device time (ms) of every CUDA kernel in a trace, by kernel name."""
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        if not dt:
            continue
        name = kernel_name(ev.key)
        per_kernel[name] = per_kernel.get(name, 0.0) + dt / 1e3
    return per_kernel


def span_ms(prof, keep):
    """The device time (ms) during which at least one kernel whose name
    `keep` accepts runs: the union of their intervals in the trace. A
    kernel launched as the programmatic dependent of the one before it
    starts early and waits, so its interval overlaps that kernel's; the
    union counts such overlaps once, where a sum of device times counts
    them twice."""
    iv = sorted((ev.time_range.start, ev.time_range.end)
                for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and keep(kernel_name(ev.name)))
    total, start, end = 0.0, None, None
    for s, e in iv:
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def traced(fn, spans=None):
    """Wall ms of fn and its device ms by kernel; with `spans` ({name:
    keep}), also each span_ms."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if spans is None:
        return wall * 1e3, device_ms(prof)
    return wall * 1e3, device_ms(prof), {k: span_ms(prof, f)
                                         for k, f in spans.items()}


def generate_split(card):
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda",
                             seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), device="cuda",
                        generator=g)
    generate(model, ids, max_new_tokens=64)            # warm
    w64, d64 = traced(lambda: generate(model, ids, max_new_tokens=64))
    w1, d1 = traced(lambda: generate(model, ids, max_new_tokens=1))
    busy = (sum(d64.values()) - sum(d1.values())) / 63
    wall = (w64 - w1) / 63
    top = {k: (v - d1.get(k, 0.0)) / 63 for k, v in d64.items()}
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])
    print(json.dumps({"card": card, "decode_wall_ms_per_step": wall,
                      "decode_device_busy_ms_per_step": busy,
                      "decode_device_idle_share": 1 - busy / wall,
                      "ttft_wall_ms": w1,
                      "top_device_ms_per_step": top}))


def contiguous_step(L, b, pos, nkv, h, nh, hd, ffn, int8=False):
    """K2 over a contiguous cache filled up to `pos`; int8: int8 weights
    with their scale rows and an int8 cache with its scales."""
    S = -(-(pos + 1) // 128) * 128
    dq, dkv = nh * hd, nkv * hd
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s, sc=0.02: torch.empty(*s, device="cuda").normal_(
        0, sc, generator=g).bfloat16()
    if int8:       # the stacks the int8 generate path builds
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.quantization import quantize_model
        cfg = LlamaConfig(vocab_size=256, hidden_size=h,
                          intermediate_size=ffn, num_layers=L, num_heads=nh,
                          num_kv_heads=nkv)
        model = quantize_model(LlamaForCausalLM(
            cfg, dtype=torch.bfloat16, device="cuda", seed=0))
        p = model.fused_decode_plan(
            model.state_dict(include_buffers=False))["params"]
    else:
        p = {"ln1": torch.ones(L, h, device="cuda").bfloat16(),
             "wqkv": mk(L, h, dq + 2 * dkv), "wo": mk(L, dq, h),
             "ln2": torch.ones(L, h, device="cuda").bfloat16(),
             "wg": mk(L, h, ffn), "wu": mk(L, h, ffn), "wd": mk(L, ffn, h)}
    kv = torch.zeros(L, b, S, 2 * dkv, device="cuda", dtype=torch.bfloat16)
    kv[:, :, :pos] = mk(L, b, pos, 2 * dkv, sc=1.0)
    x = mk(b, h, sc=1.0)
    cos, sin = rope_cos_sin(S, hd, device="cuda")
    scales = None
    if int8:
        kv, scales = fd.quantize_kv_cache(kv, nkv)
    step = lambda: fd.fused_decode_cuda(
        x, p, kv, pos, cos[pos:pos + 1], sin[pos:pos + 1], num_heads=nh,
        num_kv_heads=nkv, kv_scales=scales)
    return step, p, L * b * (pos + 1) * 2 * dkv * kv.element_size()


def gpt_step(L=24, b=8, pos=576, h=1024, nh=16, ffn=4096):
    """K2's gpt mode over a contiguous cache filled up to `pos`."""
    S = -(-(pos + 1) // 128) * 128
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s, sc=0.02: torch.empty(*s, device="cuda").normal_(
        0, sc, generator=g).bfloat16()
    p = gpt_params(L, h, ffn, mk)
    kv = torch.zeros(L, b, S, 2 * h, device="cuda", dtype=torch.bfloat16)
    kv[:, :, :pos] = mk(L, b, pos, 2 * h, sc=1.0)
    x = mk(b, h, sc=1.0)
    step = lambda: fd.fused_decode_cuda(x, p, kv, pos, None, None,
                                        num_heads=nh, num_kv_heads=nh,
                                        arch="gpt")
    return step, p, L * b * (pos + 1) * 2 * h * 2


def serve_split(card, ticks=32):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Request, ServingEngine
    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda",
                             seed=0)
    eng = ServingEngine(model, max_slots=8, block_tokens=128,
                        max_seq_len=2048)
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        eng.submit(Request(torch.randint(0, cfg.vocab_size, (500,),
                                         generator=g).numpy(),
                           max_new_tokens=2 * ticks + 8))
    for _ in range(4):                     # admit, prefill, warm ticks
        eng.step()
    wall, dev = traced(lambda: [eng.step() for _ in range(ticks)])
    busy = sum(dev.values()) / ticks
    top = dict(sorted(((k, v / ticks) for k, v in dev.items()),
                      key=lambda kv: -kv[1])[:8])
    print(json.dumps({"card": card, "ticks": ticks, "slots": 8,
                      "wall_ms_per_tick": wall / ticks,
                      "device_busy_ms_per_tick": busy,
                      "device_idle_share": 1 - busy / (wall / ticks),
                      "top_device_ms_per_tick": top}))


def gpt_params(L, h, ffn, mk):
    """Random bf16 gpt stacks (build_fused_params_gpt's keys)."""
    return {"ln1": 1 + mk(L, h), "ln1_b": mk(L, h), "wqkv": mk(L, h, 3 * h),
            "bqkv": mk(L, 3 * h), "wo": mk(L, h, h), "bo": mk(L, h),
            "ln2": 1 + mk(L, h), "ln2_b": mk(L, h), "wg": mk(L, h, ffn),
            "bg": mk(L, ffn), "wd": mk(L, ffn, h), "bd": mk(L, h)}


def paged_step(L, b, nkv, tail=0, h=4096, nh=32, hd=128, ffn=11008,
               BT=128, span=(100, 1300), arch="llama"):
    """K5 (tail 0) or K7 (a tail of `tail` tokens per row) at 8 rows,
    positions spread evenly over `span`, shuffled private blocks; arch gpt:
    K5's gpt mode (no rope)."""
    positions = [int(span[0] + i * (span[1] - span[0]) / (b - 1))
                 for i in range(b)]
    need = [(p + max(tail, 1) - 1) // BT + 1 for p in positions]
    nb = 1 + sum(need)
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s, sc=0.02: torch.empty(*s, device="cuda").normal_(
        0, sc, generator=g).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    if arch == "gpt":
        p = gpt_params(L, h, ffn, mk)
    else:
        p = {"ln1": torch.ones(L, h, device="cuda").bfloat16(),
             "wqkv": mk(L, h, dq + 2 * dkv), "wo": mk(L, dq, h),
             "ln2": torch.ones(L, h, device="cuda").bfloat16(),
             "wg": mk(L, h, ffn), "wu": mk(L, h, ffn), "wd": mk(L, ffn, h)}
    pool = mk(L, nb, BT, 2 * dkv, sc=1.0)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(0))
    tables = torch.zeros(b, 2048 // BT, dtype=torch.int32)
    nxt = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[nxt:nxt + n].to(torch.int32) + 1
        nxt += n
    tab = tables.cuda()
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    cos, sin = rope_cos_sin(2048, hd, device="cuda")
    kw = dict(num_heads=nh, num_kv_heads=nkv, arch=arch)
    if tail:
        pj = pos.long()[:, None] + torch.arange(tail, device="cuda")[None]
        c, s = cos[pj], sin[pj]
        x = mk(b, tail, h, sc=1.0)
        step = lambda: fd.fused_paged_verify_cuda(x, p, pool, tab, pos, c,
                                                  s, **kw)
    else:
        c, s = cos.index_select(0, pos), sin.index_select(0, pos)
        x = mk(b, h, sc=1.0)
        step = lambda: fd.fused_paged_decode_cuda(x, p, pool, tab, pos, c,
                                                  s, **kw)
    keys = sum(q + max(tail, 1) for q in positions)
    return step, p, L * keys * 2 * dkv * 2, positions


def moe_step(b=4, pos=1056, L=28, h=2048, nh=16, hd=128, E=64, k=6,
             f=1408, fs=2816):
    """K6 over a contiguous cache filled up to `pos`, DeepSeekMoE-16B's
    shape, random weights (std 0.02, the router's logits std ≈ 0.9)."""
    S = -(-(pos + 1) // 128) * 128
    dq = dkv = nh * hd
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s, sc=0.02: torch.empty(*s, device="cuda").normal_(
        0, sc, generator=g).bfloat16()
    p = {"ln1": torch.ones(L, h, device="cuda").bfloat16(),
         "wqkv": mk(L, h, dq + 2 * dkv), "wo": mk(L, dq, h),
         "ln2": torch.ones(L, h, device="cuda").bfloat16(),
         "gate": mk(L, E, h), "weg": mk(L, E, h, f), "weu": mk(L, E, h, f),
         "wed": mk(L, E, f, h), "wsg": mk(L, h, fs), "wsu": mk(L, h, fs),
         "wsd": mk(L, fs, h)}
    kv = torch.zeros(L, b, S, 2 * dkv, device="cuda", dtype=torch.bfloat16)
    kv[:, :, :pos] = mk(L, b, pos, 2 * dkv, sc=1.0)
    x = mk(b, h, sc=1.0)
    cos, sin = rope_cos_sin(S, hd, device="cuda")
    kw = dict(num_heads=nh, num_kv_heads=nh, top_k=k)
    route = {}
    fd.fused_decode_moe_cuda(x, p, kv, pos, cos[pos:pos + 1],
                             sin[pos:pos + 1], routing=route, **kw)
    ids = route["ids"].cpu()
    distinct = sum(len(set(ids[l].flatten().tolist())) for l in range(L))
    step = lambda: fd.fused_decode_moe_cuda(
        x, p, kv, pos, cos[pos:pos + 1], sin[pos:pos + 1], **kw)
    return step, p, L * b * (pos + 1) * 2 * dkv * 2, distinct


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pos", type=int, default=1056)
    ap.add_argument("--kv_heads", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--gpt", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--rows", type=int, default=8,
                    help="--paged / --verify: rows of the step")
    ap.add_argument("--attention-kernels", default="split_,verify_append",
                    help="comma-separated name prefixes of the attention's "
                         "kernels (another tree's kernel names, to profile "
                         "it with this script)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--id=0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    bw = next(v for k, v in BYTES_PER_S.items() if k in kind)
    _build.build_all()
    if a.generate:
        return generate_split(card)
    if a.serve:
        return serve_split(card)
    L, b, pos, nkv = a.layers, a.batch, a.pos, a.kv_heads
    h, nh, hd, ffn = 4096, 32, 128, 11008
    if a.gpt and a.paged:
        L, b, nkv = 24, a.rows, 16
        step, p, kvb, pos = paged_step(L, b, nkv, h=1024, nh=16, hd=64,
                                       ffn=4096, span=(150, 1000),
                                       arch="gpt")
    elif a.gpt:
        L, b, pos, nkv = 24, 8, 576, 16
        step, p, kvb = gpt_step(L, b, pos)
    elif a.moe:
        L, b, pos, nkv = 28, 4, 1056, 16
        step, p, kvb, distinct = moe_step(b, pos, L)
    elif a.paged or a.verify:
        b = a.rows
        step, p, kvb, pos = paged_step(L, b, nkv,
                                       tail=VERIFY_TAIL if a.verify else 0)
    else:
        step, p, kvb = contiguous_step(L, b, pos, nkv, h, nh, hd, ffn,
                                       int8=a.int8)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(a.steps):
        step()
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / a.steps
    prod_name = "engine_kernel"
    # the attention's kernels: the split-KV kernel (and K7's appends and
    # merge kernels)
    attn = lambda k: k.startswith(tuple(a.attention_kernels.split(",")))
    _, per_kernel, spans = traced(
        lambda: [step() for _ in range(a.steps)],
        {"other": lambda k: not k.startswith(prod_name),
         "attention": attn,
         "all": lambda k: True,
         "not_attention": lambda k: not attn(k)})
    per_kernel = {k: v / a.steps for k, v in per_kernel.items()}
    spans = {k: v / a.steps for k, v in spans.items()}
    wb = lambda *ks: sum(p[k].numel() * p[k].element_size() for k in ks)
    bounds_ms = {"qkv gemm": wb("wqkv") / bw * 1e3,
                 "o-proj gemm": wb("wo") / bw * 1e3,
                 "attention (filled KV)": kvb / bw * 1e3}
    if a.moe:
        expert = wb("weg", "weu", "wed") / (L * p["weg"].shape[1])
        bounds_ms.update({
            "router (gate)": wb("gate") / bw * 1e3,
            "shared experts": wb("wsg", "wsu", "wsd") / bw * 1e3,
            f"routed experts ({distinct} distinct)":
                distinct * expert / bw * 1e3})
    elif a.gpt:
        bounds_ms.update({"fc_in gemm": wb("wg") / bw * 1e3,
                          "fc_out gemm": wb("wd") / bw * 1e3})
    else:
        bounds_ms.update({"gate/up gemm": wb("wg", "wu") / bw * 1e3,
                          "down gemm": wb("wd") / bw * 1e3})
    # the products' kernel and the weight bytes it streams per step: the
    # engine (K6: its attention half's qkv and o-proj; its routed and
    # shared experts run on tc_gemm_partial_kernel)
    prod_keys = (("wqkv", "wo") if a.moe else ("wqkv", "wo", "wg", "wd")
                 if a.gpt else ("wqkv", "wo", "wg", "wu", "wd"))
    prod_ms = sum(v for k, v in per_kernel.items()
                  if k.startswith(prod_name))
    # An engine launch starts while the kernel before it runs (programmatic
    # dependent launch) and streams weights then, so its device time
    # overlaps that kernel's. Its exclusive share of the step is the step
    # time less the time any other kernel runs (launch gaps included; K7's
    # attention kernels overlap each other the same way, so their union).
    excl = step_ms - spans["other"]
    nbytes = wb(*prod_keys)
    products = {"kernel": prod_name, "weights": list(prod_keys),
                "bytes": nbytes, "device_ms": prod_ms, "exclusive_ms": excl,
                "tb_per_s": nbytes / excl / 1e9 if prod_ms else None}
    attention = {
        # the time only they run: the step's busy time less the time any
        # other kernel runs (they start early behind the qkv epilogue, the
        # o-proj's engine behind them)
        "exclusive_ms": spans["all"] - spans["not_attention"],
        "span_ms": spans["attention"],
        "device_ms_summed": sum(v for k, v in per_kernel.items()
                                if attn(k)),
        "bound_ms": bounds_ms["attention (filled KV)"]}
    print(json.dumps({"card": card, "layers": L, "batch": b, "pos": pos,
                      "kernel": ("K7 (verify), tail %d" % VERIFY_TAIL
                                 if a.verify else
                                 "K6 (MoE), DeepSeekMoE-16B" if a.moe else
                                 "K5 (gpt), GPT-2 345M" if a.gpt and a.paged
                                 else
                                 "K2 (gpt), GPT-2 345M" if a.gpt else
                                 "K5 (paged)" if a.paged else
                                 "K2 (int8 weights, int8 KV)" if a.int8
                                 else "K2"),
                      "kv_heads": nkv, "step_ms": step_ms,
                      "device_ms_per_step_by_kernel": per_kernel,
                      "device_ms_per_step": sum(per_kernel.values()),
                      # the trace's sum against the CUDA-event step time: a
                      # trace that lost kernel records reads low; above 1,
                      # kernels overlapped (the engine's early starts)
                      "device_ms_over_step_ms":
                          sum(per_kernel.values()) / step_ms,
                      "products": products, "attention": attention,
                      "bound_ms_by_part": bounds_ms,
                      "bound_ms": sum(bounds_ms.values())}))


if __name__ == "__main__":
    main()
