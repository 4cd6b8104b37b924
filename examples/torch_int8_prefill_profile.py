"""Where the time of the int8 serving engine's prefill goes, on the card.

    PYTHONPATH=. python3 examples/torch_int8_prefill_profile.py
        [--layers 32] [--prompt 600] [--rows 1] [--int8-weights]

Builds a Llama-2-7B-width model (random bf16 weights, seed 0; with
--int8-weights through quantization.quantize_model) and, for a bf16 and an
int8 pool, an 8-slot ServingEngine (block 128, max_seq_len 2048). Each of
three repetitions admits `rows` fresh random prompts of `prompt` tokens
(one prefill group) into a fresh engine and times, with a synchronize
around each part: the whole admission (`_admit`: the group's prefill and
the slots' adoption), the prefill itself (`_prefill`: the cache forward,
the first-token sample and the pool scatter; int8: the calibration and
quantization too), the bf16 host copies of the prompt blocks the int8
prefix cache keeps (`_host_blocks`), and the model's cache forward alone
on the same ids (the first repetition and the best of three, ms). Then
the copy itself: 16 blocks of one prefix-cache entry's shape (L, 128,
2*nkv*hd) bf16, each kept alive as the cache keeps them, copied from the
card into fresh pageable memory, into fresh pinned memory, and into pinned
memory the allocator hands back after a free (GB/s). Prints one JSON line,
the card's name and power limit first.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def timed(fn, acc, key):
    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=600)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--int8-weights", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    from paddle_tpu_torch.serving import Request, ServingEngine

    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    model = LlamaForCausalLM(LlamaConfig(num_layers=args.layers),
                             dtype=torch.bfloat16, device="cuda", seed=0)
    if args.int8_weights:
        quantize_model(model)
    r = np.random.RandomState(0)
    out = {"layers": args.layers, "prompt": args.prompt, "rows": args.rows,
           "int8_weights": args.int8_weights}
    with torch.no_grad():
        for cache in (torch.bfloat16, torch.int8):
            reps = []
            for _ in range(3):
                eng = ServingEngine(model, max_slots=8, block_tokens=128,
                                    max_seq_len=2048, cache_dtype=cache)
                acc = {}
                eng._prefill = timed(eng._prefill, acc, "prefill_ms")
                eng._host_blocks = timed(eng._host_blocks, acc,
                                         "host_copies_ms")
                prompts = [r.randint(0, model.cfg.vocab_size, args.prompt)
                           for _ in range(args.rows)]
                for p in prompts:
                    eng.submit(Request(p, max_new_tokens=16))
                timed(eng._admit, acc, "admit_ms")()
                ids = torch.tensor(np.stack(prompts), device="cuda")
                kv = model.init_cache(args.rows, args.prompt,
                                      dtype=torch.bfloat16)
                timed(lambda: model(ids, cache=kv, start_pos=0), acc,
                      "forward_ms")()
                reps.append(acc)
                eng.close()
                del eng, kv
            out[str(cache).split(".")[-1]] = {
                "first": reps[0], "best": {k: min(a[k] for a in reps)
                                           for k in reps[0]}}
        blk = torch.randn((args.layers, 128, 2 * model.cfg.kv_heads
                           * model.cfg.head_dim), device="cuda").bfloat16()
        gb = 16 * blk.numel() * blk.element_size() / 1e9

        def rate(make):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keep = [make().copy_(blk) for _ in range(16)]
            torch.cuda.synchronize()
            return gb / (time.perf_counter() - t0), keep

        empty = lambda pin: (lambda: torch.empty(blk.shape, dtype=blk.dtype,
                                                 pin_memory=pin))
        out["copy_gb_per_s"] = {"pageable_fresh": rate(empty(False))[0]}
        out["copy_gb_per_s"]["pinned_fresh"], keep = rate(empty(True))
        del keep               # back to the pinned allocator's cache
        out["copy_gb_per_s"]["pinned_reused"] = rate(empty(True))[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
