"""Inference: KV-cache generation (port of ``paddle_tpu/inference/__init__.py``).

``generate`` prefills the prompt through the layered cache forward (the
flash-attention kernel on the card), then decodes one token per step: on
the fused path through ``fused_decode_step`` (the fused decode kernel on
the card) over the flat (L, b, S, 2·nkv·hd) cache, on the layered path
through the model's cache forward. PyTorch runs eagerly, so the decode loop
is a Python loop where the reference has one jitted ``lax.scan``.

Sampling matches the reference token for token: row r draws token t from
``fold_in(PRNGKey(request_seeds[r]), t)`` through the threefry2x32 port in
``core/rng.py``, with greedy, temperature, top-k and rank-based top-p.
"""

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import rng


def _greedy_argmax(logits):
    """argmax over the vocab, first occurrence on ties (as jnp.argmax and
    the reference's two-stage form)."""
    return torch.argmax(logits, dim=-1)


def _filter_logits(logits, top_k=0, top_p=1.0):
    """Top-k / nucleus (top-p) filtering of (b, vocab) fp32 logits.

    The top-p cutoff is RANK-based: the kept set is exactly the smallest
    prefix of the (stable) descending sort whose cumulative probability
    reaches top_p, and rank 0 is always kept (``inference/__init__.py:51``
    of the reference)."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        keep_sorted[..., 0] = True
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = torch.where(keep, logits, float("-inf"))
    return logits


def _sample_logits(logits, key, temperature=1.0, top_k=0, top_p=1.0):
    """logits (b, vocab) → token ids (b,). Greedy when temperature == 0.
    ``key`` is one key (2,) — a shared stream over the batch — or (b, 2)
    per-row keys."""
    if temperature == 0.0:
        return _greedy_argmax(logits)
    logits = _filter_logits(logits.float() / temperature, top_k, top_p)
    return rng.categorical(key, logits)


def _row_keys(seeds):
    """(b,) request seeds → (b, 2) per-row base keys."""
    return rng.PRNGKey(seeds)


def _fold_rows(keys, t):
    """Fold a token index into each row's base key: a Python int t for
    every row (generate), or a (b,) tensor of per-row counts against (b, 2)
    keys (the serving engine's step), which stays on the keys' device."""
    return rng.fold_in(keys, t)


def _request_seeds(request_seeds, seed, b, device=None):
    """(b,) uint32 per-request seeds (as int64) — explicit streams, or the
    default ``seed + row`` convention of the reference."""
    if request_seeds is not None:
        s = torch.as_tensor(np.asarray(request_seeds, np.uint32)
                            .astype(np.int64), device=device)
    else:
        s = (int(seed) + torch.arange(b, dtype=torch.int64,
                                      device=device)) & 0xFFFFFFFF
    if tuple(s.shape) != (b,):
        raise ValueError(f"request_seeds must be ({b},), got {tuple(s.shape)}")
    return s


def stack_cache(cache):
    """Layered per-layer {'k','v'} (b, S, nkv, hd) caches → the fused flat
    (L, b, S, 2·nkv·hd) layout, k in lanes [0, nkv·hd)."""
    b, total = cache[0]["k"].shape[:2]
    return torch.stack([torch.cat([c["k"].reshape(b, total, -1),
                                   c["v"].reshape(b, total, -1)], dim=-1)
                        for c in cache])


def prefill(model, input_ids, total, cache_dtype=torch.bfloat16,
            fused=False):
    """Prompt forward through a fresh cache of length `total`. Returns
    (logits (b, prompt, vocab), cache): the layered cache list, or the flat
    stacked cache when `fused`."""
    b = input_ids.shape[0]
    cache = model.init_cache(b, total, dtype=cache_dtype)
    out, cache = model(input_ids, cache=cache, start_pos=0)
    if fused:
        kv = stack_cache(cache)
        del cache
        return out, kv
    return out, cache


def generate(model, input_ids, max_new_tokens=32, temperature=0.0, top_k=0,
             top_p=1.0, eos_token_id: Optional[int] = None, seed: int = 0,
             cache_dtype=torch.bfloat16, deadline_s: Optional[float] = None,
             request_seeds=None, return_lengths: bool = False,
             _kv_chunk: int = 0):
    """Autoregressive generation with a preallocated KV cache.

    Runs on the model's device. Returns (b, prompt+new) token ids (int64,
    on that device) including the prompt; after an eos every later token of
    that row is eos, and columns where every row is past its eos are
    trimmed. ``return_lengths=True`` also returns the per-row generated
    length (tokens before the first eos) as an int32 numpy array.

    ``cache_dtype=torch.int8`` is the int8 KV-cache decode mode: the
    prompt prefills in bf16 (the calibration pass), the stacked cache is
    quantized with per-(layer, kv head) scales (``quantize_kv_cache``), and
    every decode step reads int8 KV. It needs the fused plan (llama and gpt;
    ValueError otherwise). A weight-only int8 model
    (``quantization.quantize_model``) decodes on its int8 stacks with
    either cache.

    Not ported yet (they raise NotImplementedError): ``deadline_s`` and the
    OOM degradation ladder (``_kv_chunk``) — ROADMAP Queue A item 6.
    """
    from paddle_tpu_torch.core.flags import flag

    if deadline_s is not None:
        raise NotImplementedError(
            "deadline_s is not ported yet (ROADMAP Queue A item 6)")
    if _kv_chunk:
        raise NotImplementedError(
            "the OOM degradation ladder (_kv_chunk) is not ported yet "
            "(ROADMAP Queue A item 6)")
    dev = model.device
    input_ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(dev, torch.int64)
    b, prompt_len = input_ids.shape
    total = prompt_len + max_new_tokens
    state = model.state_dict(include_buffers=False)
    plan = (model.fused_decode_plan(state, probe=True)
            if flag("FLAGS_fused_decode")
            and hasattr(model, "fused_decode_plan") else None)
    if plan is not None and b > plan.get("max_batch", b):
        plan = None     # e.g. MoE: no drops only while b <= capacity
    kv_int8 = cache_dtype == torch.int8
    if plan is not None and not kv_int8 \
            and torch.empty((), dtype=cache_dtype).element_size() != 2:
        plan = None     # an fp32 cache rides the layered path (reference)
    if kv_int8 and plan is None:
        raise ValueError(
            "cache_dtype=int8 requires the fused decode path (an eligible "
            "fused_decode_plan); this model/config cannot ride it")
    if plan is not None:
        total = -(-total // 128) * 128
    eos = -1 if eos_token_id is None else int(eos_token_id)
    seeds0 = _request_seeds(request_seeds, seed, b, device=dev)

    with torch.inference_mode():
        # the int8 mode prefills in bf16: the calibration pass
        out, cache = prefill(model, input_ids, total,
                             torch.bfloat16 if kv_int8 else cache_dtype,
                             fused=plan is not None)
        keys = _row_keys(seeds0)
        tok = _sample_logits(out[:, -1, :], _fold_rows(keys, 0),
                             temperature, top_k, top_p)
        del out
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        toks = [tok]
        kv_scales = None
        if plan is not None:
            from paddle_tpu_torch.ops import rope as rope_ops
            from paddle_tpu_torch.ops.fused_decode import (fused_decode_step,
                                                          quantize_kv_cache)
            plan = model.fused_decode_plan(state)
            blocks = plan["blocks"]
            if kv_int8:
                cache, kv_scales = quantize_kv_cache(cache,
                                                     plan["num_kv_heads"])
                blocks = dict(blocks, cache_wbytes=1)
            cos_tab, sin_tab = rope_ops.rope_cos_sin(
                total, plan["head_dim"], base=plan["rope_base"], device=dev)
        for i in range(1, max_new_tokens):
            finished = finished | (tok == eos)
            # greedy draws no randomness: skip the per-step key fold
            ki = _fold_rows(keys, i) if temperature != 0.0 else None
            pos = prompt_len + i - 1
            if plan is not None:
                x = plan["embed"](tok, pos)
                x, cache = fused_decode_step(
                    x, plan["params"], cache, pos, cos_tab[pos:pos + 1],
                    sin_tab[pos:pos + 1], num_heads=plan["num_heads"],
                    num_kv_heads=plan["num_kv_heads"], eps=plan["eps"],
                    arch=plan.get("arch", "llama"),
                    top_k=plan.get("top_k", 2), blocks=blocks,
                    kv_scales=kv_scales)
                logits = plan["head"](x)
            else:
                logits, cache = model(tok[:, None], cache=cache,
                                      start_pos=pos)
                logits = logits[:, -1, :]
            nxt = _sample_logits(logits, ki, temperature, top_k, top_p)
            nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
            toks.append(nxt)
            tok = nxt
        new_tokens = torch.stack(toks, dim=1)
    if eos_token_id is not None:
        arr = new_tokens.cpu().numpy()
        hit = arr == eos_token_id
        gen_len = np.where(hit.any(axis=1), hit.argmax(axis=1),
                           arr.shape[1]).astype(np.int32)
        done = np.cumsum(hit, axis=1) > 1
        keep = int((~done.all(axis=0)).sum())
        new_tokens = new_tokens[:, :max(keep, 1)]
    else:
        gen_len = np.full(new_tokens.shape[0], new_tokens.shape[1], np.int32)
    ids = torch.cat([input_ids, new_tokens], dim=1)
    return (ids, gen_len) if return_lengths else ids
