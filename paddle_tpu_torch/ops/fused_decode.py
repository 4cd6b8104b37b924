"""Fused decode step — the fused_multi_transformer analog, llama and gpt
archs.

Port of ``paddle_tpu/ops/fused_decode.py`` for the contiguous KV cache and
the paged pool:

* ``build_fused_params`` — stack a llama state dict into per-layer arrays
  {ln1, wqkv, wo, ln2, wg, wu, wd} (q|k|v fused along the output dim);
  ``build_fused_params_gpt`` — a GPT state dict into {ln1, ln1_b, wqkv,
  bqkv, wo, bo, ln2, ln2_b, wg, bg, wd, bd}.
* ``fused_decode_reference`` — the plain version, arch llama, gpt
  (LayerNorm with bias, biases on all four products, no rope, tanh-GELU
  FFN without an up-projection) or moe.
* ``fused_decode_step`` — the dispatch: CPU tensors take the plain version,
  CUDA tensors the hand-written kernel ``csrc/fused_decode.cu`` (K2,
  replaces the TPU kernel ``_fused_decode_pallas``,
  ``paddle_tpu/ops/fused_decode.py:555``; its gpt mode the same kernel's
  ``fused_decode_gpt``).
* ``paged_pool_shape``, ``fused_paged_decode_reference``,
  ``fused_paged_decode_step`` — the same step over the serving engine's
  paged pool (L, NB, BT, 2*nkv*hd) through per-row block tables and
  positions; CUDA tensors launch K5 (``fused_paged_decode_cuda``, same
  source file; replaces ``_fused_paged_decode_pallas``, :1884).
  ``paged_block_gather`` / ``paged_block_scatter`` move whole blocks.
* ``fused_paged_verify_reference``, ``fused_paged_verify_step`` —
  speculative decoding's scoring pass: a K1-token tail per row through the
  stack over the paged pool, the K1 appends in place, per-query causal
  limits; CUDA tensors launch K7 (``fused_paged_verify_cuda``, same source
  file; replaces ``_fused_paged_verify_pallas``, :2642).
* ``build_fused_params_moe``, ``fused_decode_reference(arch="moe")``,
  ``fused_decode_moe_cuda`` — the MoE step (llama attention, top-k router,
  routed-expert SwiGLU, optional shared experts) over the flat cache; CUDA
  tensors launch K6 (``fused_decode_moe`` in the same source file;
  replaces ``_fused_decode_moe_pallas``, :1049).
* ``row_groups``, ``in_row_groups`` — a step with more rows than one
  kernel launch takes runs as consecutive launches over groups of rows (K2,
  K5: ``GROUP_ROWS``; K7: whole slots of K1 tail rows within
  ``GROUP_ROWS``; K6: ``MOE_MAX_ROWS`` rows and ``MOE_MAX_PAIRS`` (row,
  choice) pairs), so no wrapper caps the batch: the reference takes any.
* ``decode_block_plan`` — kept for its ``ffn_pad`` and ``cache_wbytes``
  keys. ``dynamic_smem_bytes`` gives the kernels' shared-memory requests,
  which a caller can hold to the probed budget (``ops/smem_probe.py``).
* The int8 modes (reference :235-287, :353, :437-474, :1824-1846,
  :2579-2594): ``build_fused_params`` of a weight-only int8 state gives
  int8 stacks with per-out-channel scale rows (llama), ``quantize_kv_cache``
  an int8 cache with per-(layer, kv head) scales (llama, gpt and moe);
  both ride K2 (``fused_decode_cuda``), the cache also K6
  (``fused_decode_moe_cuda``), and the plain version. The paged steps
  take the int8 weights (llama) and an int8 pool with per-ROW scales
  ``kv_scales`` (L, b, 2*nkv*hd) fp32 — a serving slot calibrates its own
  — on K5, K7 and their plain versions.

K5 and K7 take arch llama and gpt, as the reference's paged steps do.

The KV cache is COMBINED and FLAT, (L, b, S, 2*nkv*hd) with k in lanes
[0, nkv*hd). Unlike the JAX functions, every version here updates the cache
or pool in place (a 7B cache is gigabytes) and returns it.

RoPE: both versions take the cos/sin row of ``pos`` from ``rope_cos_sin``,
as ``fused_decode_reference`` does, so rope costs the kernel no tolerance
against the plain version. (The TPU kernel derives the angles in-kernel,
``fused_decode.py:729-736``, which agrees with the table to a few ulp of the
angle.) The gpt arch takes no rope: its cos/sin arguments are ignored and
may be None.
"""

import ctypes
import math
from typing import Dict, Optional

import torch

from paddle_tpu_torch.ops import _build

NEG_INF = -1e30


def decode_block_plan(h: int, dqkv: int, dq: int, hd: int, ffn: int,
                      cache_wbytes: int = 2) -> Dict:
    """The TPU plan picks VMEM column blocks and pads the FFN to them; that
    has no meaning on Hopper. Kept: ``ffn_pad``, unpadded (= ffn), and
    ``cache_wbytes`` (1 = the int8 cache) for the consistency check."""
    return {"ffn_pad": ffn, "cache_wbytes": cache_wbytes}


#: the int8 weight stacks, each with a scale row stack "<key>_s"
_SCALED_KEYS = ("wqkv", "wo", "wg", "wu", "wd")


def build_fused_params(state: Dict[str, torch.Tensor], num_layers: int,
                       prefix: str = "model.layers.",
                       ffn_pad: int = 0) -> Dict[str, torch.Tensor]:
    """Stack a Llama-style flat state dict into per-layer-stacked arrays:
    {ln1 (L,h), wqkv (L,h,(nh+2nkv)*hd), wo (L,nh*hd,h), ln2 (L,h),
    wg (L,h,ffn), wu (L,h,ffn), wd (L,ffn,h)}. ``ffn_pad`` > ffn zero-pads
    the FFN (SwiGLU pad columns contribute silu(0)*0 = 0 exactly).

    A weight-only int8 state (``quantization``: ``weight_q`` +
    ``weight_scale`` keys) gives int8 weight stacks plus per-out-channel
    fp32 scale rows {wqkv_s (L,1,dqkv), wo_s, wg_s, wu_s, wd_s} that scale
    the products' outputs (reference ``fused_decode.py:235-287``)."""
    int8 = f"{prefix}0.self_attn.q_proj.weight_q" in state

    def layer(i, name):
        if int8:
            return (state[f"{prefix}{i}.{name}.weight_q"],
                    state[f"{prefix}{i}.{name}.weight_scale"])
        return state[f"{prefix}{i}.{name}.weight"], None

    g = lambda i, n: state[f"{prefix}{i}.{n}"]
    cols = {k: [] for k in ("ln1", "wqkv", "wo", "ln2", "wg", "wu", "wd")}
    scales = {k: [] for k in _SCALED_KEYS}
    for i in range(num_layers):
        qkv = [layer(i, f"self_attn.{n}_proj") for n in ("q", "k", "v")]
        ws = {"wqkv": (torch.cat([w for w, _ in qkv], dim=1),
                       torch.cat([sc for _, sc in qkv]) if int8 else None),
              "wo": layer(i, "self_attn.o_proj"),
              "wg": layer(i, "mlp.gate_proj"), "wu": layer(i, "mlp.up_proj"),
              "wd": layer(i, "mlp.down_proj")}
        cols["ln1"].append(g(i, "input_layernorm.weight"))
        cols["ln2"].append(g(i, "post_attention_layernorm.weight"))
        for k, (w, sc) in ws.items():
            cols[k].append(w)
            scales[k].append(sc)
    out = {k: torch.stack(v) for k, v in cols.items()}
    if int8:
        for k, v in scales.items():
            out[f"{k}_s"] = torch.stack(v).float()[:, None, :]
    ffn = out["wg"].shape[2]
    if ffn_pad > ffn:
        p = ffn_pad - ffn
        out["wg"] = torch.nn.functional.pad(out["wg"], (0, p))
        out["wu"] = torch.nn.functional.pad(out["wu"], (0, p))
        out["wd"] = torch.nn.functional.pad(out["wd"], (0, 0, 0, p))
        for k in ("wg_s", "wu_s"):      # pad weights are 0: scale inert
            if k in out:
                out[k] = torch.nn.functional.pad(out[k], (0, p), value=1.0)
    return out


def build_fused_params_gpt(state: Dict[str, torch.Tensor], num_layers: int,
                           prefix: str = "gpt.h.") -> Dict[str, torch.Tensor]:
    """GPT-block stacks (reference ``fused_decode.py:288``): LayerNorm scale
    and bias, the qkv weight already packed (L, h, 3h) as q|k|v, biases on
    every product, one GELU FFN (wg = fc_in, wd = fc_out, no wu)."""
    g = lambda i, n: state[f"{prefix}{i}.{n}"]
    names = {"ln1": "ln_1.weight", "ln1_b": "ln_1.bias",
             "wqkv": "attn.qkv_proj.weight", "bqkv": "attn.qkv_proj.bias",
             "wo": "attn.out_proj.weight", "bo": "attn.out_proj.bias",
             "ln2": "ln_2.weight", "ln2_b": "ln_2.bias",
             "wg": "fc_in.weight", "bg": "fc_in.bias",
             "wd": "fc_out.weight", "bd": "fc_out.bias"}
    return {k: torch.stack([g(i, n) for i in range(num_layers)])
            for k, n in names.items()}


def build_fused_params_moe(state: Dict[str, torch.Tensor], num_layers: int,
                           prefix: str = "model.layers."
                           ) -> Dict[str, torch.Tensor]:
    """Mixtral-block stacks: llama attention (ln1/wqkv/wo) + MoE FFN.

    {ln1 (L,h), wqkv (L,h,dqkv), wo (L,dq,h), ln2 (L,h), gate (L,E,h) — the
    router weight transposed, weg/weu (L,E,h,f), wed (L,E,f,h)}, plus the
    dense shared-expert stacks {wsg/wsu (L,h,fs), wsd (L,fs,h)} when the
    model has a ``shared_mlp``. The stacks are copies of the model's
    weights (``paddle_tpu/ops/fused_decode.py:314``)."""
    g = lambda i, n: state[f"{prefix}{i}.{n}"]
    cols = {"ln1": [], "wqkv": [], "wo": [], "ln2": [], "gate": [],
            "weg": [], "weu": [], "wed": []}
    shared = f"{prefix}0.shared_mlp.gate_proj.weight" in state
    if shared:
        cols.update({"wsg": [], "wsu": [], "wsd": []})
    for i in range(num_layers):
        cols["ln1"].append(g(i, "input_layernorm.weight"))
        cols["wqkv"].append(torch.cat(
            [g(i, f"self_attn.{n}_proj.weight") for n in ("q", "k", "v")],
            dim=1))
        cols["wo"].append(g(i, "self_attn.o_proj.weight"))
        cols["ln2"].append(g(i, "post_attention_layernorm.weight"))
        cols["gate"].append(g(i, "moe.gate.proj.weight").t())
        cols["weg"].append(g(i, "moe.experts.w_gate"))
        cols["weu"].append(g(i, "moe.experts.w_up"))
        cols["wed"].append(g(i, "moe.experts.w_down"))
        if shared:
            cols["wsg"].append(g(i, "shared_mlp.gate_proj.weight"))
            cols["wsu"].append(g(i, "shared_mlp.up_proj.weight"))
            cols["wsd"].append(g(i, "shared_mlp.down_proj.weight"))
    return {k: torch.stack(v) for k, v in cols.items()}


def quantize_kv_cache(kv, num_kv_heads: int):
    """Quantize a flat KV cache (L, b, S, 2*nkv*hd) to int8 with symmetric
    per-(layer, kv head) scales calibrated from its contents (reference
    ``fused_decode.py:353``): scale = max(absmax / 127, 1e-8), replicated
    over each head's hd lanes. Returns (cache int8, scales (L, 1,
    2*nkv*hd) fp32). Runs one layer at a time, so the fp32 temporaries are
    one layer's."""
    L, b, S, dkv2 = kv.shape
    hd = dkv2 // (2 * num_kv_heads)
    q = torch.empty(kv.shape, dtype=torch.int8, device=kv.device)
    lanes = torch.empty((L, 1, dkv2), dtype=torch.float32, device=kv.device)
    for l in range(L):
        kf = kv[l].float()
        amax = kf.abs().amax(dim=(0, 1)).reshape(2 * num_kv_heads, hd)
        scales = torch.clamp(amax.amax(dim=-1) / 127.0, min=1e-8)
        lanes[l, 0] = scales.repeat_interleave(hd)
        q[l] = torch.clamp(torch.round(kf / lanes[l]), -127, 127)
    return q, lanes


def _rms(x, w, eps):
    """fp32 rms-normalize, cast to w.dtype, times w (ops.rms_norm path)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(w.dtype) * w


def _layernorm(x, w, b, eps):
    """Two-pass fp32 mean and variance, normalise, cast to w.dtype, then
    ``* w + b`` in w's dtype (the reference's ``_layernorm``, :377)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(w.dtype) * w + b


def _rope1(x, cos, sin):
    """x (b, n, hd) fp32; cos/sin (1, 1, hd)."""
    hd = x.shape[-1]
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
    return x * cos + rot * sin


def _wdot(act, w):
    """act @ w with fp32 accumulation and an fp32 result (the reference's
    preferred_element_type=float32 dot)."""
    if act.dtype == torch.float32 and w.dtype == torch.float32:
        return act @ w
    return (act.float() @ w.float())


def _refuse_unported(arch, params, row="4"):
    """The contiguous step (row 4) takes arch llama, gpt and moe (row 7),
    the paged ones (rows 5 and 6) llama and gpt, as the reference's. Int8
    weights ride the llama steps, and an int8 KV cache or pool every arch
    a step takes. The reference has no int8-weight mode for gpt or moe at
    all."""
    archs = ("llama", "gpt", "moe") if row == "4" else ("llama", "gpt")
    if arch not in archs:
        raise NotImplementedError(
            f"fused decode (ROADMAP Queue B row {row}) takes arch "
            f"{'/'.join(archs)}, got {arch!r}")
    int8_w = "wqkv_s" in params
    if int8_w and arch != "llama":
        raise NotImplementedError(
            f"fused decode arch={arch!r} takes no int8 weights: the "
            f"reference has no such mode (ROADMAP Queue B row "
            f"{'7' if arch == 'moe' else row})")


def _check_kv_mode(kv_cache, kv_scales):
    if (kv_scales is not None) != (kv_cache.dtype == torch.int8):
        raise ValueError("an int8 KV cache needs kv_scales, and kv_scales "
                         f"an int8 cache (the cache is {kv_cache.dtype})")


def _pdot(act, params, key, l):
    """act @ params[key][l] in fp32; with int8 weights the product's output
    times the per-out-channel scale row params[key + "_s"][l] (the
    reference's ``y * s`` after the full dot, :437-443)."""
    y = _wdot(act, params[key][l])
    s = params.get(f"{key}_s")
    return y if s is None else y * s[l]


def _attend(q, kl, vl, valid, scale):
    """q (b, nh, hd) fp32; kl/vl (b, S, nkv, hd) fp32; valid (b|1, 1, 1, S)
    → (b, nh·hd) fp32: masked fp32 softmax over the keys, grouped heads."""
    b, nh, hd = q.shape
    nkv = kl.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd) * scale
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, kl)
    scores = torch.where(valid, scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrs,bsgd->bgrd", probs, vl).reshape(b, nh * hd)


def _mlp_residual(xf, params, l, eps, dtype):
    """The attention-free tail of a layer: x + down(silu(gate) * up)."""
    xn2 = _rms(xf, params["ln2"][l], eps)
    gt = _pdot(xn2, params, "wg", l)
    u = _pdot(xn2, params, "wu", l)
    act = (torch.nn.functional.silu(gt) * u).to(dtype)
    return xf + _pdot(act, params, "wd", l)


def _qkv_heads(xf, params, l, eps, cos_b, sin_b, nh, nkv, arch):
    """The attention input of layer l, what the contiguous, paged and verify
    versions share: the first norm (LayerNorm with bias for gpt, RMSNorm
    otherwise), the qkv product (+ its bias for gpt), and rope on q and k
    (not for gpt). Returns q (b, nh, hd) and the append (b, 2·nkv·hd),
    fp32."""
    gpt = arch == "gpt"
    if gpt:
        xn = _layernorm(xf, params["ln1"][l], params["ln1_b"][l], eps)
    else:
        xn = _rms(xf, params["ln1"][l], eps)
    qkv = _pdot(xn, params, "wqkv", l)
    if gpt:
        qkv = qkv + params["bqkv"][l]
    b = xf.shape[0]
    hd = qkv.shape[1] // (nh + 2 * nkv)
    dq, dkv = nh * hd, nkv * hd
    q = qkv[:, :dq].reshape(b, nh, hd)
    k = qkv[:, dq:dq + dkv].reshape(b, nkv, hd)
    v = qkv[:, dq + dkv:].reshape(b, nkv, hd)
    if not gpt:
        q = _rope1(q, cos_b, sin_b)
        k = _rope1(k, cos_b, sin_b)
    return q, torch.cat([k.reshape(b, dkv), v.reshape(b, dkv)], dim=-1)


def _layer_tail(xf, attn, params, l, eps, dtype, arch, top_k=2,
                routing=None):
    """What follows the attention in layer l, shared like ``_qkv_heads``:
    the o-proj residual, then the FFN residual. gpt keeps the reference's
    order, ``xf + (o + bo)`` and ``(xf + fc_out) + bd``, with a tanh-GELU
    of ``fc_in + bg``; llama the SwiGLU, moe the routed experts."""
    o = _pdot(attn, params, "wo", l)
    if arch == "gpt":
        xf = xf + (o + params["bo"][l])
        xn2 = _layernorm(xf, params["ln2"][l], params["ln2_b"][l], eps)
        g = _wdot(xn2, params["wg"][l]) + params["bg"][l]
        act = torch.nn.functional.gelu(g, approximate="tanh").to(dtype)
        return xf + _wdot(act, params["wd"][l]) + params["bd"][l]
    xf = xf + o
    if arch == "moe":
        return _moe_residual(xf, params, l, eps, dtype, top_k, routing)
    return _mlp_residual(xf, params, l, eps, dtype)


def moe_route(xn2, gate_l, top_k, force=None):
    """The router of one layer: fp32 logits of the bf16 (or fp32) xn2
    against gate (E, h), fp32 softmax, top-k by the lowest index on ties
    (as ``lax.top_k`` and the TPU kernel's sequential argmax; a stable
    descending sort), weights renormalised with the floor at 1e-9.
    ``force`` (b, k) takes those experts instead of the top-k (their
    probabilities renormalised the same way). Returns (ids (b, k) long,
    weights (b, k) fp32, the gap between the k-th and the (k+1)-th
    probability (b,) and the (k+1)-th id (b,); inf and -1 where E == k)."""
    logits = xn2.float() @ gate_l.float().t()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = srt.indices[:, :top_k]
    vals = srt.values[:, :top_k]
    if force is not None:
        ids = force.to(device=probs.device, dtype=torch.long)
        vals = torch.gather(probs, 1, ids)
    if probs.shape[-1] > top_k:
        gap = vals[:, -1] - srt.values[:, top_k]
        nxt = srt.indices[:, top_k]
    else:
        gap = torch.full_like(vals[:, -1], float("inf"))
        nxt = torch.full_like(ids[:, -1], -1)
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return ids, vals, gap, nxt


def _moe_residual(xf, params, l, eps, dtype, top_k, routing):
    """The MoE tail of a layer (``fused_decode.py:493-528`` of the
    reference): x + Σ_c w_c · expert_c(xn2) [+ shared(xn2)]."""
    xn2 = _rms(xf, params["ln2"][l], eps).to(dtype)
    force = routing.get("force_ids") if routing is not None else None
    ids, vals, gap, nxt = moe_route(
        xn2, params["gate"][l], top_k,
        None if force is None else force[l])
    if routing is not None:
        for key, val in (("ids", ids), ("w", vals), ("gap", gap),
                         ("next", nxt)):
            routing.setdefault(key, []).append(val)
    xn2f = xn2.float()
    d = []
    for c in range(top_k):
        e = ids[:, c]
        g = torch.einsum("bh,bhf->bf", xn2f, params["weg"][l][e].float())
        u = torch.einsum("bh,bhf->bf", xn2f, params["weu"][l][e].float())
        act = (torch.nn.functional.silu(g) * u).to(dtype)
        d.append(torch.einsum("bf,bfh->bh", act.float(),
                              params["wed"][l][e].float()))
    xf = xf + torch.einsum("bk,bkh->bh", vals, torch.stack(d, dim=1))
    if "wsg" in params:       # DeepSeekMoE shared experts: dense SwiGLU
        sg = _wdot(xn2, params["wsg"][l])
        su = _wdot(xn2, params["wsu"][l])
        sact = (torch.nn.functional.silu(sg) * su).to(dtype)
        xf = xf + _wdot(sact, params["wsd"][l])
    return xf


def _rope_rows(cos, sin, b, hd, arch):
    """cos/sin as (b, 1, hd) fp32 rows, or (None, None) for gpt (no rope)."""
    if arch == "gpt":
        return None, None
    return (cos.reshape(b, 1, hd).float(), sin.reshape(b, 1, hd).float())


def _stack_routing(routing):
    """Per-layer routing lists → (L, b, k) / (L, b) tensors, in place."""
    if routing is not None and "ids" in routing:
        for key in ("ids", "w", "gap", "next"):
            routing[key] = torch.stack(routing[key])


def fused_decode_reference(x, params, kv_cache, pos, cos, sin, *,
                           num_heads: int, num_kv_heads: int,
                           eps: float = 1e-5, arch: str = "llama",
                           top_k: int = 2, kv_scales=None, routing=None):
    """One decode step through the whole stack; plain PyTorch.

    x (b, h); kv_cache (L, b, S, 2*nkv*hd), updated in place at `pos`;
    cos/sin (1, hd) fp32 for position `pos`. Returns (x_out (b, h),
    kv_cache). Residual stream fp32, attention over [0, pos] only, softmax
    fp32 — the reference's numerics (``fused_decode.py:406``).

    arch="gpt" (params of ``build_fused_params_gpt``): LayerNorm with bias,
    biases on the four products, no rope (cos/sin are ignored), a tanh-GELU
    FFN. arch="moe" (params of ``build_fused_params_moe``): the FFN is the
    top-``top_k`` routed experts plus the shared experts when present. A
    dict given as ``routing`` receives the router's per-layer ids (L, b, k),
    weights (L, b, k), k-th-to-(k+1)-th probability gaps (L, b) and
    (k+1)-th ids (L, b); where it holds ``force_ids`` (L, b, k), those
    experts are taken instead of each layer's top-k (a check that follows
    another router's choices).

    Int8 modes (reference :437-474): params with scale rows (``wqkv_s`` …,
    ``build_fused_params`` of a quantized state) scale each product's
    fp32 output per out channel; an int8 ``kv_cache`` with ``kv_scales``
    (L, 1, 2*nkv*hd) (``quantize_kv_cache``) takes the append as
    round(kv / scale) clipped to ±127 and dequantizes the keys and values
    it reads with the lane scales."""
    _refuse_unported(arch, params)
    _check_kv_mode(kv_cache, kv_scales)
    L, b, S, dkv2 = kv_cache.shape
    dkv = dkv2 // 2
    nh, nkv = num_heads, num_kv_heads
    hd = dkv // nkv
    dtype = x.dtype
    scale = 1.0 / math.sqrt(hd)
    cos_b, sin_b = _rope_rows(cos, sin, 1, hd, arch)
    valid = torch.arange(S, device=x.device)[None, None, None] <= pos
    xf = x.float()
    for l in range(L):
        q, kv_new = _qkv_heads(xf, params, l, eps, cos_b, sin_b, nh, nkv,
                               arch)
        if kv_scales is not None:   # quantize the append, static scales
            kv_new = torch.clamp(torch.round(kv_new / kv_scales[l]), -127,
                                 127)
        kv_cache[l, :, pos] = kv_new.to(kv_cache.dtype)
        kl = kv_cache[l, :, :, :dkv].float()
        vl = kv_cache[l, :, :, dkv:].float()
        if kv_scales is not None:   # dequantize with the per-head scales
            kl = kl * kv_scales[l, :, :dkv]
            vl = vl * kv_scales[l, :, dkv:]
        kl, vl = kl.reshape(b, S, nkv, hd), vl.reshape(b, S, nkv, hd)
        attn = _attend(q, kl, vl, valid, scale).to(dtype)
        xf = _layer_tail(xf, attn, params, l, eps, dtype, arch, top_k,
                         routing)
    _stack_routing(routing)
    return xf.to(dtype), kv_cache


_PARAM_KEYS = ("ln1", "wqkv", "wo", "ln2", "wg", "wu", "wd")
#: the gpt stacks, in the order the kernels' gpt entry points take them
_GPT_KEYS = ("ln1", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2", "ln2_b",
             "wg", "bg", "wd", "bd")


def _keys(arch):
    return _GPT_KEYS if arch == "gpt" else _PARAM_KEYS


def _check_tensors(what, specs, device):
    """Raise unless each (name, tensor, dtype, shape) of `specs` has its
    dtype (TypeError), its shape and a contiguous layout, and then unless
    all lie on the CUDA `device` (ValueError). Devices are checked last, so
    the dtype, shape and layout refusals show without a GPU."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} not contiguous")
    for name, t, _, _ in specs:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} on {t.device}, expected "
                             f"{device} (cuda)")


#: rows one launch of K2, K5 or K7 takes: the product engine's widest
#: wgmma N (``csrc/fused_decode.cu``, ``erows``). Wider steps run in groups.
GROUP_ROWS = 64


def row_groups(n: int, cap: int):
    """Consecutive (start, stop) ranges covering rows 0..n-1, in order,
    each of at most `cap` rows and as even as possible (65 rows at cap 64:
    33 + 32)."""
    if n < 1 or cap < 1:
        raise ValueError(f"row_groups: {n} rows in groups of {cap}")
    k = -(-n // cap)
    q, r = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        stop = start + q + (i < r)
        out.append((start, stop))
        start = stop
    return out


def in_row_groups(step, n: int, cap: int):
    """Run a step of `n` rows as consecutive calls ``step(slice)`` over
    ``row_groups(n, cap)``, in order on the current stream, and stack the
    outputs on dim 0. The rows of a decode, paged or verify step are
    independent through the whole stack (a row reads only its own KV, the
    pool is shared but each row writes only its own blocks or scratch), so
    grouping changes which launch a row rides in, not what it computes;
    the kernels' bits may still depend on a group's row count, through the
    product engine's split choice (``eplan``)."""
    outs = [step(slice(a, b)) for a, b in row_groups(n, cap)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _stack_specs(what, x, params, cache, num_heads, num_kv_heads,
                 arch="llama"):
    """What K2, K5 and K7 share: x (rows, h), the stacked weights of `arch`
    (llama or gpt) and the cache (contiguous or paged; its last dim is
    2·nkv·hd) in bf16, and the shapes the kernels take. The int8 modes:
    with scale rows in `params`, the five weight stacks in int8 and their
    (L, 1, out) fp32 scales; an int8 cache or pool in int8. Returns (check
    specs, (b, h, hd, ffn))."""
    L, dkv2 = cache.shape[0], cache.shape[-1]
    dkv = dkv2 // 2
    nh, nkv = num_heads, num_kv_heads
    if nkv <= 0 or dkv % nkv or nh % nkv:
        raise ValueError(f"{what}: heads {nh}/{nkv} do not divide the "
                         f"cache width {dkv2}")
    hd = dkv // nkv
    rep = nh // nkv
    b, h = x.shape
    dq = nh * hd
    ffn = params["wg"].shape[2]
    if b < 1 or hd not in (64, 128) or rep not in (1, 2, 4, 8):
        raise ValueError(f"{what}: unsupported b={b} (>= 1), "
                         f"head_dim={hd} (64|128), rep={rep} (1|2|4|8)")
    if h % 8 or ffn % 8 or (dq + 2 * dkv) % 8:
        raise ValueError(f"{what}: h, ffn and the qkv width must be "
                         "multiples of 8")
    w8 = "wqkv_s" in params
    if w8 and (h % 16 or ffn % 16 or (dq + 2 * dkv) % 16):
        # the engine's TMA map of an int8 (L, in, out) stack needs rows of
        # a multiple of 16 bytes
        raise ValueError(f"{what}: int8 weights need h, ffn and the qkv "
                         "width to be multiples of 16")
    shapes = {"ln1": (L, h), "wqkv": (L, h, dq + 2 * dkv), "wo": (L, dq, h),
              "ln2": (L, h), "wg": (L, h, ffn), "wu": (L, h, ffn),
              "wd": (L, ffn, h), "ln1_b": (L, h), "bqkv": (L, dq + 2 * dkv),
              "bo": (L, h), "ln2_b": (L, h), "bg": (L, ffn), "bd": (L, h)}
    bf = torch.bfloat16
    cdt = torch.int8 if cache.dtype == torch.int8 else bf
    specs = [("x", x, bf, (b, h)), ("cache", cache, cdt, cache.shape)]
    specs += [(k, params[k],
               torch.int8 if w8 and k in _SCALED_KEYS else bf, shapes[k])
              for k in _keys(arch)]
    if w8:
        specs += [(f"{k}_s", params[f"{k}_s"], torch.float32,
                   (L, 1, shapes[k][2])) for k in _SCALED_KEYS]
    return specs, (b, h, hd, ffn)


def _rope_specs(cos, sin, shape, arch):
    """The rope rows' check specs: none for gpt, whose kernels take none."""
    if arch == "gpt":
        return []
    return [("cos", cos, torch.float32, shape),
            ("sin", sin, torch.float32, shape)]


def _scratch(x, nh, nkv, hd, ffn, arch, ws_floats):
    """The step's scratch for the rows of x (rows, h): xf, [xn (gpt: the
    LayerNorm rows)], qkv, attn, act, then the C entry's ws of `ws_floats`
    floats."""
    b, h = x.shape
    dq, dkv = nh * hd, nkv * hd
    dev = x.device
    f32, bf = torch.float32, torch.bfloat16
    xn = [torch.empty((b, h), dtype=bf, device=dev)] if arch == "gpt" else []
    return (torch.empty((b, h), dtype=f32, device=dev), *xn,
            torch.empty((b, dq + 2 * dkv), dtype=f32, device=dev),
            torch.empty((b, dq), dtype=bf, device=dev),
            torch.empty((b, ffn), dtype=bf, device=dev),
            torch.empty(ws_floats, dtype=f32, device=dev))


def _decode_ws(lib, b, h, nh, nkv, hd, ffn, arch, span):
    """Floats of K2's / K5's workspace for a launch of b rows whose keys
    span `span` positions (K2: the cache length; K5: the table's MB·BT):
    the attention's chunk partials are sized by the span, never by the
    positions, which stay on the device."""
    fn = (lib.fused_decode_gpt_workspace if arch == "gpt"
          else lib.fused_decode_llama_workspace)
    return fn(b, h, nh, nkv, hd, ffn, span)


def _opt_ptr(t):
    """A tensor's pointer, or null for None."""
    return ctypes.c_void_p(0) if t is None else _build.ptr(t)


def _scale_rows(params, arch):
    """The five weight scale-row pointers the llama entry points take
    (null: bf16 weights); the gpt entry points take none."""
    return [] if arch == "gpt" else [_opt_ptr(params.get(f"{k}_s"))
                                     for k in _SCALED_KEYS]


def _check_arch(what, arch):
    if arch not in ("llama", "gpt"):
        raise ValueError(f"{what}: arch {arch!r} (llama|gpt)")


def fused_decode_cuda(x, params, kv_cache, pos, cos, sin, *, num_heads: int,
                      num_kv_heads: int, eps: float = 1e-5,
                      arch: str = "llama", kv_scales=None):
    """Wrapper of K2: one decode step through all L layers, arch llama
    (``fused_decode_llama``) or gpt (``fused_decode_gpt``, which takes no
    rope: cos/sin are ignored). One launch takes up to ``GROUP_ROWS`` rows
    (1 + 11L kernels on the current stream); a wider batch runs as
    consecutive launches over ``row_groups`` of rows, each reading and
    appending its rows of the cache in place. ``launches`` counts launches,
    one per group. Its int8 modes: int8 weight stacks with their scale rows
    (llama), and an int8 cache with ``kv_scales`` (L, 1, 2*nkv*hd) fp32
    (llama and gpt). Checks dtype, shape, contiguity and device and raises
    on anything else."""
    what = "fused_decode_cuda"
    _check_arch(what, arch)
    _refuse_unported(arch, params)
    _check_kv_mode(kv_cache, kv_scales)
    specs, (b, h, hd, ffn) = _stack_specs(what, x, params, kv_cache,
                                          num_heads, num_kv_heads, arch=arch)
    L, S = kv_cache.shape[0], kv_cache.shape[2]
    if kv_cache.dim() != 4 or kv_cache.shape[1] != b:
        raise ValueError(f"{what}: cache {tuple(kv_cache.shape)} is not "
                         f"(L, {b}, S, 2*nkv*hd)")
    rope = []
    if arch != "gpt":
        cos, sin = cos.reshape(hd), sin.reshape(hd)
        rope = [cos, sin]
    if kv_scales is not None:
        specs.append(("kv_scales", kv_scales, torch.float32,
                      (L, 1, kv_cache.shape[3])))
    _check_tensors(what, specs + _rope_specs(cos, sin, (hd,), arch),
                   x.device)
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"{what}: pos {pos} outside the cache length {S}")
    lib = _kernel_lib()
    p = _build.ptr
    fn = lib.fused_decode_gpt if arch == "gpt" else lib.fused_decode_llama
    weights = [p(params[k]) for k in _keys(arch)] + _scale_rows(params, arch)

    def step(rows):
        xg = x[rows]
        bg = xg.shape[0]
        x_out = torch.empty_like(xg)
        scratch = _scratch(xg, num_heads, num_kv_heads, hd, ffn, arch,
                           _decode_ws(lib, bg, h, num_heads, num_kv_heads,
                                      hd, ffn, arch, S))
        # the group's rows of the cache, in place: the layer stride stays
        # the whole cache's (cb = b rows)
        err = fn(p(xg), p(x_out), *weights, p(kv_cache[:, rows]),
                 _opt_ptr(kv_scales), *(p(t) for t in rope),
                 *(p(t) for t in scratch), L, bg, h, num_heads, num_kv_heads,
                 hd, ffn, S, b, pos, float(eps), _build.stream_of(x))
        fused_decode_cuda.launches += 1
        _build.check(err, f"fused_decode_{arch}")
        return x_out

    return in_row_groups(step, b, GROUP_ROWS), kv_cache


fused_decode_cuda.launches = 0

_MOE_KEYS = ("ln1", "wqkv", "wo", "ln2", "gate", "weg", "weu", "wed")
_SHARED_KEYS = ("wsg", "wsu", "wsd")
#: K6's bounds per launch: rows (its router and expert slots take 8) and
#: routed (row, choice) pairs; a wider step runs in groups of rows
MOE_MAX_ROWS, MOE_MAX_PAIRS = 8, 64


def fused_decode_moe_cuda(x, params, kv_cache, pos, cos, sin, *,
                          num_heads: int, num_kv_heads: int,
                          eps: float = 1e-5, top_k: int = 2, routing=None,
                          kv_scales=None):
    """Wrapper of K6: one MoE decode step through all L layers. One launch
    takes up to ``MOE_MAX_ROWS`` rows and ``MOE_MAX_PAIRS`` (row, choice)
    pairs (1 + 11L kernels, 1 + 14L with shared experts, on the current
    stream); a wider batch runs as consecutive launches over ``row_groups``
    of rows, each reading and appending its rows of the cache in place
    (the router is per row, and the fused MoE plan holds only with no
    drops, so a row's experts do not depend on the others). ``launches``
    counts launches, one per group. Checks dtype, shape, contiguity and
    device and raises on anything else. A dict given as ``routing``
    receives the kernel's per-layer ids (L, b, k) int32 and weights (L, b,
    k) fp32 (device tensors; the step itself never reads them on the
    host). Its int8 KV mode: an int8 cache with ``kv_scales`` (L, 1,
    2*nkv*hd) fp32 (``quantize_kv_cache``), as K2's; ``int8_kv`` counts
    those launches."""
    what = "fused_decode_moe_cuda"
    _check_kv_mode(kv_cache, kv_scales)
    if kv_cache.dim() != 4 or x.dim() != 2 or kv_cache.shape[1] != x.shape[0]:
        raise ValueError(f"{what}: cache {tuple(kv_cache.shape)} is not "
                         f"(L, b, S, 2*nkv*hd) for x {tuple(x.shape)}")
    L, b, S, dkv2 = kv_cache.shape
    nh, nkv = num_heads, num_kv_heads
    dkv = dkv2 // 2
    if nkv <= 0 or dkv % nkv or nh % nkv:
        raise ValueError(f"{what}: heads {nh}/{nkv} do not divide the "
                         f"cache width {dkv2}")
    hd, rep, h = dkv // nkv, nh // nkv, x.shape[1]
    E, f = params["weg"].shape[1], params["weg"].shape[3]
    shared = "wsg" in params
    fs = params["wsg"].shape[2] if shared else 0
    k = int(top_k)
    if b < 1 or not 1 <= k <= min(E, MOE_MAX_PAIRS) \
            or hd not in (64, 128) or rep not in (1, 2, 4, 8):
        raise ValueError(f"{what}: unsupported b={b} (>= 1), top_k={k} "
                         f"(<= E={E}, <= {MOE_MAX_PAIRS}), head_dim={hd} "
                         f"(64|128), rep={rep} (1|2|4|8)")
    dq = nh * hd
    if h % 8 or f % 8 or fs % 8 or (dq + 2 * dkv) % 8:
        raise ValueError(f"{what}: h, the expert widths and the qkv width "
                         "must be multiples of 8")
    shapes = {"ln1": (L, h), "wqkv": (L, h, dq + 2 * dkv), "wo": (L, dq, h),
              "ln2": (L, h), "gate": (L, E, h), "weg": (L, E, h, f),
              "weu": (L, E, h, f), "wed": (L, E, f, h), "wsg": (L, h, fs),
              "wsu": (L, h, fs), "wsd": (L, fs, h)}
    keys = _MOE_KEYS + (_SHARED_KEYS if shared else ())
    bf = torch.bfloat16
    cos = cos.reshape(hd)
    sin = sin.reshape(hd)
    cdt = torch.int8 if kv_scales is not None else bf
    scales = [] if kv_scales is None else [
        ("kv_scales", kv_scales, torch.float32, (L, 1, dkv2))]
    _check_tensors(what, [("x", x, bf, (b, h)),
                          ("cache", kv_cache, cdt, kv_cache.shape),
                          ("cos", cos, torch.float32, (hd,)),
                          ("sin", sin, torch.float32, (hd,))]
                   + [(n, params[n], bf, shapes[n]) for n in keys] + scales,
                   x.device)
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"{what}: pos {pos} outside the cache length {S}")
    lib = _kernel_lib()
    dev = x.device
    f32 = torch.float32
    p = _build.ptr
    none = ctypes.c_void_p(0)
    weights = [p(params[n]) for n in _MOE_KEYS] + (
        [p(params[n]) for n in _SHARED_KEYS] if shared else [none] * 3)
    ids, wts = [], []

    def step(rows):
        xg = x[rows]
        bg = xg.shape[0]
        x_out = torch.empty_like(xg)
        ids.append(torch.empty((L, bg, k), dtype=torch.int32, device=dev))
        wts.append(torch.empty((L, bg, k), dtype=f32, device=dev))
        scratch = (torch.empty((bg, h), dtype=f32, device=dev),        # xf
                   torch.empty((bg, dq + 2 * dkv), dtype=f32, device=dev),
                   torch.empty((bg, dq), dtype=bf, device=dev),      # attn
                   torch.empty((bg, h), dtype=bf, device=dev),       # xn2
                   torch.empty((bg * k, f), dtype=bf, device=dev),   # act
                   torch.empty((bg, max(fs, 8)), dtype=bf, device=dev),
                   torch.empty(lib.fused_decode_moe_workspace(
                       bg, h, nh, nkv, hd, k, f, fs, S), dtype=f32,
                       device=dev))
        err = lib.fused_decode_moe(
            p(xg), p(x_out), *weights, p(kv_cache[:, rows]),
            _opt_ptr(kv_scales), p(cos), p(sin),
            p(ids[-1]), p(wts[-1]), *(p(t) for t in scratch), L, bg, h, nh,
            nkv, hd, E, k, f, fs, S, b, pos, float(eps), _build.stream_of(x))
        fused_decode_moe_cuda.launches += 1
        fused_decode_moe_cuda.int8_kv += kv_scales is not None
        _build.check(err, "fused_decode_moe")
        return x_out

    x_out = in_row_groups(step, b, min(MOE_MAX_ROWS, MOE_MAX_PAIRS // k))
    if routing is not None:
        routing["ids"], routing["w"] = torch.cat(ids, 1), torch.cat(wts, 1)
    return x_out, kv_cache


fused_decode_moe_cuda.launches = 0
fused_decode_moe_cuda.int8_kv = 0     # of them, launches over an int8 cache


def _kernel_lib():
    lib = _build.library("fused_decode")
    fn = lib.fused_decode_llama
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 23 + [ci] * 10 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        pfn = lib.fused_paged_decode_llama
        pfn.argtypes = [vp] * 25 + [ci] * 11 + [ctypes.c_float, vp]
        pfn.restype = ctypes.c_int
        vfn = lib.fused_paged_verify_llama
        vfn.argtypes = [vp] * 25 + [ci] * 12 + [ctypes.c_float, vp]
        vfn.restype = ctypes.c_int
        vws = lib.fused_paged_verify_workspace
        vws.argtypes = [ci] * 9
        vws.restype = ctypes.c_long
        wsf = lib.fused_decode_llama_workspace
        wsf.argtypes = [ci] * 7
        wsf.restype = ctypes.c_long
        mfn = lib.fused_decode_moe
        mfn.argtypes = [vp] * 26 + [ci] * 13 + [ctypes.c_float, vp]
        mfn.restype = ctypes.c_int
        mws = lib.fused_decode_moe_workspace
        mws.argtypes = [ci] * 9
        mws.restype = ctypes.c_long
        gfn = lib.fused_decode_gpt
        gfn.argtypes = [vp] * 22 + [ci] * 10 + [ctypes.c_float, vp]
        gfn.restype = ctypes.c_int
        gpfn = lib.fused_paged_decode_gpt
        gpfn.argtypes = [vp] * 24 + [ci] * 11 + [ctypes.c_float, vp]
        gpfn.restype = ctypes.c_int
        gvfn = lib.fused_paged_verify_gpt
        gvfn.argtypes = [vp] * 24 + [ci] * 12 + [ctypes.c_float, vp]
        gvfn.restype = ctypes.c_int
        gws = lib.fused_decode_gpt_workspace
        gws.argtypes = [ci] * 7
        gws.restype = ctypes.c_long
        sm = lib.fused_decode_dynamic_smem
        sm.argtypes = [ci] * 4
        sm.restype = ci
    return lib


#: the kernels that opt in to dynamic shared memory, by the kind number of
#: ``fused_decode_dynamic_smem`` in the source
_SMEM_KINDS = {"attention": 0, "tensor_core_gemm": 1, "verify_attention": 2,
               "product_engine": 3}


def dynamic_smem_bytes(kernel: str, a: int, b: int = 0, c: int = 0) -> int:
    """The dynamic shared memory one block of `kernel` asks for, as its
    launcher computes it: "attention" (the split-KV attention as the
    decode steps K2, K5 and K6 launch it; a = head_dim, b = 1 over K2's
    int8 cache or pool), "tensor_core_gemm" (K6's experts; a = 16-row
    tiles), "verify_attention" (the same kernel as K7 launches it; a =
    head_dim, b = 1 over the int8 pool),
    "product_engine" (K2/K5/K7's products and K6's attention half; a = the
    rows rounded up to 8, 16, 32 or 64, b = 1 for int8 weights). Needs the
    built library (a CUDA machine)."""
    return int(_kernel_lib().fused_decode_dynamic_smem(
        _SMEM_KINDS[kernel], a, b, c))


def fused_decode_step(x, params, kv_cache, pos, cos, sin, *,
                      num_heads: int, num_kv_heads: int, eps: float = 1e-5,
                      arch: str = "llama", top_k: int = 2,
                      blocks: Optional[Dict] = None, kv_scales=None):
    """Dispatch: the CUDA kernel on CUDA tensors (K2 for arch llama and
    gpt, K6 for arch moe), the plain version on CPU tensors. Args follow
    fused_decode_reference; ``top_k`` applies to arch moe only; ``blocks``
    is checked against the cache dtype; ``kv_scales`` with an int8 cache
    selects the int8 KV mode."""
    _refuse_unported(arch, params)
    _check_plan(blocks, kv_cache)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, eps=eps)
    if arch == "moe":
        kw["top_k"] = top_k
    if x.device.type == "cpu":
        return fused_decode_reference(x, params, kv_cache, pos, cos, sin,
                                      arch=arch, kv_scales=kv_scales, **kw)
    if arch == "moe":
        return fused_decode_moe_cuda(x, params, kv_cache, pos, cos, sin,
                                     kv_scales=kv_scales, **kw)
    return fused_decode_cuda(x, params, kv_cache, pos, cos, sin, arch=arch,
                             kv_scales=kv_scales, **kw)


def _check_plan(blocks, cache):
    cb = cache.element_size()
    if blocks is not None and blocks.get("cache_wbytes", cb) != cb:
        raise ValueError(
            f"decode plan assumed a {blocks['cache_wbytes']}-byte KV cache "
            f"but the cache dtype is {cache.dtype} ({cb} B)")


# ---------------------------------------------------------------------------
# The paged pool (the serving engine's one cache tensor)
# ---------------------------------------------------------------------------
#
# (L, NB, BT, 2*nkv*hd): NB physical blocks of BT tokens, block 0 the
# scratch block every unmapped table entry points at. Row r's logical
# position t lives at pool[l, block_tables[r, t // BT], t % BT].


def paged_pool_shape(num_layers: int, num_blocks: int, block_tokens: int,
                     num_kv_heads: int, head_dim: int):
    """Shape of the paged KV pool (the serving engine's one cache tensor)."""
    return (num_layers, num_blocks, block_tokens,
            2 * num_kv_heads * head_dim)


def _refuse_unported_paged(arch, params, kv_pool, kv_scales, mp_axis,
                           row="5"):
    """What the paged steps (row 5: decode; row 6: verify) still refuse:
    an arch the reference's paged steps lack, gpt with int8 weights (no
    reference mode), ``mp_axis``, and ``kv_scales`` that do not match the
    pool's dtype (ValueError)."""
    _refuse_unported(arch, params, row=row)
    if mp_axis is not None:
        raise NotImplementedError(
            "tensor-parallel paged decode (mp_axis) is not ported yet "
            "(ROADMAP Queue A item 8)")
    _check_kv_mode(kv_pool, kv_scales)


def fused_paged_decode_reference(x, params, kv_pool, block_tables, positions,
                                 cos, sin, *, num_heads: int,
                                 num_kv_heads: int, eps: float = 1e-5,
                                 arch: str = "llama", kv_scales=None,
                                 mp_axis=None):
    """One decode step against the paged pool; plain PyTorch.

    x (b, h); kv_pool (L, NB, BT, 2*nkv*hd); block_tables (b, MB) int;
    positions (b,) int (each row's append position — the number of tokens
    already cached for it); cos/sin (b, hd) fp32 rope rows gathered at each
    row's position. Returns (x_out (b, h), kv_pool).

    Int8 modes (reference :1824-1846): params with scale rows (int8
    weights, llama) scale each product's output as the contiguous step's;
    an int8 pool takes ``kv_scales`` (L, b, 2*nkv*hd) fp32, per-ROW scales
    (a serving slot calibrates its own): each row's append is
    round(kv / its scales) clipped to ±127, and its keys and values are
    dequantized with them.

    The arithmetic is ``fused_decode_reference``'s, line for line, with the
    reference's numerics (``fused_decode.py:1742``). Unlike the reference,
    which injects each row's append into its gathered view and scatters
    once at the end, each layer writes its appends into the pool first and
    then gathers: the values an active row attends over are the same (its
    append block is private), and it is what K5 does. Rows whose table is
    all scratch are idle: their appends land in block 0, their output is
    meaningless, and where several idle rows write one scratch address the
    last write wins.
    """
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, mp_axis)
    BT = kv_pool.shape[2]
    tables = block_tables.to(x.device, torch.long)
    pos = positions.to(x.device, torch.long)
    app_bid = torch.gather(tables, 1, (pos // BT)[:, None])[:, 0]
    x_out = _paged_token(x, params, kv_pool, tables, pos, app_bid, pos % BT,
                         cos, sin, num_heads, num_kv_heads, eps, arch,
                         kv_scales)
    return x_out, kv_pool


def _paged_token(x, params, kv_pool, tables, pos, app_bid, app_off, cos,
                 sin, nh, nkv, eps, arch, kv_scales=None):
    """One token row block (b, h) through every layer over the paged pool:
    the body of ``fused_paged_decode_reference``, which the verify twin
    runs once per tail token. tables (b, MB) and pos (b,) are long tensors
    on x's device; each layer writes its appends at (app_bid, app_off) and
    then gathers the rows' logical views, keys masked to ``<= pos``; the
    int8 pool quantizes the appends and dequantizes the views with each
    row's ``kv_scales`` (L, b, 2*nkv*hd)."""
    L, NB, BT, dkv2 = kv_pool.shape
    b, MB = tables.shape
    S = MB * BT
    dkv = dkv2 // 2
    hd = dkv // nkv
    dtype = x.dtype
    scale = 1.0 / math.sqrt(hd)
    dev = x.device
    cos_b, sin_b = _rope_rows(cos, sin, b, hd, arch)
    valid = (torch.arange(S, device=dev)[None] <= pos[:, None])[:, None, None]
    xf = x.float()
    for l in range(L):
        q, kv_new = _qkv_heads(xf, params, l, eps, cos_b, sin_b, nh, nkv,
                               arch)
        if kv_scales is not None:   # quantize with each row's own scales
            kv_new = torch.clamp(torch.round(kv_new / kv_scales[l]), -127,
                                 127)
        kv_pool[l, app_bid, app_off] = kv_new.to(kv_pool.dtype)
        kvl = kv_pool[l][tables].reshape(b, S, dkv2)
        kl = kvl[:, :, :dkv].float()
        vl = kvl[:, :, dkv:].float()
        if kv_scales is not None:   # dequantize per row
            kl = kl * kv_scales[l][:, None, :dkv]
            vl = vl * kv_scales[l][:, None, dkv:]
        kl, vl = kl.reshape(b, S, nkv, hd), vl.reshape(b, S, nkv, hd)
        attn = _attend(q, kl, vl, valid, scale).to(dtype)
        xf = _layer_tail(xf, attn, params, l, eps, dtype, arch)
    return xf.to(dtype)


def _paged_specs(block_tables, positions, kv_scales, kv_pool, b):
    """What K5 and K7 check beside the stacks: the (b, MB) block tables and
    (b,) positions, int32, and an int8 pool's per-row kv scales (L, b,
    2*nkv*hd) fp32, contiguous."""
    specs = [("block_tables", block_tables, torch.int32,
              (b, block_tables.shape[1])),
             ("positions", positions, torch.int32, (b,))]
    if kv_scales is not None:
        specs.append(("kv_scales", kv_scales, torch.float32,
                      (kv_pool.shape[0], b, kv_pool.shape[3])))
    return specs


def _rows_scales(kv_scales, rows):
    """The kv scales' pointer for a launch over `rows` (a slice): the first
    row's scales in layer 0; the kernel strides layers by the whole step's
    row count (its ``sb``), so the group's rows are read in place."""
    return _opt_ptr(None if kv_scales is None else kv_scales[:, rows])


def fused_paged_decode_cuda(x, params, kv_pool, block_tables, positions, cos,
                            sin, *, num_heads: int, num_kv_heads: int,
                            eps: float = 1e-5, arch: str = "llama",
                            kv_scales=None):
    """Wrapper of K5: one decode step through all L layers over the paged
    pool, arch llama or gpt (no rope: cos/sin are ignored). One launch
    takes up to ``GROUP_ROWS`` rows (1 + 11L kernels on the current
    stream); a wider batch runs as consecutive launches over
    ``row_groups`` of rows (their x, tables, positions, rope rows and kv
    scales; the pool is shared). ``launches`` counts launches, one per
    group. Its int8 modes: int8 weight stacks with their scale rows
    (llama), and an int8 pool with per-row ``kv_scales`` (L, b, 2*nkv*hd)
    fp32 (llama and gpt). Checks dtype, shape, contiguity and device and
    raises on anything else. Positions and tables are read on the device,
    never on the host: the caller keeps every position below MB·BT. An
    idle row's append (its block is scratch block 0) is not written; its
    output is garbage, as the plain version's."""
    what = "fused_paged_decode_cuda"
    _check_arch(what, arch)
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, None)
    if kv_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{what}: pool {tuple(kv_pool.shape)} must be "
                         "(L, NB, BT, 2*nkv*hd) and block_tables (b, MB)")
    specs, (b, h, hd, ffn) = _stack_specs(what, x, params, kv_pool,
                                          num_heads, num_kv_heads, arch=arch)
    L, NB, BT, _ = kv_pool.shape
    MB = block_tables.shape[1]
    _check_tensors(what, specs + _paged_specs(
        block_tables, positions, kv_scales, kv_pool, b)
        + _rope_specs(cos, sin, (b, hd), arch), x.device)
    lib = _kernel_lib()
    p = _build.ptr
    fn = (lib.fused_paged_decode_gpt if arch == "gpt"
          else lib.fused_paged_decode_llama)
    weights = [p(params[k]) for k in _keys(arch)] + _scale_rows(params, arch)

    def step(rows):
        xg = x[rows]
        bg = xg.shape[0]
        x_out = torch.empty_like(xg)
        scratch = _scratch(xg, num_heads, num_kv_heads, hd, ffn, arch,
                           _decode_ws(lib, bg, h, num_heads, num_kv_heads,
                                      hd, ffn, arch, MB * BT))
        rope = [] if arch == "gpt" else [cos[rows], sin[rows]]
        err = fn(p(xg), p(x_out), *weights, p(kv_pool),
                 _rows_scales(kv_scales, rows), p(block_tables[rows]),
                 p(positions[rows]), *(p(t) for t in rope),
                 *(p(t) for t in scratch), L, bg, h, num_heads,
                 num_kv_heads, hd, ffn, NB, BT, MB, b, float(eps),
                 _build.stream_of(x))
        fused_paged_decode_cuda.launches += 1
        _build.check(err, f"fused_paged_decode_{arch}")
        return x_out

    return in_row_groups(step, b, GROUP_ROWS), kv_pool


fused_paged_decode_cuda.launches = 0


def fused_paged_decode_step(x, params, kv_pool, block_tables, positions,
                            cos, sin, *, num_heads: int, num_kv_heads: int,
                            eps: float = 1e-5, arch: str = "llama",
                            blocks: Optional[Dict] = None, kv_scales=None,
                            mp_axis=None):
    """Dispatch one PAGED decode step: K5 on CUDA tensors, the plain
    version on CPU tensors. Args follow ``fused_paged_decode_reference``;
    ``blocks`` is checked against the pool dtype; ``kv_scales`` with an
    int8 pool selects the int8 pool mode."""
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, mp_axis)
    _check_plan(blocks, kv_pool)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, eps=eps,
              arch=arch, kv_scales=kv_scales)
    if x.device.type == "cpu":
        return fused_paged_decode_reference(
            x, params, kv_pool, block_tables, positions, cos, sin, **kw)
    return fused_paged_decode_cuda(x, params, kv_pool, block_tables,
                                   positions, cos, sin, **kw)


# ---------------------------------------------------------------------------
# The paged verify step (speculative decoding's scoring pass)
# ---------------------------------------------------------------------------


def _verify_appends(tables, pos, BT):
    """(block, offset) of each row's append at positions pos (b,): a
    position whose block index reaches MB lands in scratch block 0 (the
    over-speculation tail, garbage by contract). The table is never read
    at MB or beyond."""
    MB = tables.shape[1]
    cb = pos // BT
    bid = torch.gather(tables, 1, torch.clamp(cb, max=MB - 1)[:, None])[:, 0]
    return torch.where(cb < MB, bid, 0), pos % BT


def fused_paged_verify_reference(x, params, kv_pool, block_tables, positions,
                                 cos, sin, *, num_heads: int,
                                 num_kv_heads: int, eps: float = 1e-5,
                                 arch: str = "llama", kv_scales=None,
                                 mp_axis=None):
    """Score a K1-token tail per row against the paged pool; plain PyTorch.

    x (b, K1, h): x[:, j] is tail token j embedded at ``positions + j``;
    cos/sin (b, K1, hd) the matching rope rows. kv_pool, block_tables and
    positions as in ``fused_paged_decode_reference`` (``positions`` is each
    row's append position for tail token 0). Returns (x_out (b, K1, h),
    kv_pool) with every tail token's KV appended at [pos, pos + K1), in
    place.

    Token j runs ``fused_paged_decode_reference``'s per-token math at
    ``positions + j`` (the reference's contract, ``fused_decode.py:2489``),
    one (b, h) row block at a time, tokens outer and layers inner: each
    layer writes the token's appends into the pool and then gathers, so
    query j sees tail tokens < j and not > j. An all-accepted verify is
    therefore bitwise K1 sequential plain paged steps. Positions whose
    block index reaches MB append to scratch block 0. The int8 modes are
    the paged decode's (reference :2579-2594): every tail append of a row
    is quantized with that row's ``kv_scales``.
    """
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, mp_axis,
                           row="6")
    b, K1, h = x.shape
    BT = kv_pool.shape[2]
    tables = block_tables.to(x.device, torch.long)
    pos0 = positions.to(x.device, torch.long)
    outs = []
    for j in range(K1):
        pos = pos0 + j
        app_bid, app_off = _verify_appends(tables, pos, BT)
        outs.append(_paged_token(
            x[:, j].contiguous(), params, kv_pool, tables, pos, app_bid,
            app_off, None if cos is None else cos[:, j],
            None if sin is None else sin[:, j], num_heads, num_kv_heads,
            eps, arch, kv_scales))
    return torch.stack(outs, dim=1), kv_pool


def in_tail_chunks(step, x, positions, cos, sin, cap: int = GROUP_ROWS):
    """Run a verify step of a K1-token tail as consecutive calls
    ``step(x_c, positions + a, cos_c, sin_c)`` over the chunks [a, b) of
    ``row_groups(K1, cap)`` tail tokens, in order on the current stream,
    and join the outputs on dim 1 (x (b, K1, h); cos/sin (b, K1, hd) or
    None). Each chunk appends its tokens' KV to the shared pool before the
    next reads it, so tail token j of a later chunk sees the appends of
    every token before it, as a whole-tail verify does (the plain verify
    runs token by token: chunked and whole give the same bits)."""
    sub = lambda t, a, b: None if t is None else t[:, a:b].contiguous()
    outs = [step(sub(x, a, b), positions + a, sub(cos, a, b),
                 sub(sin, a, b))
            for a, b in row_groups(x.shape[1], cap)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def fused_paged_verify_cuda(x, params, kv_pool, block_tables, positions,
                            cos, sin, *, num_heads: int, num_kv_heads: int,
                            eps: float = 1e-5, arch: str = "llama",
                            kv_scales=None):
    """Wrapper of K7: one verify step through all L layers for the b·K1
    tail rows, arch llama or gpt (no rope: cos/sin are ignored). One launch
    takes whole slots, up to ``GROUP_ROWS`` tail rows (1 + 13L kernels on
    the current stream); more slots run as consecutive launches over
    ``row_groups`` of slots (their x, tables, positions, rope rows and kv
    scales; the pool is shared). A tail longer than ``GROUP_ROWS`` runs as
    consecutive verifies over chunks of at most ``GROUP_ROWS`` tail tokens
    (``in_tail_chunks``), each seeing the appends of those before it.
    ``launches`` counts launches, one per group. The int8 modes are K5's
    (``kv_scales`` (L, b, 2*nkv*hd), one row of scales a slot). Checks
    dtype, shape, contiguity and device and raises on anything else.
    Positions and tables are read on the device; tail positions whose block
    index reaches MB append to scratch block 0."""
    what = "fused_paged_verify_cuda"
    _check_arch(what, arch)
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, None, row="6")
    if x.dim() != 3 or kv_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be (b, K1, h), "
                         f"the pool (L, NB, BT, 2*nkv*hd) and block_tables "
                         "(b, MB)")
    b, K1, h = x.shape
    if b < 1 or K1 < 1:
        raise ValueError(f"{what}: b·K1 = {b}·{K1}; K7 takes b >= 1 and a "
                         "tail of at least 1 token")
    if K1 > GROUP_ROWS:
        chunk = lambda xc, pc, cc, sc: fused_paged_verify_cuda(
            xc, params, kv_pool, block_tables, pc, cc, sc,
            num_heads=num_heads, num_kv_heads=num_kv_heads, eps=eps,
            arch=arch, kv_scales=kv_scales)[0]
        return in_tail_chunks(chunk, x, positions, cos, sin), kv_pool
    if not x.is_contiguous():
        raise ValueError(f"{what}: x not contiguous")
    rows = x.view(b * K1, h)
    specs, (M, h, hd, ffn) = _stack_specs(what, rows, params, kv_pool,
                                          num_heads, num_kv_heads,
                                          arch=arch)
    L, NB, BT, _ = kv_pool.shape
    MB = block_tables.shape[1]
    _check_tensors(what, specs + _paged_specs(
        block_tables, positions, kv_scales, kv_pool, b)
        + _rope_specs(cos, sin, (b, K1, hd), arch), x.device)
    lib = _kernel_lib()
    nh, nkv = num_heads, num_kv_heads
    p = _build.ptr
    fn = (lib.fused_paged_verify_gpt if arch == "gpt"
          else lib.fused_paged_verify_llama)
    weights = [p(params[k]) for k in _keys(arch)] + _scale_rows(params, arch)

    def step(slots):
        xg = x[slots]
        bg = xg.shape[0]
        x_out = torch.empty_like(xg)
        scratch = _scratch(xg.view(bg * K1, h), nh, nkv, hd, ffn, arch,
                           lib.fused_paged_verify_workspace(
                               bg, K1, h, nh, nkv, hd, ffn, MB * BT,
                               int(arch == "gpt")))
        rope = [] if arch == "gpt" else [cos[slots], sin[slots]]
        err = fn(p(xg), p(x_out), *weights, p(kv_pool),
                 _rows_scales(kv_scales, slots), p(block_tables[slots]),
                 p(positions[slots]), *(p(t) for t in rope),
                 *(p(t) for t in scratch), L, bg, K1, h, nh, nkv, hd, ffn,
                 NB, BT, MB, b, float(eps), _build.stream_of(x))
        fused_paged_verify_cuda.launches += 1
        _build.check(err, f"fused_paged_verify_{arch}")
        return x_out

    return in_row_groups(step, b, GROUP_ROWS // K1), kv_pool


fused_paged_verify_cuda.launches = 0


def fused_paged_verify_step(x, params, kv_pool, block_tables, positions,
                            cos, sin, *, num_heads: int, num_kv_heads: int,
                            eps: float = 1e-5, arch: str = "llama",
                            blocks: Optional[Dict] = None, kv_scales=None,
                            mp_axis=None):
    """Dispatch one PAGED verify step: K7 on CUDA tensors, the plain
    version on CPU tensors. Args follow ``fused_paged_verify_reference``;
    ``blocks`` is checked against the pool dtype. The engine samples each
    tail position's token from x_out and commits the longest proposal
    prefix that matches its own stream."""
    _refuse_unported_paged(arch, params, kv_pool, kv_scales, mp_axis,
                           row="6")
    _check_plan(blocks, kv_pool)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, eps=eps,
              arch=arch, kv_scales=kv_scales)
    if x.device.type == "cpu":
        return fused_paged_verify_reference(
            x, params, kv_pool, block_tables, positions, cos, sin, **kw)
    return fused_paged_verify_cuda(x, params, kv_pool, block_tables,
                                   positions, cos, sin, **kw)


def paged_block_gather(kv_pool, bids):
    """Whole physical blocks out of the pool: (L, n, BT, 2*nkv*hd), a fresh
    tensor."""
    return kv_pool[:, bids]


def paged_block_scatter(kv_pool, bids, vals):
    """Write whole blocks (L, n, BT, 2*nkv*hd) into the pool at ``bids``,
    in place; returns the pool."""
    kv_pool[:, bids] = vals.to(kv_pool.dtype)
    return kv_pool
