"""Fused decode step — the fused_multi_transformer analog, llama arch.

Port of ``paddle_tpu/ops/fused_decode.py`` for the contiguous KV cache:

* ``build_fused_params`` — stack a llama state dict into per-layer arrays
  {ln1, wqkv, wo, ln2, wg, wu, wd} (q|k|v fused along the output dim).
* ``fused_decode_reference`` — the plain version, llama arch.
* ``fused_decode_step`` — the dispatch: CPU tensors take the plain version,
  CUDA tensors the hand-written kernel ``csrc/fused_decode.cu`` (replaces
  the TPU kernel ``_fused_decode_pallas``, ``paddle_tpu/ops/fused_decode.py:555``).
* ``decode_block_plan`` — kept for its ``ffn_pad`` key only.

The KV cache is COMBINED and FLAT, (L, b, S, 2*nkv*hd) with k in lanes
[0, nkv*hd). Unlike the JAX functions, both versions here update the cache
in place at ``pos`` (it is 2.4 GB at 7B width, b=4, S=1152) and return it.

RoPE: both versions take the cos/sin row of ``pos`` from ``rope_cos_sin``,
as ``fused_decode_reference`` does, so rope costs the kernel no tolerance
against the plain version. (The TPU kernel derives the angles in-kernel,
``fused_decode.py:729-736``, which agrees with the table to a few ulp of the
angle.)
"""

import ctypes
import math
from typing import Dict, Optional

import torch

from paddle_tpu_torch.ops import _build

NEG_INF = -1e30


def decode_block_plan(h: int, dqkv: int, dq: int, hd: int, ffn: int,
                      wbytes: int = 2, cache_wbytes: int = 2) -> Dict:
    """The TPU plan picks VMEM column blocks and pads the FFN to them; that
    has no meaning on Hopper. Only ``ffn_pad`` is kept, unpadded (= ffn),
    with ``cache_wbytes`` for the consistency check."""
    return {"ffn_pad": ffn, "cache_wbytes": cache_wbytes}


def build_fused_params(state: Dict[str, torch.Tensor], num_layers: int,
                       prefix: str = "model.layers.",
                       ffn_pad: int = 0) -> Dict[str, torch.Tensor]:
    """Stack a Llama-style flat state dict into per-layer-stacked arrays:
    {ln1 (L,h), wqkv (L,h,(nh+2nkv)*hd), wo (L,nh*hd,h), ln2 (L,h),
    wg (L,h,ffn), wu (L,h,ffn), wd (L,ffn,h)}. ``ffn_pad`` > ffn zero-pads
    the FFN (SwiGLU pad columns contribute silu(0)*0 = 0 exactly)."""
    if f"{prefix}0.self_attn.q_proj.weight_q" in state:
        raise NotImplementedError(
            "int8 weight stacks are not ported yet (ROADMAP Queue B row 4)")
    g = lambda i, n: state[f"{prefix}{i}.{n}"]
    cols = {k: [] for k in ("ln1", "wqkv", "wo", "ln2", "wg", "wu", "wd")}
    for i in range(num_layers):
        cols["ln1"].append(g(i, "input_layernorm.weight"))
        cols["wqkv"].append(torch.cat(
            [g(i, f"self_attn.{n}_proj.weight") for n in ("q", "k", "v")],
            dim=1))
        cols["wo"].append(g(i, "self_attn.o_proj.weight"))
        cols["ln2"].append(g(i, "post_attention_layernorm.weight"))
        cols["wg"].append(g(i, "mlp.gate_proj.weight"))
        cols["wu"].append(g(i, "mlp.up_proj.weight"))
        cols["wd"].append(g(i, "mlp.down_proj.weight"))
    out = {k: torch.stack(v) for k, v in cols.items()}
    ffn = out["wg"].shape[2]
    if ffn_pad > ffn:
        p = ffn_pad - ffn
        out["wg"] = torch.nn.functional.pad(out["wg"], (0, p))
        out["wu"] = torch.nn.functional.pad(out["wu"], (0, p))
        out["wd"] = torch.nn.functional.pad(out["wd"], (0, 0, 0, p))
    return out


def _rms(x, w, eps):
    """fp32 rms-normalize, cast to w.dtype, times w (ops.rms_norm path)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(w.dtype) * w


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


def fused_decode_reference(x, params, kv_cache, pos, cos, sin, *,
                           num_heads: int, num_kv_heads: int,
                           eps: float = 1e-5, arch: str = "llama",
                           kv_scales=None):
    """One decode step through the whole stack; plain PyTorch.

    x (b, h); kv_cache (L, b, S, 2*nkv*hd), updated in place at `pos`;
    cos/sin (1, hd) fp32 for position `pos`. Returns (x_out (b, h),
    kv_cache). Residual stream fp32, attention over [0, pos] only, softmax
    fp32 — the reference's numerics (``fused_decode.py:406``)."""
    if arch != "llama" or kv_scales is not None or "wqkv_s" in params:
        raise NotImplementedError(
            f"fused decode arch={arch!r}, int8 weights and int8 KV are not "
            "ported yet (ROADMAP Queue B row 4)")
    L, b, S, dkv2 = kv_cache.shape
    dkv = dkv2 // 2
    nh, nkv = num_heads, num_kv_heads
    hd = dkv // nkv
    rep = nh // nkv
    dq = nh * hd
    dtype = x.dtype
    scale = 1.0 / math.sqrt(hd)
    cos_b = cos.reshape(1, 1, hd).float()
    sin_b = sin.reshape(1, 1, hd).float()
    valid = torch.arange(S, device=x.device)[None, None, None] <= pos
    xf = x.float()
    for l in range(L):
        xn = _rms(xf, params["ln1"][l], eps)
        qkv = _wdot(xn, params["wqkv"][l])
        q = qkv[:, :dq].reshape(b, nh, hd)
        k = qkv[:, dq:dq + dkv].reshape(b, nkv, hd)
        v = qkv[:, dq + dkv:].reshape(b, nkv, hd)
        q = _rope1(q, cos_b, sin_b)
        k = _rope1(k, cos_b, sin_b)
        kv_new = torch.cat([k.reshape(b, dkv), v.reshape(b, dkv)], dim=-1)
        kv_cache[l, :, pos] = kv_new.to(kv_cache.dtype)
        kl = kv_cache[l, :, :, :dkv].float().reshape(b, S, nkv, hd)
        vl = kv_cache[l, :, :, dkv:].float().reshape(b, S, nkv, hd)
        qg = q.reshape(b, nkv, rep, hd) * scale
        scores = torch.einsum("bgrd,bsgd->bgrs", qg, kl)
        scores = torch.where(valid, scores,
                             torch.tensor(NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bgrs,bsgd->bgrd", probs, vl)
        attn = attn.reshape(b, dq).to(dtype)
        xf = xf + _wdot(attn, params["wo"][l])
        xn2 = _rms(xf, params["ln2"][l], eps)
        gt = _wdot(xn2, params["wg"][l])
        u = _wdot(xn2, params["wu"][l])
        act = (torch.nn.functional.silu(gt) * u).to(dtype)
        xf = xf + _wdot(act, params["wd"][l])
    return xf.to(dtype), kv_cache


_PARAM_KEYS = ("ln1", "wqkv", "wo", "ln2", "wg", "wu", "wd")


def fused_decode_cuda(x, params, kv_cache, pos, cos, sin, *, num_heads: int,
                      num_kv_heads: int, eps: float = 1e-5):
    """Wrapper of the hand-written kernel (one call = one decode step
    through all L layers, 1 + 11L launches on the current stream). Checks
    device, dtype, shape and contiguity and raises on anything else."""
    L, b, S, dkv2 = kv_cache.shape
    dkv = dkv2 // 2
    nh, nkv = num_heads, num_kv_heads
    if nkv <= 0 or dkv % nkv or nh % nkv:
        raise ValueError(f"fused_decode_cuda: heads {nh}/{nkv} do not "
                         f"divide the cache width {dkv2}")
    hd = dkv // nkv
    rep = nh // nkv
    h = x.shape[1]
    dq = nh * hd
    ffn = params["wg"].shape[2]
    shapes = {"ln1": (L, h), "wqkv": (L, h, dq + 2 * dkv), "wo": (L, dq, h),
              "ln2": (L, h), "wg": (L, h, ffn), "wu": (L, h, ffn),
              "wd": (L, ffn, h)}
    tensors = [("x", x, (b, h)), ("kv_cache", kv_cache, (L, b, S, dkv2))]
    tensors += [(k, params[k], shapes[k]) for k in _PARAM_KEYS]
    for name, t, shape in tensors:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"fused_decode_cuda: {name} on {t.device}, "
                             f"expected {x.device} (cuda)")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_decode_cuda: {name} is {t.dtype}; the "
                            "kernel takes bfloat16 weights, x and cache")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_decode_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"fused_decode_cuda: {name} not contiguous")
    cos = cos.reshape(hd)
    sin = sin.reshape(hd)
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"fused_decode_cuda: {name} must be a "
                             f"contiguous float32 ({hd},) row on {x.device}")
    if not 1 <= b <= 8 or hd not in (64, 128) or rep not in (1, 2, 4, 8):
        raise ValueError(f"fused_decode_cuda: unsupported b={b} (1..8), "
                         f"head_dim={hd} (64|128), rep={rep} (1|2|4|8)")
    if h % 8 or ffn % 8 or (dq + 2 * dkv) % 8:
        raise ValueError("fused_decode_cuda: h, ffn and the qkv width must "
                         "be multiples of 8")
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"fused_decode_cuda: pos {pos} outside the cache "
                         f"length {S}")
    dev = x.device
    x_out = torch.empty_like(x)
    xf = torch.empty((b, h), dtype=torch.float32, device=dev)
    qkv = torch.empty((b, dq + 2 * dkv), dtype=torch.float32, device=dev)
    attn = torch.empty((b, dq), dtype=torch.bfloat16, device=dev)
    act = torch.empty((b, ffn), dtype=torch.bfloat16, device=dev)
    lib = _kernel_lib()
    ws = torch.empty(lib.fused_decode_llama_workspace(b, h, nh, nkv, hd, ffn),
                     dtype=torch.float32, device=dev)
    p = _build.ptr
    err = lib.fused_decode_llama(
        p(x), p(x_out), *(p(params[k]) for k in _PARAM_KEYS), p(kv_cache),
        p(cos), p(sin), p(xf), p(qkv), p(attn), p(act), p(ws),
        L, b, h, nh, nkv, hd, ffn, S, pos, float(eps), _build.stream_of(x))
    fused_decode_cuda.launches += 1
    _build.check(err, "fused_decode_llama")
    return x_out, kv_cache


fused_decode_cuda.launches = 0


def _kernel_lib():
    lib = _build.library("fused_decode")
    fn = lib.fused_decode_llama
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 17 + [ci] * 9 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        wsf = lib.fused_decode_llama_workspace
        wsf.argtypes = [ci] * 6
        wsf.restype = ctypes.c_long
    return lib


def fused_decode_step(x, params, kv_cache, pos, cos, sin, *,
                      num_heads: int, num_kv_heads: int, eps: float = 1e-5,
                      arch: str = "llama", blocks: Optional[Dict] = None,
                      kv_scales=None):
    """Dispatch: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. Args follow fused_decode_reference; ``blocks`` is checked
    against the cache dtype."""
    if arch != "llama" or kv_scales is not None or "wqkv_s" in params:
        raise NotImplementedError(
            f"fused decode arch={arch!r}, int8 weights and int8 KV are not "
            "ported yet (ROADMAP Queue B row 4)")
    cb = kv_cache.element_size()
    if blocks is not None and blocks.get("cache_wbytes", cb) != cb:
        raise ValueError(
            f"decode plan assumed a {blocks['cache_wbytes']}-byte KV cache "
            f"but the cache dtype is {kv_cache.dtype} ({cb} B)")
    if x.device.type == "cpu":
        return fused_decode_reference(
            x, params, kv_cache, pos, cos, sin, num_heads=num_heads,
            num_kv_heads=num_kv_heads, eps=eps)
    return fused_decode_cuda(x, params, kv_cache, pos, cos, sin,
                             num_heads=num_heads, num_kv_heads=num_kv_heads,
                             eps=eps)
