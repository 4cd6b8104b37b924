"""Attention: the dispatch, the plain version, and the flash-attention kernel.

Port of ``paddle_tpu/ops/flash_attention.py``. Layout (batch, seq, heads,
head_dim); GQA when k/v carry fewer heads than q.

* ``_xla_attention`` — the plain version (port of the reference of the same
  name): dense fp32 scores, structured and dense masks, fully-masked rows
  emit 0 where the reference zeroes them.
* ``flash_attention_fwd`` — the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attention.cu`` (replaces the TPU kernel ``_fwd_kernels``,
  ``paddle_tpu/ops/flash_attention.py:526``), and ``flash_attention_fwd_plain``,
  its plain twin in fp32 with the same (out, lse) contract.
* ``scaled_dot_product_attention`` — the dispatch: CPU tensors take the plain
  version, CUDA tensors the kernel. There is no shape gate (the reference's
  ``_pallas_seq_ok`` is a TPU heuristic): every CUDA call, sq=1 included,
  goes to the kernel, and what the kernel does not take raises.

``causal_offset`` is a port-side extension: with ``is_causal`` it sets the
causal limit to ``k_pos <= causal_offset + i`` instead of the bottom-right
alignment ``sk - sq``. The KV-cache prefill passes it (with ``kv_lens``)
where the reference passes the equivalent dense bool mask.
"""

import ctypes
import math
from typing import Optional

import torch

from paddle_tpu_torch.ops import _build

NEG_INF = -1e30


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _structured_mask(sq, sk, is_causal, kv_lens, causal_offset, device):
    """Dense (b|1, 1, sq, sk) bool mask of the structured arguments."""
    masks = []
    if is_causal:
        off = sk - sq if causal_offset is None else int(causal_offset)
        q_pos = torch.arange(sq, device=device)[:, None] + off
        masks.append((torch.arange(sk, device=device)[None, :]
                      <= q_pos)[None, None])
    if kv_lens is not None:
        kl = torch.as_tensor(kv_lens, device=device).reshape(-1)
        masks.append((torch.arange(sk, device=device)[None, :]
                      < kl[:, None])[:, None, None, :])
    if not masks:
        return None
    m = masks[0]
    for extra in masks[1:]:
        m = m & extra
    return m


def _xla_attention(q, k, v, attn_mask=None, is_causal=False, scale=None,
                   kv_lens=None, causal_offset=None):
    """The plain version: scores in fp32 (fp64 for fp64 inputs)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    structured = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                                  q.device)
    if structured is not None:
        scores = torch.where(structured, scores,
                             torch.tensor(NEG_INF, dtype=acc, device=q.device))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.tensor(NEG_INF, dtype=acc,
                                              device=q.device))
        else:
            scores = scores + attn_mask.to(acc)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if structured is not None:
        # fully-masked rows emit 0 (flash-attn-2 convention, and the
        # kernel's); rows with a visible key are unchanged
        probs = torch.where(structured.any(-1, keepdim=True), probs,
                            torch.zeros((), dtype=probs.dtype,
                                        device=q.device))
    pv = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(pv),
                        v.to(pv)).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, is_causal=False, scale=None,
                              kv_lens=None, causal_offset=None):
    """Plain twin of the kernel: (out (b, sq, h, d) in q's dtype, lse
    (b, h, sq) fp32), computed in fp32. Fully-masked rows give out 0 and
    lse NEG_INF, as the kernel does."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = _structured_mask(sq, sk, is_causal, kv_lens, causal_offset,
                            q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    l = p.sum(-1, keepdim=True)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / lsafe, vf).to(q.dtype)
    lse = (m + torch.log(lsafe))[..., 0]
    return out, lse


def _kv_lens_arg(kv_lens, b, device):
    if kv_lens is None:
        return None
    if isinstance(kv_lens, int):   # a fill, not a stream-synchronising copy
        return torch.full((b,), kv_lens, dtype=torch.int32, device=device)
    kl = torch.as_tensor(kv_lens, device=device)
    if kl.dim() == 0:
        kl = kl.expand(b)
    return kl.to(torch.int32).contiguous()


def flash_attention_fwd(q, k, v, is_causal=False, scale=None, kv_lens=None,
                        causal_offset=None):
    """Flash-attention forward: (out, lse) as flash_attention_fwd_plain.

    CUDA tensors launch ``csrc/flash_attention.cu`` (bf16, head_dim 64 or
    128, contiguous); anything else on CUDA raises. CPU tensors take the
    plain twin."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, is_causal, scale, kv_lens,
                                         causal_offset)
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, "
                             f"expected {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}; the "
                            "kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} not contiguous")
    if d not in (64, 128) or k.shape != (b, sk, nkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (head_dim 64 or 128)")
    if nkv == 0 or h % nkv:
        raise ValueError(f"flash_attention_fwd: {h} heads not a multiple of "
                         f"{nkv} kv heads")
    if sq == 0 or b == 0:
        raise ValueError("flash_attention_fwd: empty q")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_off = (sk - sq) if causal_offset is None else int(causal_offset)
    kl = _kv_lens_arg(kv_lens, b, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    err = lib.flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _build.ptr(kl) if kl is not None else None,
        b, sq, sk, h, nkv, d, int(bool(is_causal)), q_off, float(scale),
        _build.stream_of(q))
    flash_attention_fwd.launches += 1
    _build.check(err, "flash_attention_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def _kernel_lib():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [ci] * 8 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 kv_lens=None, causal_offset: Optional[int] = None):
    """Attention with the device dispatch (see the module docstring).

    Left for later PRs on the kernel path: dense bool/float masks, segment
    ids, sliding windows, ALiBi and dropout (ROADMAP Queue B row 1); those
    raise on CUDA tensors. The plain version takes dense masks."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP Queue B row 1); "
            "pass training=False or dropout_p=0")
    if q.device.type == "cpu":
        return _xla_attention(q, k, v, attn_mask=attn_mask,
                              is_causal=is_causal, scale=scale,
                              kv_lens=kv_lens, causal_offset=causal_offset)
    if attn_mask is not None:
        raise NotImplementedError(
            "dense attn_mask on the CUDA kernel path is not ported yet "
            "(ROADMAP Queue B row 1); pass is_causal/causal_offset/kv_lens")
    return flash_attention_fwd(q, k, v, is_causal=is_causal, scale=scale,
                               kv_lens=kv_lens,
                               causal_offset=causal_offset)[0]
