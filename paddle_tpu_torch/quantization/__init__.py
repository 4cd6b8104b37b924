"""Weight-only int8 quantization for inference (port of
``paddle_tpu/quantization/__init__.py``).

Weights are stored as int8 with a per-output-channel fp32 scale. A
quantized layer reads ``weight`` through a property that dequantizes to
``dequant_dtype`` (bf16) on each read, so the layered paths (the prefill,
the cache forward) run their plain products on the dequantized weight, as
the reference leaves them to XLA. The fused decode step streams the int8
stacks themselves and scales the products' outputs (``ops/fused_decode.py``
and the int8 mode of its kernel).

``quantize_model(model)`` converts in place: every sublayer with a 2-D
``weight`` whose name or class name does not match ``exclude_names``
(embeddings keep full precision) trades its ``weight`` parameter for
``weight_q`` (int8) and ``weight_scale`` (fp32), both non-trainable
parameters, so ``state_dict(include_buffers=False)`` — what ``generate``
binds — carries them under the reference's keys.
"""

from typing import Optional, Sequence, Tuple

import torch


def quantize_weight_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel (last dim) int8 quantization.

    w: (..., in, out) float → (int8 of the same shape, fp32 scale (out,)).
    The scale is max(absmax, 1e-8) / 127 in fp32; ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=tuple(range(wf.dim() - 1)))
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def weight_only_linear(x, weight_q, weight_scale, bias=None):
    """``paddle.nn.quant.weight_only_linear`` (int8): the weight and its
    scale are rounded to x's dtype before their product, then x @ w."""
    w = weight_q.to(x.dtype) * weight_scale.to(x.dtype)
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return y


_QUANT_CLASS_CACHE = {}


def _quantized_class(base, dequant_dtype):
    key = (base, dequant_dtype)
    cls = _QUANT_CLASS_CACHE.get(key)
    if cls is None:
        def _weight(self):
            q = self._parameters["weight_q"]
            s = self._parameters["weight_scale"]
            return q.to(dequant_dtype) * s.to(dequant_dtype)

        cls = type(f"Int8{base.__name__}", (base,),
                   {"weight": property(_weight),
                    "_is_weight_only_int8": True})
        _QUANT_CLASS_CACHE[key] = cls
    return cls


def _quantize_layer(layer, dequant_dtype):
    w = layer._parameters.pop("weight")
    q, scale = quantize_weight_int8(w.detach())
    layer.register_parameter("weight_q",
                             torch.nn.Parameter(q, requires_grad=False))
    layer.register_parameter("weight_scale",
                             torch.nn.Parameter(scale, requires_grad=False))
    layer.__class__ = _quantized_class(type(layer), dequant_dtype)


def quantize_model(model, dequant_dtype=torch.bfloat16,
                   include: Optional[Sequence[type]] = None,
                   exclude_names: Sequence[str] = ("embed",)):
    """In-place weight-only int8 conversion of every Linear-like sublayer
    (a 2-D ``weight`` parameter, not name-matched by ``exclude_names``).
    A layer already converted is left as it is. Returns the model."""
    with torch.no_grad():
        for name, sub in model.named_modules():
            if getattr(sub, "_is_weight_only_int8", False):
                continue
            w = sub._parameters.get("weight")
            if w is None or w.dim() != 2:
                continue
            if include is not None and not isinstance(sub, tuple(include)):
                continue
            if any(t in name.lower() or t in type(sub).__name__.lower()
                   for t in exclude_names):
                continue
            _quantize_layer(sub, dequant_dtype)
    return model


def quantized_state(model):
    """Every named parameter, the non-trainable int8 weights and scales
    included (what ``state_dict(include_buffers=False)`` returns)."""
    return {n: p.detach() for n, p in model.named_parameters()}
