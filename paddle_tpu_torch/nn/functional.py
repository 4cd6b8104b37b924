"""Functional ops — the subset of ``paddle_tpu/nn/functional.py`` that Llama
serving, GPT pretraining and the SD UNet call."""

import torch

# rows of logits per pass of cross_entropy: its fp32 intermediates stay at
# _CE_ROWS × vocab (≈ 200 MB at 50304) instead of the whole (tokens, vocab)
_CE_ROWS = 1024


def silu(x):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (jax.nn.gelu's)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def linear(x, weight, bias=None):
    """y = x @ W (+ b). Weight layout (in, out) — matches the reference.
    Mixed dtypes promote as ``jnp.matmul`` does (an fp32 model reading a
    weight-only int8 layer's bf16 dequantized weight runs in fp32)."""
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight):
    return weight[ids]


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            rng_name="dropout"):
    """Port of the reference's ``dropout`` (``paddle_tpu/nn/functional.py:
    105-115``). In training with p > 0 it draws one key from stream
    `rng_name` (``core.rng.next_rng_key``) and keeps each element with
    probability 1 - p by the reference's mask; "upscale_in_train" divides
    the kept elements by 1 - p, "downscale_in_infer" keeps them as they
    are and scales by 1 - p in eval instead. p = 1 gives zeros. On CUDA
    tensors the dropout kernel (``ops.dropout``), on CPU tensors its plain
    version; the backward regenerates the mask from the saved key."""
    from paddle_tpu_torch.ops import dropout as drop_ops
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            # the reference's infer scaling, 1 - p taken in x's dtype
            return x * drop_ops.keep_in_dtype(p, x.dtype)
        return x
    from paddle_tpu_torch.core import rng
    key = rng.next_rng_key(rng_name)
    return drop_ops.Dropout.apply(x, key, float(p),
                                  mode == "upscale_in_train")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """The reference's rounding: normalise in fp32 (fp64 stays fp64), cast
    to x's dtype, then ``* weight + bias`` in that dtype."""
    n = 1 if isinstance(normalized_shape, int) else len(tuple(normalized_shape))
    dims = tuple(range(x.dim() - n, x.dim()))
    xc = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xc.mean(dims, keepdim=True)
    var = xc.var(dims, correction=0, keepdim=True)
    y = ((xc - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _nchw_only(what, data_format):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"{what}: only data_format 'NCHW' (the UNet's) is ported "
            "(ROADMAP Queue A item 11)")


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Port of the reference's ``group_norm`` (``paddle_tpu/nn/functional.py:
    162``), NCHW: each sample's channels in `num_groups` groups, normalised
    by the group's mean and biased variance, then ``* weight + bias`` per
    channel. One ``torch.nn.functional.group_norm`` (statistics in fp32;
    the reference computes in XLA, outside any Pallas kernel). In bf16 the
    reference rounds the statistics and the normalised value to bf16 before
    the affine, the port once at the end: a bf16 ulp apart."""
    _nchw_only("group_norm", data_format)
    return torch.nn.functional.group_norm(x, num_groups, weight, bias,
                                          epsilon)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """Port of the reference's ``conv2d`` (``paddle_tpu/nn/functional.py:
    190``), NCHW with an int or (h, w) padding: weight (out_ch, in_ch /
    groups, kh, kw), the reference's layout and torch's. The convolution
    is ``torch.nn.functional.conv2d`` (cuDNN on the card; the reference
    leaves it to XLA, outside any Pallas kernel), its output in x's dtype,
    then the bias added in that dtype as the reference adds it."""
    _nchw_only("conv2d", data_format)
    if isinstance(padding, str) or any(
            isinstance(p, (tuple, list)) for p in _pair(padding)):
        raise NotImplementedError(
            "conv2d: only an int or (h, w) padding is ported (ROADMAP "
            "Queue A item 11)")
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = torch.nn.functional.conv2d(x, weight, None, _pair(stride),
                                   _pair(padding), _pair(dilation), groups)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


def interpolate(x, scale_factor=None, size=None, mode="nearest",
                data_format="NCHW"):
    """Port of the reference's ``interpolate`` (``paddle_tpu/nn/functional.py:
    291``, ``jax.image.resize``) in its nearest mode at an integer scale,
    NCHW, the mode the UNet's upsampler calls: every pixel repeated scale
    times along each axis (``jax.image.resize``'s half-pixel nearest and
    torch's "nearest" agree there). Other modes and fractional scales
    raise."""
    _nchw_only("interpolate", data_format)
    h, w = x.shape[2], x.shape[3]
    if size is None:
        sf = _pair(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    if (mode != "nearest" or size[0] % h or size[1] % w
            or size[0] < h or size[1] < w):
        raise NotImplementedError(
            f"interpolate: only mode 'nearest' at an integer upscale is "
            f"ported (got mode {mode!r}, {(h, w)} -> {tuple(size)}; ROADMAP "
            "Queue A item 11)")
    return torch.nn.functional.interpolate(x, size=tuple(size),
                                           mode="nearest")


def rms_norm(x, weight=None, epsilon=1e-6):
    from paddle_tpu_torch.ops import rms_norm as _rms
    return _rms.rms_norm(x, weight, epsilon)


class _TokenNLL(torch.autograd.Function):
    """Per-token −log softmax(logits)[label] of (tokens, classes) logits,
    0 where the label is ``ignore_index`` (port of ``_token_nll`` and the
    masking of ``cross_entropy``), in fp32 (fp64 for fp64 logits).

    Like the reference it keeps as residuals the logits in their own dtype
    and an fp32 lse per token, and its backward emits (softmax − onehot)·g
    in the logits dtype; the fp32 work runs over _CE_ROWS rows at a time."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index):
        n = logits.shape[0]
        cdt = torch.promote_types(logits.dtype, torch.float32)
        valid = label != ignore_index
        lab = torch.where(valid, label, torch.zeros_like(label))
        lse = torch.empty(n, dtype=cdt, device=logits.device)
        picked = torch.empty(n, dtype=cdt, device=logits.device)
        for i in range(0, n, _CE_ROWS):
            z = logits[i:i + _CE_ROWS].to(cdt)
            lse[i:i + _CE_ROWS] = torch.logsumexp(z, dim=-1)
            picked[i:i + _CE_ROWS] = z.gather(
                1, lab[i:i + _CE_ROWS, None])[:, 0]
        ctx.save_for_backward(logits, lab, valid, lse)
        return torch.where(valid, lse - picked,
                           torch.zeros((), dtype=cdt, device=logits.device))

    @staticmethod
    def backward(ctx, g):
        logits, lab, valid, lse = ctx.saved_tensors
        cdt = lse.dtype
        g_tok = valid.to(cdt) * g.to(cdt)
        dz = torch.empty_like(logits)
        for i in range(0, logits.shape[0], _CE_ROWS):
            p = torch.exp(logits[i:i + _CE_ROWS].to(cdt)
                          - lse[i:i + _CE_ROWS, None])
            p.scatter_add_(1, lab[i:i + _CE_ROWS, None],
                           -valid[i:i + _CE_ROWS, None].to(cdt))
            dz[i:i + _CE_ROWS] = p * g_tok[i:i + _CE_ROWS, None]
        return dz, None, None


def cross_entropy(logits, label, reduction="mean", soft_label=False,
                  ignore_index=-100, axis=-1, label_smoothing=0.0):
    """Hard-label cross entropy over the last axis of (..., classes) logits
    with (...) integer labels (port of the reference's hard-label path):
    the per-token loss is 0 where the label is ``ignore_index``;
    ``reduction`` "mean" divides the sum by the count of the other tokens
    (at least 1), "sum" sums, "none" returns the per-token losses in the
    labels' shape; in fp32 (fp64 for fp64 logits). Soft labels, label
    smoothing and another class axis are not ported yet (ROADMAP Queue A
    item 2)."""
    if (soft_label or label_smoothing > 0.0
            or axis % logits.dim() != logits.dim() - 1
            or tuple(label.shape) != tuple(logits.shape[:-1])):
        raise NotImplementedError(
            "cross_entropy: only hard labels of the logits' leading shape "
            "over the last axis, without label smoothing, are ported "
            "(ROADMAP Queue A item 2)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    flat = label.reshape(-1).long()
    loss = _TokenNLL.apply(logits.reshape(-1, logits.shape[-1]), flat,
                           ignore_index)
    if reduction == "mean":
        return loss.sum() / (flat != ignore_index).sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(label.shape)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 kv_lens=None, segment_ids=None,
                                 kv_segment_ids=None, window_size=None,
                                 alibi_slopes=None, causal_offset=None):
    """q/k/v: (batch, seq, heads, head_dim) — the reference's layout and
    signature (``causal_offset`` beside it, the port's).

    On CUDA tensors this runs the hand-written flash-attention kernels
    (forward, and the backward ones when a gradient is needed); on CPU
    tensors the plain versions (see ``ops.flash_attention``, looked up at
    call time). ``window_size`` is the causal sliding window (Mistral),
    ``segment_ids`` / ``kv_segment_ids`` the packed-sequence ids,
    ``alibi_slopes`` the ALiBi slopes (causal only)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return fa.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training, scale=scale,
        kv_lens=kv_lens, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, window_size=window_size,
        alibi_slopes=alibi_slopes, causal_offset=causal_offset)


# reference path: paddle.nn.functional.flash_attention.flash_attention
from paddle_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401,E402
