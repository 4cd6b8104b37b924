"""Dropout: the keep mask every dropout of the port draws, the hidden-dropout
kernel and its plain version.

The mask is the JAX package's CPU mask, ``jax.random.bernoulli(key, 1 - p,
shape)`` (``paddle_tpu/nn/functional.py:112``, and over the attention's
(b, h, sq, sk) probabilities at ``paddle_tpu/ops/flash_attention.py:138``):
the element at flat row-major index i is kept iff ``uniform(key)[i] <
float32(1 - p)``, which is ``(bits(i) >> 9) < keep_threshold(p)`` on the
element's 32 threefry bits. ``keep_mask`` computes it in torch integer ops
(``core/rng.py``), ``attention_keep_mask`` from the (b, h, q, k)
coordinates as the flash-attention kernels index an element, and
``csrc/threefry.cuh`` on the card.

``dropout_cuda`` wraps the hand-written kernel ``csrc/dropout.cu`` (it
replaces no TPU kernel: the reference leaves this dropout to XLA, and the
port's plain version would be ~100 eager int64 passes a call); on CPU
tensors it runs ``dropout_plain``. ``launches`` counts its launches,
``backward`` those of them made for a gradient.

``attention_keep_words`` is the attention's keep mask packed 32 keys a
word, hashed once a call by kernel W of ``csrc/dropout.cu`` (the plain twin
``attention_keep_words_plain`` on the CPU): K1, K3 and K4 read those words
instead of hashing (``ops.flash_attention``). ``attention_keep_words.
launches`` counts its launches; ``keep_words_partition`` is kernel W's
work partition (a warp a pair of rows) computed as the kernel does.
"""

import ctypes
import math

import numpy as np
import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def keep_threshold(p) -> int:
    """The integer t with ``uniform < float32(1 - p)`` ⟺ ``(bits >> 9) <
    t``: ceil(float32(1 - p) · 2^23) (exact: a float32 times 2^23 is a
    double exactly). p = 0 keeps every element (t = 2^23), p = 1 none."""
    return math.ceil(float(np.float32(1.0 - p)) * 2.0 ** 23)


def keep_in_dtype(p, dtype) -> float:
    """1 - p rounded to `dtype`, as the reference's ``x / keep`` takes a
    Python float in x's dtype (a bf16 keep for a bf16 x)."""
    return float(torch.tensor(1.0 - p, dtype=torch.float64).to(dtype))


def divide_by_keep(x, p):
    """x / keep_in_dtype(p), divided as IEEE division in x's compute type
    and rounded to x's dtype (the reference's ``x / keep``, and the
    kernel's). The divisor is a tensor on x's device: on CUDA torch turns
    a division by a Python scalar into a product with its reciprocal,
    which rounds differently."""
    return x / torch.full((), keep_in_dtype(p, x.dtype), dtype=x.dtype,
                          device=x.device)


def keep_mask(key, p, shape, device=None):
    """Bool keep mask of `shape` for the draw `key`, on `device` (the key's
    by default): ``bernoulli(key, 1 - p, shape)``."""
    key = torch.as_tensor(key, dtype=torch.int64)
    if device is not None:
        key = key.to(device)
    return (rng.random_bits(key, shape) >> 9) < keep_threshold(p)


def attention_keep_mask(key, p, b, h, sq, sk, device=None):
    """The keep mask over attention probabilities (b, h, sq, sk) as K1, K3
    and K4 compute it: element (bi, hi, q, k) hashes its flat index
    ``((bi·h + hi)·sq + q)·sk + k``, 64 bits, split into (hi, lo) words."""
    key = torch.as_tensor(key, dtype=torch.int64)
    if device is not None:
        key = key.to(device)
    dev = key.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    bh = (ar(b)[:, None] * h + ar(h)[None, :])[:, :, None, None]
    idx = (bh * sq + ar(sq)[:, None]) * sk + ar(sk)[None, :]
    y1, y2 = rng.threefry2x32(key[0], key[1], idx >> 32, idx & 0xFFFFFFFF)
    return ((y1 ^ y2) >> 9) < keep_threshold(p)


def _pack_bits(x, n):
    """(..., m) bool packed little-endian into (..., n // 8) uint8, n >= m a
    multiple of 8: bit i of byte j is x[..., 8j + i], False past m."""
    buf = torch.zeros(x.shape[:-1] + (n,), dtype=torch.uint8,
                      device=x.device)
    buf[..., :x.shape[-1]] = x
    w = (2 ** torch.arange(8, device=x.device)).to(torch.uint8)
    return (buf.reshape(x.shape[:-1] + (n // 8, 8)) * w).sum(
        -1, dtype=torch.uint8)


def keep_words_width(sk) -> int:
    """Words a row of keep words holds: ceil(sk / 128)·4 (16-byte rows, for
    TMA, as ``ops.flash_attention.mask_words`` pads a bool mask)."""
    return -(-sk // 128) * 4


def attention_keep_words_plain(key, p, b, h, sq, sk, is_causal=False,
                               causal_offset=None, kv_lens=None, window=None,
                               everything=False, device=None):
    """Plain twin of kernel W: ``attention_keep_mask`` and the structured
    limits (every key below sk with `everything`), packed by ``_pack_bits``
    into int32 words (b, h, sq, ``keep_words_width(sk)``): bit i of word w
    of a row is key 32w + i."""
    # the attention's structured limits (ops.flash_attention imports this
    # module, so not at the top)
    from paddle_tpu_torch.ops.flash_attention import _structured_mask
    z = attention_keep_mask(key, p, b, h, sq, sk, device)
    vis = None if everything else _structured_mask(
        sq, sk, is_causal, kv_lens, causal_offset, z.device, window)
    if vis is not None:
        z = z & vis
    return _pack_bits(z, keep_words_width(sk) * 32).view(torch.int32)


# Kernel W's balance: a warp's words exceed the mean of its batch's two-row
# warps by at most this many (the partial words at its two rows' edges)
# in the causal triangle and wherever every row has the same words. A
# window or a kv_len that cuts only some rows of the triangle leaves pairs
# apart by up to a row's words; one pair a warp and no grid-stride loop
# leave those to the block scheduler.
KEEP_WORDS_SLACK = 2


def keep_words_partition(b, h, sq, sk, is_causal=False, causal_offset=None,
                         kv_lens=None, window=None, everything=False):
    """Kernel W's work partition, computed as the kernel computes it: warp
    p of a (batch, head) takes rows p and sq − 1 − p (the middle row alone
    when sq is odd) and hashes each row's words [wa, wb), those that hold a
    key its structured limits leave (every key below sk with
    `everything`). Returns numpy int64 arrays (rows, wa, wb) of shape (b,
    h, ceil(sq / 2), 2), a warp's second row -1 (and its span empty) where
    it takes one. It documents the partition's cover and balance; what
    proves the kernel's cover is its words held bit for bit to
    ``attention_keep_words_plain`` on the card."""
    p = np.arange((sq + 1) // 2)
    rows = np.stack([p, sq - 1 - p], -1)
    rows[..., 1][rows[..., 1] == p] = -1
    q_off = sk - sq if causal_offset is None else int(causal_offset)
    kvl = np.full(b, sk, np.int64)
    if kv_lens is not None and not everything:
        kvl = np.clip(np.asarray(torch.as_tensor(kv_lens).cpu(), np.int64),
                      0, sk)
    hi = np.broadcast_to(kvl[:, None, None], (b,) + rows.shape).copy()
    lo = np.zeros_like(hi)
    if not everything:
        if is_causal:
            hi = np.minimum(hi, q_off + rows + 1)
        if window is not None:
            lo = np.maximum(lo, q_off + rows - int(window) + 1)
    wa = lo >> 5
    wb = np.where(hi > lo, (hi + 31) >> 5, wa)
    wa, wb = (np.where(rows < 0, 0, x)[:, None] for x in (wa, wb))
    return tuple(np.broadcast_to(x, (b, h) + rows.shape).astype(np.int64)
                 for x in (rows, wa, wb))


def keep_words_mask(words, sk):
    """The bool (b, h, sq, sk) keep mask that packed words hold."""
    by = words.contiguous().view(torch.uint8)
    bits = (by[..., None] >> torch.arange(8, dtype=torch.uint8,
                                          device=by.device)) & 1
    return bits.reshape(by.shape[:-1] + (-1,))[..., :sk].bool()


def attention_keep_words(key, p, b, h, sq, sk, is_causal=False,
                         causal_offset=None, kv_lens=None, window=None,
                         everything=False, device=None):
    """The attention's keep mask over (b, h, sq, sk) as packed int32 words
    (b, h, sq, ``keep_words_width(sk)``) on `device` (the key's by default):
    bit i of word w of row (bi, hi, q) is ``attention_keep_mask``'s bit at
    key 32w + i where the structured limits leave that key visible (kv_lens
    (b,), the causal limit with ``causal_offset``, the window's lower edge),
    0 elsewhere; with `everything` every key below sk (the general mode,
    whose dead rows weigh every key). CUDA: one launch of kernel W
    (``csrc/dropout.cu``; counted on ``launches``), every word written;
    the CPU: the plain twin; "meta" (the wrappers' argument tests): the
    words' shape, no launch."""
    key = torch.as_tensor(key, dtype=torch.int64)
    device = key.device if device is None else torch.device(device)
    if window is not None and not is_causal:
        raise ValueError("attention_keep_words: a window needs is_causal")
    if device.type == "cpu":
        return attention_keep_words_plain(key, p, b, h, sq, sk, is_causal,
                                          causal_offset, kv_lens, window,
                                          everything, device)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"attention_keep_words: device {device}, expected "
                         "cuda or cpu")
    from paddle_tpu_torch.ops.flash_attention import _kv_lens_arg
    ww = keep_words_width(sk)
    out = torch.empty((b, h, sq, ww), dtype=torch.int32, device=device)
    if device.type == "meta":   # shapes only: a meta tensor holds no values
        return out
    kl = _kv_lens_arg(kv_lens, b, device)
    if kl is not None and tuple(kl.shape) != (b,):
        raise ValueError(f"attention_keep_words: kv_lens of shape "
                         f"{tuple(kl.shape)}, expected ({b},)")
    off = sk - sq if causal_offset is None else int(causal_offset)
    k1, k2 = rng.key_words(key)
    err = _lib().attention_keep_words(
        _build.ptr(out), _build.ptr(kl) if kl is not None else None, b, h,
        sq, sk, ww, int(bool(is_causal)), off,
        min(int(window or 0), 1 << 30), int(everything),
        k1, k2, keep_threshold(p), _build.stream_of(out))
    attention_keep_words.launches += 1
    _build.check(err, "attention_keep_words")
    return out


attention_keep_words.launches = 0


def dropout_plain(x, key, p, divide=True):
    """The plain version: ``where(keep, x / keep_in_dtype, 0)`` in x's
    dtype (``divide=False``: ``where(keep, x, 0)``, the downscale_in_infer
    mode's training form)."""
    z = keep_mask(key, p, x.shape, x.device)
    y = divide_by_keep(x, p) if divide else x
    return torch.where(z, y, torch.zeros((), dtype=x.dtype, device=x.device))


def _lib():
    lib = _build.library("dropout")
    fn = lib.dropout_fwd
    if fn.argtypes is None:
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, cu, cu, cu,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        kw = lib.attention_keep_words
        kw.argtypes = [vp, vp] + [ci] * 9 + [cu, cu, cu, vp]
        kw.restype = ctypes.c_int
    return lib


def dropout_cuda(x, key, p, divide=True, backward=False):
    """The dropout kernel on a CUDA tensor x (fp32 or bf16; copied
    contiguous and 16-byte aligned when it is not), the plain version on a
    CPU tensor. `key` is the draw's key (2,); ``backward`` marks a launch
    made for a gradient (counted on ``dropout_cuda.backward`` too)."""
    if x.device.type == "cpu":
        return dropout_plain(x, key, p, divide)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout_cuda: x is {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if x.device.type != "cuda":
        raise ValueError(f"dropout_cuda: x on {x.device}, expected cuda")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    y = torch.empty_like(x)
    k1, k2 = rng.key_words(key)
    div = keep_in_dtype(p, x.dtype) if divide else 1.0
    err = _lib().dropout_fwd(_build.ptr(x), _build.ptr(y), x.numel(),
                             _DTYPES[x.dtype], k1, k2, keep_threshold(p),
                             div, _build.stream_of(x))
    dropout_cuda.launches += 1
    dropout_cuda.backward += bool(backward)
    _build.check(err, "dropout_fwd")
    return y


dropout_cuda.launches = 0
dropout_cuda.backward = 0


class Dropout(torch.autograd.Function):
    """``dropout_cuda`` with a gradient. It saves the key and p, not the
    mask: the backward regenerates the mask and applies the same function
    to the gradient (d/dx of where(keep, x / k, 0) is where(keep, g / k, 0),
    rounded as the forward rounds). At GPT-2 345M, 49 saved (8, 1024, 1024)
    masks would cost about 400 MB a step."""

    @staticmethod
    def forward(ctx, x, key, p, divide):
        ctx.key, ctx.p, ctx.divide = key, p, divide
        return dropout_cuda(x, key, p, divide)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (dropout_cuda(g, ctx.key, ctx.p, ctx.divide, backward=True),
                None, None, None)
