"""RNG: the global seed, and a port of JAX's threefry2x32 key streams.

Port of ``paddle_tpu/core/rng.py`` plus the parts of ``jax.random`` that
sampling in ``inference.generate`` reaches (``paddle_tpu/inference/
__init__.py:79-106``): ``PRNGKey``, ``fold_in``, 32-bit random bits,
``uniform``, ``gumbel`` and ``categorical``. The same seed gives the same
bits — and so the same sampled token — as the JAX package, bit for bit.

JAX runs with ``jax_threefry_partitionable=True``: the bits of element i of
a draw are ``y0 ^ y1`` where ``(y0, y1) = threefry2x32(key, (hi(i), lo(i)))``
over the 64-bit flat index i. That is the layout reproduced here.

Keys are int64 tensors of shape (..., 2) holding uint32 words; all the
arithmetic runs in int64 masked to 32 bits, because torch has no complete
uint32 arithmetic on every device. Weight init does not use these streams:
it takes an explicit ``torch.Generator`` (see ``nn/initializer.py``).
"""

import threading

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on broadcastable int64 tensors of uint32
    words. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed, device=None):
    """Key of a 32-bit seed: words (0, seed mod 2**32), as jax.random.PRNGKey
    builds it without x64. `seed` may be an int or an integer tensor of
    seeds (..., ) giving keys (..., 2)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """jax.random.fold_in: hash the key with the pair (0, data). A Python
    int `data` stays a scalar operand (no host-to-device copy, which would
    synchronise the stream on every decode step); a tensor `data` — e.g.
    (b,) per-row counts against (b, 2) keys, the vmap of the JAX call — is
    used on the keys' device as it is."""
    key = torch.as_tensor(key, dtype=torch.int64)
    if isinstance(data, int):
        x1, x2 = 0, data & _MASK
    else:
        x2 = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
        x1 = torch.zeros_like(x2)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], x1, x2)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, shape):
    """32-bit random bits of `shape` (int64 tensor of uint32 values).

    `key` (2,) gives one draw of `shape`; keys (n, 2) give n independent
    draws, each of `shape` (the vmap of the JAX call over the keys)."""
    key = torch.as_tensor(key, dtype=torch.int64)
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (y1 ^ y2).reshape(lead + shape)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 uniform in [minval, maxval), jax.random.uniform's bit recipe:
    23 mantissa bits under exponent 0, minus one, scaled, then clamped."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # float32 scalars, as jax computes them; Python floats exactly equal to
    # them keep the ops free of host-to-device copies
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key, shape):
    """jax.random.gumbel, mode 'low' (the default), float32."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny, maxval=1.0)))


def categorical(key, logits):
    """jax.random.categorical over the last axis (Gumbel-max, first
    occurrence on ties). One key (2,) draws the whole (…, n) batch as one
    stream; keys (b, 2) with logits (b, n) draw row r from key r."""
    key = torch.as_tensor(key, dtype=torch.int64)
    logits = logits.float()
    if key.dim() > 1:
        g = gumbel(key, logits.shape[1:])
    else:
        g = gumbel(key, logits.shape)
    return torch.argmax(g + logits, dim=-1)


# ---- global seed -------------------------------------------------------------

class _GlobalGenerator:
    """Global seed + draw counter (``paddle.seed`` parity). Each draw gets
    its own ``torch.Generator`` seeded from fold_in(PRNGKey(seed), count)."""

    def __init__(self, seed_: int = 0):
        self._seed = seed_
        self._count = 0
        self._lock = threading.Lock()

    def seed(self, s: int):
        with self._lock:
            self._seed = int(s)
            self._count = 0

    def next_seed(self) -> int:
        with self._lock:
            c = self._count
            self._count += 1
        k = fold_in(PRNGKey(self._seed), c)
        return (int(k[0]) << 31) ^ int(k[1])

    def next_generator(self, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(self.next_seed())
        return g


_GLOBAL = _GlobalGenerator(0)


def seed(s: int):
    """Set the global seed (`paddle.seed` parity)."""
    _GLOBAL.seed(s)
    return _GLOBAL


def next_generator(device) -> torch.Generator:
    """A fresh generator on `device`, seeded from the global stream."""
    return _GLOBAL.next_generator(device)
