"""RNG: the global seed, the named streams, and a port of JAX's
threefry2x32 key streams.

Port of ``paddle_tpu/core/rng.py`` (the global generator, ``global_key``,
the named streams of ``rng_guard`` / ``next_rng_key`` and the TP rng-state
tracker) plus the parts of ``jax.random`` that sampling in
``inference.generate`` (``paddle_tpu/inference/__init__.py:79-106``) and
dropout reach: ``PRNGKey``, ``fold_in``, 32-bit random bits, ``uniform``,
``bernoulli``, ``gumbel`` and ``categorical``. The same seed gives the same
bits — and so the same sampled token and the same dropout mask — as the JAX
package, bit for bit.

JAX runs with ``jax_threefry_partitionable=True``: the bits of element i of
a draw are ``y0 ^ y1`` where ``(y0, y1) = threefry2x32(key, (hi(i), lo(i)))``
over the 64-bit flat index i. That is the layout reproduced here.

Keys are int64 tensors of shape (..., 2) holding uint32 words; all the
arithmetic runs in int64 masked to 32 bits, because torch has no complete
uint32 arithmetic on every device. Weight init does not use these streams:
it takes an explicit ``torch.Generator`` (see ``nn/initializer.py``).

The keys of the global generator and of the streams are host tensors (2,):
``fold_in`` of such a key by a Python int runs in Python integers, a few
microseconds and no device work. A kernel takes a key's two words as
launch arguments, and a plain version moves the key to its data's device
once per call, so a draw on the card crosses nothing per element.
"""

import contextlib
import threading
from typing import Dict, Optional

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


def _threefry_words(k1, k2, x1, x2):
    """threefry2x32 on Python ints (one element): the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _MASK) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def key_words(key):
    """The two uint32 words of a key (2,) as Python ints: what a kernel
    takes as its launch arguments."""
    k1, k2 = torch.as_tensor(key).reshape(2).tolist()
    return int(k1) & _MASK, int(k2) & _MASK


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
    if isinstance(data, int) and key.shape == (2,) \
            and key.device.type == "cpu":
        # one host key: Python integers, no tensor op per round
        y = _threefry_words(*key_words(key), 0, data & _MASK)
        return torch.tensor(y, dtype=torch.int64)
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


def bernoulli(key, p, shape):
    """jax.random.bernoulli: ``uniform(key, shape) < float32(p)``, a bool
    tensor on the key's device."""
    return uniform(key, shape) < float(np.float32(p))


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
    """Global seed + draw counter (``paddle.seed`` parity). Each draw takes
    the key fold_in(PRNGKey(seed), count), as the reference's does; weight
    init gets a ``torch.Generator`` seeded from that key."""

    def __init__(self, seed_: int = 0):
        self._seed = seed_
        self._count = 0
        self._lock = threading.Lock()

    def seed(self, s: int):
        with self._lock:
            self._seed = int(s)
            self._count = 0

    def next_key(self) -> torch.Tensor:
        with self._lock:
            c = self._count
            self._count += 1
        return fold_in(PRNGKey(self._seed), c)

    def next_seed(self) -> int:
        k1, k2 = key_words(self.next_key())
        return (k1 << 31) ^ k2

    def get_state(self):
        return (self._seed, self._count)

    def set_state(self, state):
        with self._lock:
            self._seed, self._count = int(state[0]), int(state[1])

    def next_generator(self, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(self.next_seed())
        return g


_GLOBAL = _GlobalGenerator(0)


def seed(s: int):
    """Set the global seed (`paddle.seed` parity)."""
    _GLOBAL.seed(s)
    return _GLOBAL


def get_rng_state():
    """(seed, count) of the global generator."""
    return _GLOBAL.get_state()


def set_rng_state(state):
    _GLOBAL.set_state(state)


def global_key() -> torch.Tensor:
    """The global generator's next key (a host tensor (2,))."""
    return _GLOBAL.next_key()


def next_generator(device) -> torch.Generator:
    """A fresh generator on `device`, seeded from the global stream."""
    return _GLOBAL.next_generator(device)


# ---- named streams -------------------------------------------------------------

class _StreamFrame:
    def __init__(self, keys: Dict[str, torch.Tensor]):
        self.keys = dict(keys)
        self.counters: Dict[str, int] = {}


_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextlib.contextmanager
def rng_guard(rngs: Optional[Dict[str, torch.Tensor]] = None, **kw):
    """Push named rng streams for the dynamic extent of a call.

    >>> with rng_guard(dropout=global_key()):
    ...     loss = model.loss(model(x), y)   # Dropout pulls from 'dropout'
    """
    keys = dict(rngs or {})
    keys.update(kw)
    frame = _StreamFrame(keys)
    _stack().append(frame)
    try:
        yield frame
    finally:
        _stack().pop()


def has_rng(name: str) -> bool:
    return any(name in frame.keys for frame in _stack())


def next_rng_key(name: str = "default") -> torch.Tensor:
    """The next key of stream `name`: fold_in(frame key, counter) of the
    innermost frame that binds it, its counter then advanced; with no such
    frame, the global generator's next key (the reference's eager
    fallback)."""
    for frame in reversed(_stack()):
        if name in frame.keys:
            c = frame.counters.get(name, 0)
            frame.counters[name] = c + 1
            return fold_in(frame.keys[name], c)
    return _GLOBAL.next_key()


def stream_state():
    """Where every stream stands: the frames of this thread's stack (the
    objects), each frame's counters, and the global generator's state.
    ``restore_stream_state`` puts them back, so a replayed forward (under
    recompute) draws the keys its first run drew."""
    stack = _stack()
    return (list(stack), [dict(f.counters) for f in stack],
            _GLOBAL.get_state())


def restore_stream_state(state):
    """Make the frames of `state` this thread's stack again, with the
    counters they had, and set the global generator back."""
    frames, counters, glob = state
    stack = _stack()
    stack[:] = frames
    for f, c in zip(frames, counters):
        f.counters = dict(c)
    _GLOBAL.set_state(glob)


class RNGStatesTracker:
    """Named seeds for TP-aware dropout (``get_rng_state_tracker`` parity):
    'global_seed' the same on every mp rank, 'local_seed' offset by the
    rank; ``rng_state(name)`` binds the streams 'default' and 'dropout' to
    PRNGKey(seed) for the draws inside it."""

    def __init__(self):
        self._seeds: Dict[str, int] = {}

    def add(self, name: str, seed_: int):
        if name in self._seeds:
            raise ValueError(f"rng state {name!r} already added")
        self._seeds[name] = int(seed_)

    def reset(self):
        self._seeds.clear()

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name not in self._seeds:
            raise KeyError(f"rng state {name!r} not registered (have "
                           f"{sorted(self._seeds)})")
        key = PRNGKey(self._seeds[name])
        with rng_guard(default=key, dropout=key):
            yield


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed_: int, mp_rank: int = 0):
    """Set up the 'global_seed' and 'local_seed' streams as Fleet TP does,
    and seed numpy and the global generator with `seed_`."""
    _TRACKER.reset()
    _TRACKER.add("global_seed", seed_ + 100003)
    _TRACKER.add("local_seed", seed_ + 100003 + 1024 * (1 + mp_rank))
    np.random.seed(seed_)
    seed(seed_)
