"""Activation recompute (port of ``paddle_tpu/utils/recompute.py``) on
``torch.utils.checkpoint`` (non-reentrant).

The reference's ``jax.checkpoint`` takes a save policy over named values
(``checkpoint_name`` inside the function, ``save_only_these_names``
outside). Here a value is named by running the ops that produce it under
``checkpoint_name(name)``, and a policy of names becomes a selective
checkpoint (``create_selective_checkpoint_contexts``): the outputs of the
ops run under a saved name are kept from the forward, every other op of the
segment is recomputed in the backward, and the segment's inputs are saved
as with a plain checkpoint. No policy (``policy=None``) is the plain
checkpoint: boundaries only.

    x = recompute(layer, x, cos, sin,
                  policy=save_only_these_names("ffn_gate", "ffn_up"))

The replay draws the keys the forward drew: the reference gets that from
``jax.checkpoint`` replaying the same traced keys (``paddle_tpu/utils/
recompute.py:1-7``), while ``preserve_rng_state`` covers only torch's own
generator. So a segment's first call records where the named streams and
the global generator stand (``core.rng.stream_state``), and its replay
runs from there, with the forward's frames as the stack even when their
``rng_guard`` has exited; afterwards every counter is put back where the
forward left it.
"""

import contextlib
import functools
import threading

import torch
import torch.utils.checkpoint as _ckpt

from paddle_tpu_torch.core import rng

_local = threading.local()


@contextlib.contextmanager
def checkpoint_name(name):
    """Name the value that the ops run inside this block produce (the
    reference's ``checkpoint_name(x, name)``): a policy that saves `name`
    keeps their outputs for the backward instead of recomputing them."""
    prev = getattr(_local, "name", None)
    _local.name = name
    try:
        yield
    finally:
        _local.name = prev


def save_only_these_names(*names):
    """The policy that saves the values named `names` (and nothing else
    inside a segment besides its inputs)."""
    return frozenset(names)


@contextlib.contextmanager
def record_saves():
    """Collect into the yielded set the names whose values a selective
    recompute kept from its forward passes inside this block."""
    prev = getattr(_local, "saves", None)
    _local.saves = set()
    try:
        yield _local.saves
    finally:
        _local.saves = prev


def _context_fn(policy):
    names = frozenset(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        name = getattr(_local, "name", None)
        if name is None or name not in names:
            return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
        saves = getattr(_local, "saves", None)
        if saves is not None and not ctx.is_recompute:
            saves.add(name)
        return _ckpt.CheckpointPolicy.MUST_SAVE

    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             policy_fn)


def _replaying_streams(function):
    """`function` whose later calls (the checkpoint's replay) start from
    the rng streams its first call started from, and leave them as they
    found them."""
    first = []

    def run(*args, **kwargs):
        if not first:
            first.append(rng.stream_state())
            return function(*args, **kwargs)
        frames = first[0][0]
        before = [dict(f.counters) for f in frames]
        now = rng.stream_state()
        rng.restore_stream_state(first[0])
        try:
            return function(*args, **kwargs)
        finally:
            for f, c in zip(frames, before):
                f.counters = c
            rng.restore_stream_state(now)

    return run


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              policy=None, **kwargs):
    """``function(*args, **kwargs)`` whose backward recomputes its forward,
    keeping only what `policy` names (and its inputs). ``use_reentrant`` is
    accepted for the reference's signature: the segment always runs
    non-reentrant, the form selective saving needs."""
    del use_reentrant
    extra = {} if policy is None else {"context_fn": _context_fn(policy)}
    return _ckpt.checkpoint(_replaying_streams(function), *args,
                            use_reentrant=False,
                            preserve_rng_state=preserve_rng_state, **extra,
                            **kwargs)


def recompute_sequential(functions, x, segments=1):
    """Run `functions` in order over `x` in `segments` recomputed chunks
    (the reference's ``recompute_sequential``)."""
    funcs = list(functions)
    seg_size = max(1, len(funcs) // max(segments, 1))

    def run_segment(fs):
        def seg(y):
            for f in fs:
                y = f(y)
            return y
        return seg

    for i in range(0, len(funcs), seg_size):
        x = recompute(run_segment(funcs[i:i + seg_size]), x)
    return x


def recompute_wrapper(policy=None):
    """Decorator: the function's calls recompute in the backward under
    `policy`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return recompute(fn, *args, policy=policy, **kwargs)
        return wrapped
    return deco
