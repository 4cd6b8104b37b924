"""Enforce-style error checking (port of ``paddle_tpu/core/enforce.py``)."""

import contextlib


class EnforceError(RuntimeError):
    pass


class NotFoundError(EnforceError):
    pass


class InvalidArgumentError(EnforceError, ValueError):
    pass


class UnimplementedError(EnforceError, NotImplementedError):
    pass


def enforce(cond, msg="enforce failed", exc=EnforceError):
    if not cond:
        raise exc(msg)


def enforce_eq(a, b, msg=""):
    if a != b:
        raise InvalidArgumentError(f"Expected {a!r} == {b!r}. {msg}")


def enforce_shape(x, expected, msg=""):
    got = tuple(x.shape)
    expected = tuple(expected)
    if len(got) != len(expected) or any(
        e is not None and e != g for g, e in zip(got, expected)
    ):
        raise InvalidArgumentError(f"Expected shape {expected}, got {got}. {msg}")


@contextlib.contextmanager
def error_context(ctx: str):
    """Prefix `ctx` onto any exception escaping the block."""
    try:
        yield
    except Exception as e:
        e.add_note(f"[paddle_tpu_torch] {ctx}")
        raise
