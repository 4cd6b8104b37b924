"""Continuous-batching serving over a paged KV pool (port of
``paddle_tpu/serving``): ``ServingEngine`` with its ``Request`` /
``RequestResult`` types, speculative decoding's ``SpecConfig``, and the
pool's ``PoolExhausted``."""

from paddle_tpu_torch.serving.engine import (PRIORITIES, Request,  # noqa: F401
                                             RequestResult, ServingEngine)
from paddle_tpu_torch.serving.pool import PoolExhausted  # noqa: F401
from paddle_tpu_torch.serving.spec import SpecConfig  # noqa: F401

__all__ = ["PRIORITIES", "PoolExhausted", "Request", "RequestResult",
           "ServingEngine", "SpecConfig"]
