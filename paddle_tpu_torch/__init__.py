"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package reproduces it
module by module with PyTorch around hand-written Hopper kernels
(``csrc/*.cu``, built with nvcc at first use — see ``ops/_build.py``). It
imports neither jax nor paddle_tpu.

It serves Llama through ``inference.generate`` (prefill through the
flash-attention forward kernel, decode through the fused decode-step
kernel; weight-only int8 models from ``quantization.quantize_model`` and an
int8 KV cache through that kernel's int8 modes), serves it with continuous batching over a paged KV pool through
``serving.ServingEngine`` (decode through the paged decode-step kernel), and
pretrains GPT-2 (``models.GPTPretrainModel`` +
``optimizer.AdamW``, driven by ``python -m paddle_tpu_torch.bench``) with
attention differentiated through the flash-attention forward and backward
kernels.
Entry points run on ``cuda`` unless a CPU device (or CPU tensors) is given;
on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

from paddle_tpu_torch.core import device  # noqa: F401
from paddle_tpu_torch.core.device import get_device, set_device  # noqa: F401
from paddle_tpu_torch.core.dtype import (  # noqa: F401
    bfloat16,
    float16,
    float32,
    get_default_dtype,
    int8,
    int32,
    int64,
    set_default_dtype,
)
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.core.rng import (  # noqa: F401
    get_rng_state,
    seed,
    set_rng_state,
)
from paddle_tpu_torch import (inference, models, nn, ops,  # noqa: F401
                              optimizer, quantization, serving)
