from paddle_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
)
