from paddle_tpu_torch.models.ernie import (  # noqa: F401
    ErnieConfig,
    ErnieForPretraining,
    ErnieModel,
)
from paddle_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    GPTPretrainModel,
)
from paddle_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
)
from paddle_tpu_torch.models.mixtral import (  # noqa: F401
    MixtralConfig,
    MixtralForCausalLM,
)
from paddle_tpu_torch.models.unet import (  # noqa: F401
    UNetConfig,
    UNetModel,
)
