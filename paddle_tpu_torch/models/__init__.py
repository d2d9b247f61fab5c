"""Models of the PyTorch port (counterpart of ``paddle_tpu/models``):
the Llama family and its pretraining step, and the other families the
JAX package exports (GPT, ERNIE, ViT, the conditional UNet).
``state_from_numpy`` / ``state_to_numpy`` carry any of them across from
the JAX model's ``jit.functional.state_arrays``."""
from . import ernie, gpt, pretrain, unet, vit  # noqa: F401
from .ernie import (ErnieConfig, ErnieForMaskedLM,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel,
                    ernie_sharding_rules)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
    LlamaPretrainingCriterion, llama_pipe_state_from_numpy,
    llama_pipe_state_to_numpy, llama_state_from_numpy, llama_state_to_numpy)
from .state import state_from_numpy, state_to_numpy  # noqa: F401
from .unet import UNet2DConditionModel  # noqa: F401
from .vit import (VisionTransformer, vit_base_patch16_224,  # noqa: F401
                  vit_large_patch16_224, vit_tiny)
