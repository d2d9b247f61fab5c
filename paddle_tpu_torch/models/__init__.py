"""Models of the PyTorch port (counterpart of ``paddle_tpu/models``):
the Llama family and its single-device pretraining step."""
from . import pretrain  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
    LlamaPretrainingCriterion, llama_pipe_state_from_numpy,
    llama_pipe_state_to_numpy, llama_state_from_numpy, llama_state_to_numpy)
