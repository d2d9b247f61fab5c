"""Incubating serving ops of the PyTorch port: the fused functions
(``functional``), the fused layers over them (``layers``) and continuous
batching over the paged KV cache."""
from . import functional  # noqa: F401
from .layers import (FusedBiasDropoutResidualLayerNorm,  # noqa: F401
                     FusedDropoutAdd, FusedFeedForward, FusedLinear,
                     FusedMultiHeadAttention, FusedMultiTransformer,
                     FusedTransformerEncoderLayer,
                     fused_layer_state_from_numpy)
from .continuous_batching import (  # noqa: F401
    BlockAllocator, ContinuousBatchingEngine, GenerationRequest,
    KVAllocFailure, RequestResult, block_key, prompt_block_keys,
    propose_draft_tokens)
