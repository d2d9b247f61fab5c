"""Incubating serving ops of the PyTorch port: the fused decoder-stack op
(``functional``) and continuous batching over the paged KV cache."""
from . import functional  # noqa: F401
from .continuous_batching import (  # noqa: F401
    BlockAllocator, ContinuousBatchingEngine, GenerationRequest,
    KVAllocFailure, RequestResult, block_key, prompt_block_keys,
    propose_draft_tokens)
