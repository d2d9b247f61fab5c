"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layers``):
what the Llama model builds."""
from .common import Embedding, Linear  # noqa: F401
from .norm import RMSNorm  # noqa: F401
