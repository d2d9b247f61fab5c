"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layers``):
what the Llama model and the other model families build."""
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .norm import GroupNorm, LayerNorm, RMSNorm  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
