"""Functionals of the PyTorch port (counterpart of
``paddle_tpu/nn/functional``): what the Llama model and the other model
families (GPT, ERNIE, ViT, the conditional UNet) call, and
``flashmask_attention``."""
from .activation import gelu, relu, silu, tanh  # noqa: F401
from .attention import (  # noqa: F401
    flash_attention, flashmask_attention, scaled_dot_product_attention)
from .common import dropout, embedding, interpolate, linear  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import group_norm, layer_norm, rms_norm  # noqa: F401
from .rope import (  # noqa: F401
    apply_rotary_pos_emb, fused_rotary_position_embedding,
    rotary_embedding_cos_sin)
