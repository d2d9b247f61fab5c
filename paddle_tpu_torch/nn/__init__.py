"""Neural-network surface of the PyTorch port (counterpart of
``paddle_tpu/nn``): the functionals and layers the Llama model and the
other model families use, ``initializer`` and ``ParamAttr``, and the
gradient clips an optimizer takes (``clip``). ROADMAP Queue 1 item 10
lists what the port has not taken of ``paddle_tpu/nn`` yet."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import ParamAttr, create_parameter, model_init  # noqa: F401
from .layers import (Conv2D, Dropout, Embedding, GroupNorm,  # noqa: F401
                     LayerList, LayerNorm, Linear, MultiHeadAttention,
                     RMSNorm, TransformerEncoder, TransformerEncoderLayer)
