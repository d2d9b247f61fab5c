"""Neural-network surface of the PyTorch port (counterpart of
``paddle_tpu/nn``): the functionals and layers the Llama model uses, and
the gradient clips an optimizer takes (``clip``)."""
from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layers import Embedding, Linear, RMSNorm  # noqa: F401
