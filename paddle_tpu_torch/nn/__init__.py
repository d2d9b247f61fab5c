"""Neural-network surface of the PyTorch port (counterpart of
``paddle_tpu/nn``): the functionals and layers that the Llama model, the
other model families and the vision zoo build from, ``initializer`` and
``ParamAttr``, and the gradient clips an optimizer takes (``clip``).
ROADMAP Queue 1 item 10 lists what the port has not taken of
``paddle_tpu/nn`` yet."""
from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import ParamAttr, create_parameter, model_init  # noqa: F401
from .layers import *  # noqa: F401,F403
