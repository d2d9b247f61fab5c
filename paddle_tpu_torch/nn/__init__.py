"""Neural-network surface of the PyTorch port (counterpart of
``paddle_tpu/nn``): the functionals and layers the Llama model uses."""
from . import functional  # noqa: F401
from .layers import Embedding, Linear, RMSNorm  # noqa: F401
