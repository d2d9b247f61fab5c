"""paddle hapi of the PyTorch port (counterpart of ``paddle_tpu/hapi``):
``Model`` (prepare / fit / evaluate / predict / save / load), its
``callbacks``, ``summary`` and ``flops``."""
from . import callbacks  # noqa: F401
from .flops import flops  # noqa: F401
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
