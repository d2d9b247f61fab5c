"""Distributed models of ``incubate`` in the PyTorch port: ``moe``."""
from . import moe  # noqa: F401
