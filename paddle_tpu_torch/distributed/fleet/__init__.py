"""``fleet`` of the PyTorch port: activation recompute
(``recompute``, ``recompute_sequential``, ``recompute_hybrid``)."""
from .recompute import (recompute, recompute_hybrid,  # noqa: F401
                        recompute_sequential)

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]
