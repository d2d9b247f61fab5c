"""``fleet`` of the PyTorch port: activation recompute
(``recompute``, ``recompute_sequential``, ``recompute_hybrid``) and the
training mesh's sharded compute (``sharded``: ZeRO-3 over fsdp, Megatron
over mp)."""
from . import sharded  # noqa: F401
from .recompute import (recompute, recompute_hybrid,  # noqa: F401
                        recompute_sequential)

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]
