"""paddle.incubate.distributed.fleet of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed/fleet/__init__.py``; reference
python/paddle/incubate/distributed/fleet/__init__.py: the recompute
entry points staged under incubate)."""
from ....distributed.fleet.recompute import (  # noqa: F401
    recompute_sequential, recompute_hybrid,
)

__all__ = ["recompute_sequential", "recompute_hybrid"]
