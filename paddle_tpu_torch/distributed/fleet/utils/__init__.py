"""``fleet.utils`` of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``): ``recompute`` and
the main-grad mixed precision of ``mix_precision_utils``. The file
systems, timers and the pipeline adaptor are later slices."""
from ..recompute import recompute  # noqa: F401
from . import mix_precision_utils  # noqa: F401

__all__ = ["recompute", "mix_precision_utils"]
