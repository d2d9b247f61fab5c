"""``incubate.distributed`` of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed``): ``models.moe`` and ``fleet``'s
recompute entry points."""
from . import fleet  # noqa: F401
from . import models  # noqa: F401
