"""Distributed surface of the PyTorch port (counterpart of
``paddle_tpu/distributed``): collectives on explicit groups
(``collective``), the comm watchdog, the training mesh (``mesh``) and
``fleet`` (activation recompute and the mesh's sharded compute)."""
from . import fleet  # noqa: F401
