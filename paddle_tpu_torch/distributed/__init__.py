"""Distributed surface of the PyTorch port (counterpart of
``paddle_tpu/distributed``): so far the one-device part of ``fleet``,
activation recompute. Meshes, collectives and the parallel layers are
later slices."""
from . import fleet  # noqa: F401
