"""Device resolution and seeding of the PyTorch port."""
from .device import resolve_device  # noqa: F401
from .random import make_generator  # noqa: F401
