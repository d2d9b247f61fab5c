"""Host-side observability of the PyTorch port: the metrics registry, the
standard serving instruments and the request tracer / flight recorder.
Stdlib only, copied from the JAX package's modules of the same names."""
from . import instrument, metrics, tracing  # noqa: F401
from .metrics import get_registry  # noqa: F401
