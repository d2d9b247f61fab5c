"""Host-side observability of the PyTorch port: the metrics registry, the
standard serving and training instruments, the request tracer / flight
recorder, the exporters (Prometheus text, JSON, chrome counters),
windowed time series over the registry, the serving SLO engine, the
training health monitor and the compile watch. Stdlib only at import
time, copied from the JAX package's modules of the same names (the
compile watch and ``watch_ops`` hook torch where the JAX package hooks
jax)."""
from . import (compile_watch, exporters, instrument,  # noqa: F401
               metrics, slo, timeseries, tracing, train_health)
from .compile_watch import install as install_compile_watch  # noqa: F401
from .instrument import watch_ops  # noqa: F401
from .exporters import (chrome_counter_events, parse_prometheus,  # noqa: F401
                        to_json, to_prometheus)
from .metrics import get_registry  # noqa: F401
from .slo import (DEFAULT_WINDOWS, Objective, SLOEngine,  # noqa: F401
                  SLOMonitor, json_safe, validate_report)
from .timeseries import TimeSeries  # noqa: F401
from .tracing import FlightRecorder, load_dump  # noqa: F401
from .train_health import TrainHealthMonitor  # noqa: F401
