"""Host-side observability of the PyTorch port: the metrics registry, the
standard serving instruments, the request tracer / flight recorder, the
exporters (Prometheus text, JSON, chrome counters), windowed time series
over the registry and the serving SLO engine. Stdlib only, copied from
the JAX package's modules of the same names."""
from . import (exporters, instrument, metrics, slo,  # noqa: F401
               timeseries, tracing)
from .exporters import (chrome_counter_events, parse_prometheus,  # noqa: F401
                        to_json, to_prometheus)
from .metrics import get_registry  # noqa: F401
from .slo import (DEFAULT_WINDOWS, Objective, SLOEngine,  # noqa: F401
                  SLOMonitor, json_safe, validate_report)
from .timeseries import TimeSeries  # noqa: F401
