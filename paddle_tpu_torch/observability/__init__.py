"""Host-side observability of the PyTorch port: the metrics registry, the
standard serving and training instruments, the request tracer / flight
recorder, the exporters (Prometheus text, JSON, chrome counters),
windowed time series over the registry, the serving SLO engine, the
training health monitor, the compile watch, the fleet plane
(``fleet_obs``: per-rank mirrors, exact cross-rank merges, the straggler
monitor), the per-program cost catalog (``costs``: flops, bytes and peak
device memory counted over a program's first call of each signature,
MFU and roofline share against its device-complete time) and the memory
layer (``memory``: live-tensor census, the card's allocator gauges, the
``hbm_pressure`` trigger, per-device skew). Stdlib only at import time,
copied from the JAX package's modules of the same names (the compile
watch and ``watch_ops`` hook torch where the JAX package hooks jax; the
cost catalog counts eager ops and the port's kernels where the JAX one
reads XLA's analyses; the memory layer reads PyTorch's allocator where
the JAX one reads PJRT's)."""
from . import (compile_watch, costs, exporters, fleet_obs,  # noqa: F401
               instrument, memory, metrics, slo, timeseries, tracing,
               train_health)
from .compile_watch import install as install_compile_watch  # noqa: F401
from .instrument import watch_ops  # noqa: F401
from .exporters import (chrome_counter_events, parse_prometheus,  # noqa: F401
                        to_json, to_prometheus)
from .metrics import (Counter, DEFAULT_LATENCY_BUCKETS, Gauge,  # noqa: F401
                      Histogram, MetricsRegistry, exponential_buckets,
                      get_registry)
from .slo import (DEFAULT_WINDOWS, Objective, SLOEngine,  # noqa: F401
                  SLOMonitor, json_safe, validate_report)
from .timeseries import TimeSeries  # noqa: F401
from .tracing import (FlightRecorder, SpanRecorder, get_flight_recorder,  # noqa: F401
                      get_tracer, load_dump)
from .train_health import TrainHealthMonitor  # noqa: F401
from .fleet_obs import (FleetMonitor, RankExporter,  # noqa: F401
                        discover_snapshots, gauge_rollups,
                        load_fleet_manifest, load_rank_snapshot,
                        merge_snapshots, merged_quantile,
                        snapshot_from_prometheus)
from .costs import (CostCatalog, get_cost_catalog, peak_bandwidth,  # noqa: F401
                    peak_flops)
from .memory import (MemoryMonitor, census_diff, device_memory,  # noqa: F401
                     live_array_census, record_census, shard_skew,
                     tag_arrays)
