"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``paddle_tpu/observability/metrics.py`` (stdlib only), kept apart
so the PyTorch package imports nothing of the JAX package.

The serving/training nervous system the ROADMAP's "heavy traffic" regime
needs (reference: python/paddle/profiler + fleet metrics; bar: vLLM's
Prometheus surface). Design constraints, in order:

* **Host-side only, zero device round trips.** Every record call coerces
  its value through ``float()`` — a jax tracer fails that coercion, so a
  record call accidentally placed inside a jitted function raises at
  trace time with a pointed message instead of silently baking one stale
  value into the compiled program. graftlint GL105 enforces the same
  contract statically.
* **stdlib only.** This module must import in a bare CI container —
  before jax, before numpy — so the tier-0 gate can selfcheck it the way
  it selfchecks graftlint (tools/metrics_snapshot.py --selfcheck).
* **Lock-protected.** The serving engine, the comm-watchdog poller
  thread, and jax.monitoring compile callbacks all record concurrently;
  one process-wide mutex over tiny dict/float updates is far below the
  noise floor of a decode step.

Metric families follow the Prometheus data model: a family has a name, a
help string, and optional label names; ``family.labels(op="matmul")``
returns (creating on first use) the child that actually holds values.
Unlabeled families proxy straight to their single anonymous child, so
``registry.counter("steps_total").inc()`` just works.

Every counter/gauge mutation also appends a ``(ts_us, name, value)``
sample to a bounded timeline ring, which is what the chrome-trace
exporter turns into ``"ph": "C"`` counter events merged into the
profiler's host-range timeline.
"""
import bisect
import collections
import math
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "exponential_buckets", "DEFAULT_LATENCY_BUCKETS",
]


def exponential_buckets(start, factor, count):
    """`count` upper bounds growing geometrically from `start` (the +Inf
    bucket is implicit, never listed)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 1 ms .. ~131 s: covers TTFT on a real chip and on the CPU-interpret CI
DEFAULT_LATENCY_BUCKETS = exponential_buckets(0.001, 2.0, 18)


def _host_float(value, what):
    """Coerce to a host float; reject tracers (and anything else that is
    not a concrete scalar) loudly — this is the runtime half of the
    host-side-only contract (the static half is graftlint GL105)."""
    try:
        return float(value)
    except Exception as e:  # jax ConcretizationTypeError, TypeError, ...
        raise TypeError(
            f"observability: {what} needs a concrete host scalar, got "
            f"{type(value).__name__} — metrics are host-side only; a "
            "record call inside a jitted function would fire at trace "
            "time (once), not per step. Move it outside jit.") from e


class _Labeled:
    """Shared family plumbing: label handling + child management."""

    kind = "untyped"

    def __init__(self, registry, name, help, labelnames):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames or ())
        self._children = {}          # label-value tuple -> child state

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name}: got labels {sorted(labelvalues)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self.registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child(key)
        return child

    def _anon(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name} declares labels {self.labelnames}; "
                "use .labels(...)")
        return self.labels()

    def _sample_name(self, key):
        if not key:
            return self.name
        kv = ",".join(f"{n}={v}" for n, v in zip(self.labelnames, key))
        return f"{self.name}{{{kv}}}"


class _CounterChild:
    __slots__ = ("_family", "_key", "value")

    def __init__(self, family, key):
        self._family = family
        self._key = key
        self.value = 0.0

    def inc(self, amount=1):
        amount = _host_float(amount, f"counter {self._family.name} inc()")
        if amount < 0:
            raise ValueError(
                f"counter {self._family.name}: negative increment "
                f"{amount} (counters are monotonic; use a gauge)")
        fam = self._family
        with fam.registry._lock:
            self.value += amount
            fam.registry._sample(fam._sample_name(self._key), self.value)


class Counter(_Labeled):
    """Monotonic cumulative count (requests served, compiles, failures)."""

    kind = "counter"

    def _new_child(self, key):
        return _CounterChild(self, key)

    def inc(self, amount=1):
        self._anon().inc(amount)

    @property
    def value(self):
        return self._anon().value


class _GaugeChild:
    __slots__ = ("_family", "_key", "value")

    def __init__(self, family, key):
        self._family = family
        self._key = key
        self.value = 0.0

    def set(self, value):
        value = _host_float(value, f"gauge {self._family.name} set()")
        fam = self._family
        with fam.registry._lock:
            self.value = value
            fam.registry._sample(fam._sample_name(self._key), value)

    def inc(self, amount=1):
        amount = _host_float(amount, f"gauge {self._family.name} inc()")
        fam = self._family
        with fam.registry._lock:
            self.value += amount
            fam.registry._sample(fam._sample_name(self._key), self.value)

    def dec(self, amount=1):
        self.inc(-_host_float(amount, f"gauge {self._family.name} dec()"))

    def set_max(self, value):
        """High-water update: keep the max of current and `value`."""
        value = _host_float(value, f"gauge {self._family.name} set_max()")
        fam = self._family
        with fam.registry._lock:
            if value > self.value:
                self.value = value
                fam.registry._sample(fam._sample_name(self._key), value)


class Gauge(_Labeled):
    """Instantaneous level (free blocks, in-flight requests, tokens/s)."""

    kind = "gauge"

    def _new_child(self, key):
        return _GaugeChild(self, key)

    def set(self, value):
        self._anon().set(value)

    def inc(self, amount=1):
        self._anon().inc(amount)

    def dec(self, amount=1):
        self._anon().dec(amount)

    def set_max(self, value):
        self._anon().set_max(value)

    @property
    def value(self):
        return self._anon().value


class _HistogramChild:
    __slots__ = ("_family", "_key", "bucket_counts", "sum", "count")

    def __init__(self, family, key):
        self._family = family
        self._key = key
        self.bucket_counts = [0] * (len(family.buckets) + 1)  # + the +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = _host_float(value,
                            f"histogram {self._family.name} observe()")
        fam = self._family
        # `le` upper bounds are inclusive (Prometheus semantics)
        i = bisect.bisect_left(fam.buckets, value)
        with fam.registry._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1
            fam.registry._sample(fam._sample_name(self._key), value)

    def quantile(self, q):
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the bucket that crosses rank q*count — Prometheus
        histogram_quantile(). Values past the last finite edge clamp to
        it. None when empty."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile {q} outside [0, 1]")
        fam = self._family
        with fam.registry._lock:
            counts = list(self.bucket_counts)
            total = self.count
        if total == 0:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= rank and c:
                lo = fam.buckets[i - 1] if i > 0 else 0.0
                hi = fam.buckets[i] if i < len(fam.buckets) \
                    else fam.buckets[-1]
                if hi <= lo:            # degenerate / +Inf bucket
                    return hi
                return lo + (hi - lo) * max(0.0, rank - cum) / c
            cum += c
        return fam.buckets[-1]


class Histogram(_Labeled):
    """Fixed-bucket cumulative-style histogram (latencies, step times)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, buckets=None):
        super().__init__(registry, name, help, labelnames)
        buckets = tuple(sorted(DEFAULT_LATENCY_BUCKETS if buckets is None
                               else buckets))
        if not buckets or any(not math.isfinite(b) for b in buckets):
            raise ValueError(
                f"histogram {name}: finite, non-empty bucket edges "
                "required (+Inf is implicit)")
        if len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram {name}: duplicate bucket edges")
        self.buckets = buckets

    def _new_child(self, key):
        return _HistogramChild(self, key)

    def observe(self, value):
        self._anon().observe(value)

    def quantile(self, q):
        return self._anon().quantile(q)

    @property
    def count(self):
        return self._anon().count

    @property
    def sum(self):
        return self._anon().sum


class MetricsRegistry:
    """Name -> metric family, plus the bounded chrome-counter timeline."""

    def __init__(self, timeline_capacity=65536):
        self._lock = threading.RLock()
        self._metrics = {}
        self._samples = collections.deque(maxlen=timeline_capacity)
        self.timeline_enabled = True
        # samples the bounded ring evicted (oldest-first): a long
        # serving run's chrome timeline silently starts mid-flight
        # otherwise — the drop count makes the truncation visible
        # (snapshot()'s "_timeline" entry, serve_monitor's dashboard)
        self.timeline_dropped = 0

    # -- family constructors (get-or-create, type-checked) ---------------
    def _family(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help,
                                              labels, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            elif labels and tuple(labels) != m.labelnames:
                raise ValueError(
                    f"metric {name} already registered with labels "
                    f"{m.labelnames}, requested {tuple(labels)}")
        return m

    def counter(self, name, help="", labels=()):
        return self._family(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._family(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        return self._family(Histogram, name, help, labels,
                            buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    # -- timeline ---------------------------------------------------------
    def _sample(self, name, value):
        # caller holds self._lock. perf_counter, NOT time.time(): the
        # profiler stamps its host ranges with perf_counter microseconds,
        # and these samples merge into that chrome stream — a different
        # timebase would land the counter track nowhere near the ranges.
        if self.timeline_enabled:
            if len(self._samples) == self._samples.maxlen:
                self.timeline_dropped += 1      # deque evicts the oldest
            self._samples.append((time.perf_counter() * 1e6, name, value))

    def timeline(self):
        with self._lock:
            return list(self._samples)

    def timeline_stats(self):
        """{'samples','capacity','dropped'}: how much of the recorded
        history the bounded ring still holds — `dropped` > 0 means a
        chrome export of this timeline is truncated at the front."""
        with self._lock:
            return {"samples": len(self._samples),
                    "capacity": self._samples.maxlen,
                    "dropped": self.timeline_dropped}

    # -- snapshot ---------------------------------------------------------
    def snapshot(self):
        """Plain-dict dump of every family and child (json-friendly)."""
        out = {}
        with self._lock:
            for name, m in self._metrics.items():
                entry = {"kind": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames)}
                if m.kind == "histogram":
                    entry["buckets"] = list(m.buckets)
                children = {}
                for key, child in m._children.items():
                    cname = ",".join(key) if key else ""
                    if m.kind == "histogram":
                        children[cname] = {
                            "bucket_counts": list(child.bucket_counts),
                            "sum": child.sum, "count": child.count}
                    else:
                        children[cname] = {"value": child.value}
                entry["children"] = children
                out[name] = entry
            # ring-truncation marker (never a real family: names with a
            # leading underscore are reserved). "kind"/"children" keep
            # the family shape so generic consumers iterate safely.
            out["_timeline"] = {"kind": "meta", "help": "", "children": {},
                                "labelnames": [],
                                **self.timeline_stats()}
        return out

    def reset(self):
        """Drop every metric and timeline sample (tests). Instrumented
        code must re-fetch families through the registry on each record —
        holding a family handle across reset() orphans it."""
        with self._lock:
            self._metrics.clear()
            self._samples.clear()
            self.timeline_dropped = 0


_registry = MetricsRegistry()


def get_registry():
    """The process-wide registry every subsystem records into."""
    return _registry
