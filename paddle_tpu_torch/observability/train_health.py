"""Training health monitor of the PyTorch port: per-layer-group gradient
telemetry, divergence detection, and the data-pipeline / step-phase
breakdown.

A copy of ``paddle_tpu/observability/train_health.py`` (stdlib only),
kept apart so the PyTorch package imports nothing of the JAX package.
The step computes the packed vector on the card (kernel D of
``ops.adamw`` adds the group sums to the optimizer's two launches;
``pack_telemetry_plain`` is its plain version) and
``models/pretrain.py``'s ``run()`` fetches it in one copy on the
telemetry cadence.

* **Telemetry layout** - ``build_telemetry_spec()`` assigns every
  parameter to one of a small, fixed set of layer groups (``embed`` /
  block buckets ``blocks_00_01`` / ``norm_bias`` / ``head`` / ``other``)
  and defines the packed vector: per group ``grad_norm`` /
  ``param_norm`` / ``update_norm`` / non-finite count, after a
  ``loss`` / ``gnorm`` header.
* **TrainHealthMonitor** - declarative checks over windowed rings:
  non-finite loss / grad (on the transition), loss spike and grad-norm
  spike against a rolling median + MAD, per-group update / param ratio
  out of bounds, tokens/s regression, and data-pipeline stalls. A breach
  lands as ``train_health_breaches_total{check}``, a
  ``train_health_breach`` timeline event and a flight dump whose reason
  names the failure.
* **Step-phase breakdown** - ``instrument_loader()`` wraps any batch
  iterator (``io.DataLoader(instrument=True)`` routes through it): wait
  histogram, queue-depth and batch counters, ``data_wait`` spans and the
  stall detector; the pretraining ``run()`` splits the rest of the step
  into host and dispatch time against the wait accumulated here
  (``add_data_wait`` / ``pop_data_wait``).
"""
import math
import re
import threading
import time

from .metrics import get_registry
from .timeseries import TimeSeries
from .tracing import get_flight_recorder, get_tracer

__all__ = [
    "TelemetrySpec", "build_telemetry_spec", "TrainHealthMonitor",
    "record_telemetry", "instrument_loader", "add_data_wait",
    "pop_data_wait", "breach_summary", "GROUP_FIELDS", "HEADER_FIELDS",
    "CHECKS", "DUMP_REASONS",
]

# packed-vector layout: header first, then GROUP_FIELDS per group, in
# spec.groups order. Fixed field sets — the label cardinality of every
# gauge family below is bounded by construction.
HEADER_FIELDS = ("loss", "gnorm")
GROUP_FIELDS = ("grad_norm", "param_norm", "update_norm", "nonfinite")

# every check the monitor can raise, and the flight-recorder reason its
# dump files carry. Both are small FIXED sets: `check` is a metric
# label, `reason` keys the flight recorder's per-reason cooldown.
CHECKS = ("non_finite", "loss_spike", "grad_spike", "update_ratio",
          "throughput", "data_stall")
DUMP_REASONS = {
    "non_finite": "non_finite_loss",
    "loss_spike": "loss_divergence",
    "grad_spike": "grad_norm_spike",
    "update_ratio": "loss_divergence",
    "throughput": "data_stall",
    "data_stall": "data_stall",
}

_LAYER_IDX_RE = re.compile(r"\.(?:layers|h|blocks|layer|decoder_layers)"
                           r"\.(\d+)\.")
_EMBED_RE = re.compile(r"embed|wte|wpe", re.IGNORECASE)
_HEAD_RE = re.compile(r"lm_head|score|classifier", re.IGNORECASE)
_NORM_RE = re.compile(r"norm|ln_", re.IGNORECASE)


class TelemetrySpec:
    """The fixed (label -> parameter names) grouping plus the packed
    in-graph vector layout. Built once at ``make_train_step`` time; the
    group label set never changes afterwards (bounded metric
    cardinality by construction)."""

    def __init__(self, groups):
        # groups: ordered list of (label, tuple(param names)), all
        # non-empty — the packed layout indexes by position
        self.groups = [(str(label), tuple(names))
                       for label, names in groups if names]
        labels = [g[0] for g in self.groups]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate group labels: {labels}")

    @property
    def labels(self):
        return tuple(g[0] for g in self.groups)

    def __len__(self):
        return len(HEADER_FIELDS) + len(GROUP_FIELDS) * len(self.groups)

    def unpack(self, values):
        """Packed vector (any float sequence, host-side) -> the
        telemetry dict the monitor consumes. Derived ``update_ratio``
        (update_norm / param_norm) is computed here, on the host."""
        values = [float(v) for v in values]
        if len(values) != len(self):
            raise ValueError(
                f"telemetry vector has {len(values)} entries, spec "
                f"needs {len(self)} ({len(self.groups)} groups)")
        out = {"loss": values[0], "gnorm": values[1], "groups": {},
               "nonfinite_total": 0.0}
        off = len(HEADER_FIELDS)
        w = len(GROUP_FIELDS)
        for i, (label, _names) in enumerate(self.groups):
            row = dict(zip(GROUP_FIELDS, values[off + i * w:
                                                 off + (i + 1) * w]))
            denom = row["param_norm"]
            row["update_ratio"] = (
                row["update_norm"] / denom if denom > 0 else
                (0.0 if row["update_norm"] == 0 else math.inf))
            out["groups"][label] = row
            out["nonfinite_total"] += row["nonfinite"]
        return out


def _block_bucket_label(lo, hi):
    return f"blocks_{lo:02d}_{hi:02d}"


def build_telemetry_spec(param_ndims, max_block_buckets=4):
    """Group parameter names into the bounded label set.

    ``param_ndims`` maps parameter name -> rank. Assignment, first
    match wins: rank < 2 -> ``norm_bias`` (norm scales and biases —
    the no-weight-decay set); head-like names -> ``head``; embedding
    names -> ``embed``; a ``.layers.<i>.`` index -> one of at most
    ``max_block_buckets`` contiguous block buckets; anything else ->
    ``other``. The label set
    is fixed at build time regardless of model depth."""
    layer_idx = {}
    for name in param_ndims:
        m = _LAYER_IDX_RE.search(name)
        if m:
            layer_idx[name] = int(m.group(1))
    n_layers = max(layer_idx.values()) + 1 if layer_idx else 0
    n_buckets = min(int(max_block_buckets), n_layers) if n_layers else 0
    buckets = []
    if n_buckets:
        per = -(-n_layers // n_buckets)        # ceil
        for b in range(n_buckets):
            lo, hi = b * per, min(n_layers - 1, (b + 1) * per - 1)
            if lo <= hi:
                buckets.append((lo, hi))

    def bucket_for(idx):
        for lo, hi in buckets:
            if lo <= idx <= hi:
                return _block_bucket_label(lo, hi)
        return "other"

    grouped = {"embed": [], "head": [], "norm_bias": [], "other": []}
    for lo, hi in buckets:
        grouped[_block_bucket_label(lo, hi)] = []
    for name, ndim in param_ndims.items():
        if ndim < 2:
            grouped["norm_bias"].append(name)
        elif _HEAD_RE.search(name):
            grouped["head"].append(name)
        elif name in layer_idx:
            grouped[bucket_for(layer_idx[name])].append(name)
        elif _EMBED_RE.search(name):
            grouped["embed"].append(name)
        else:
            grouped["other"].append(name)
    order = (["embed"] + [_block_bucket_label(lo, hi) for lo, hi in buckets]
             + ["norm_bias", "head", "other"])
    return TelemetrySpec([(label, tuple(sorted(grouped.get(label, ()))))
                          for label in order])


# -- metric recording -------------------------------------------------------

def _gauges(registry):
    reg = registry if registry is not None else get_registry()
    return {
        "loss": reg.gauge("train_loss",
                          help="loss of the last telemetry-fetched step"),
        "gnorm": reg.gauge("train_grad_norm",
                           help="global clipped-gradient norm of the "
                                "last telemetry-fetched step"),
        "nonfinite": reg.gauge(
            "train_nonfinite_grads",
            help="non-finite gradient entries in the last telemetry "
                 "fetch (any > 0 means the step is already poisoned)"),
        "g_grad": reg.gauge(
            "train_group_grad_norm",
            help="per-layer-group gradient norm (groups are a fixed "
                 "set: embed / block buckets / norm_bias / head)",
            labels=("group",)),
        "g_param": reg.gauge("train_group_param_norm",
                             help="per-layer-group parameter norm",
                             labels=("group",)),
        "g_ratio": reg.gauge(
            "train_group_update_ratio",
            help="per-layer-group update-norm / param-norm of the last "
                 "step (the 'is the optimizer doing anything sane' "
                 "figure: ~lr when healthy, ~0 collapsed, >>lr "
                 "exploding)", labels=("group",)),
        "g_nonfinite": reg.gauge(
            "train_group_nonfinite",
            help="per-layer-group non-finite gradient entries "
                 "(localizes WHERE a NaN entered the backward pass)",
            labels=("group",)),
    }


def record_telemetry(unpacked, registry=None):
    """Land one unpacked telemetry dict in the registry's train-health
    gauge families (host-side; the caller already did the one bulk
    device fetch)."""
    g = _gauges(registry)
    g["loss"].set(unpacked["loss"])
    g["gnorm"].set(unpacked["gnorm"])
    g["nonfinite"].set(unpacked.get("nonfinite_total", 0.0))
    # the `group` label set is BOUNDED BY CONSTRUCTION: TelemetrySpec
    # fixes it at build_telemetry_spec time (embed / <=4 block buckets
    # / norm_bias / head / other) regardless of model depth — the same
    # bounded-set exception as the census/cost-catalog labels
    for label, row in unpacked.get("groups", {}).items():
        g["g_grad"].labels(group=label).set(row["grad_norm"])
        g["g_param"].labels(group=label).set(row["param_norm"])
        ratio = row.get("update_ratio", 0.0)
        g["g_ratio"].labels(group=label).set(
            ratio if math.isfinite(ratio) else -1.0)
        g["g_nonfinite"].labels(group=label).set(row["nonfinite"])


# -- step-phase plumbing ----------------------------------------------------

_pending_lock = threading.Lock()
_pending_wait = {"s": 0.0}


def add_data_wait(seconds):
    """Accumulate loader wait so the pretrain ``run()`` wrapper can
    split 'time between dispatches' into data-wait vs host work (the
    loader and the step wrapper are decoupled call sites)."""
    with _pending_lock:
        _pending_wait["s"] += float(seconds)


def pop_data_wait():
    with _pending_lock:
        s = _pending_wait["s"]
        _pending_wait["s"] = 0.0
    return s


def instrument_loader(iterable, monitor=None, queue_depth=None,
                      stall_threshold_s=None, registry=None,
                      recorder=None, flight_recorder=None):
    """Wrap a batch iterator with the data-pipeline telemetry:

    * ``train_data_wait_seconds`` histogram + a ``data_wait`` span on
      the ``train`` chrome lane per batch,
    * ``train_data_batches_total`` counter and (when ``queue_depth``
      is callable) the ``train_data_queue_depth`` gauge,
    * the stall detector: a wait above ``stall_threshold_s`` fires the
      ``data_stall`` breach — through ``monitor`` when one is
      attached (so it lands in its breach accounting), else directly
      (counter + timeline event + flight dump).

    ``DataLoader(instrument=True)`` routes its iterator through here;
    any custom loop can too."""
    reg = registry if registry is not None else get_registry()
    rec = recorder if recorder is not None else get_tracer()
    wait_h = reg.histogram(
        "train_data_wait_seconds",
        help="host wall spent waiting on the input pipeline, per batch")
    batches = reg.counter("train_data_batches_total",
                          help="batches the input pipeline delivered")
    depth_g = reg.gauge(
        "train_data_queue_depth",
        help="prefetch queue depth at batch delivery (0 sustained = "
             "the device is outrunning the pipeline)")
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        wait = time.perf_counter() - t0
        wait_h.observe(wait)
        batches.inc()
        add_data_wait(wait)
        rec.record_span("data_wait", t0 * 1e6, wait * 1e6,
                        request="train")
        if queue_depth is not None:
            try:
                depth_g.set(queue_depth())
            except (TypeError, ValueError):
                pass
        if monitor is not None:
            monitor.observe_data_wait(wait)
        elif stall_threshold_s is not None and wait > stall_threshold_s:
            _standalone_data_stall(wait, stall_threshold_s, reg, rec,
                                   flight_recorder)
        yield batch


def _standalone_data_stall(wait_s, threshold_s, reg, rec, flight):
    reg.counter("train_data_stalls_total",
                help="input-pipeline waits above the stall "
                     "threshold").inc()
    reg.counter(
        "train_health_breaches_total",
        help="training health-check breaches",
        labels=("check",)).labels(check="data_stall").inc()
    rec.event("train_health_breach", request="train", check="data_stall",
              wait_s=wait_s, threshold_s=threshold_s)
    fl = flight if flight is not None else get_flight_recorder()
    fl.trigger("data_stall", check="data_stall", wait_s=wait_s,
               threshold_s=threshold_s)


# -- the monitor ------------------------------------------------------------

class TrainHealthMonitor:
    """Declarative training-health checks over windowed rings.

    ``observe_step()`` is the per-step hook the pretrain ``run()``
    wrapper calls with the host-fetched telemetry (on the telemetry
    cadence — the monitor never touches the device). It records the
    gauge families, samples them into the ``TimeSeries`` ring,
    and evaluates the checks against the window that ring holds; a
    breach lands counter + timeline event + reason-named flight dump.

    All thresholds are JSON-friendly constructor arguments
    (``from_config`` mirrors ``SLOMonitor``), and every entry point
    takes explicit ``now=`` so tests replay synthetic
    clocks. Robust-baseline checks (loss/grad spikes) compare the
    newest value against median + MAD of the PRIOR window with a
    ``min_count`` guard — two noisy warmup steps are not a divergence
    — and the MAD gets a floor of ``mad_floor_frac * |median|`` so a
    perfectly flat window cannot make any wiggle look infinite.

    Per-check cooldown (``cooldown_s``, default the window) keeps a
    sustained anomaly from re-firing every step: one incident, one
    breach, one dump — the gate asserts exactly that. The non-finite
    check additionally fires on the finite -> non-finite TRANSITION
    only, so a run whose state is already poisoned (every NaN step
    after the first) does not drown the timeline.

    Defaults are chosen to be safe ON: ``data_stall_s=30`` (a 30s
    batch wait is pathological in any real run; ``None`` disables) and
    ``throughput_drop_frac=None`` (wall-clock throughput on shared CI
    is noise — opt in where the clock is trustworthy)."""

    def __init__(self, window_s=120.0, min_count=4, cadence_s=0.0,
                 loss_spike_mads=8.0, grad_spike_mads=8.0,
                 mad_floor_frac=0.05, update_ratio_bounds=(1e-9, 1.0),
                 throughput_drop_frac=None, data_stall_s=30.0,
                 cooldown_s=None, capacity=4096, registry=None,
                 recorder=None, flight_recorder=None):
        if float(window_s) <= 0:
            raise ValueError("window_s must be > 0")
        if int(min_count) < 1:
            raise ValueError("min_count must be >= 1")
        lo, hi = update_ratio_bounds
        if not (0 <= float(lo) < float(hi)):
            raise ValueError(
                f"update_ratio_bounds must be 0 <= lo < hi, got "
                f"({lo}, {hi})")
        self.window_s = float(window_s)
        self.min_count = int(min_count)
        self.cadence_s = float(cadence_s)
        self.loss_spike_mads = float(loss_spike_mads)
        self.grad_spike_mads = float(grad_spike_mads)
        self.mad_floor_frac = float(mad_floor_frac)
        self.update_ratio_bounds = (float(lo), float(hi))
        self.throughput_drop_frac = (
            None if throughput_drop_frac is None
            else float(throughput_drop_frac))
        self.data_stall_s = (None if data_stall_s is None
                             else float(data_stall_s))
        self.cooldown_s = (self.window_s if cooldown_s is None
                           else float(cooldown_s))
        self.registry = registry            # None = process registry
        self.recorder = recorder            # None = process tracer
        self.flight_recorder = flight_recorder
        self.timeseries = TimeSeries(registry=registry, capacity=capacity)
        self.steps_observed = 0
        self.breaches_total = 0
        self.breach_counts = {}             # check -> count
        self.last_report = None
        self._last_eval = None
        self._was_finite = True
        self._fired_at = {}                 # check -> now of last fire

    @classmethod
    def from_config(cls, config, **overrides):
        """Build from a JSON dict — the ``monitor`` block of
        tools/train_health.json carries the whole policy."""
        kw = dict(config)
        kw.update(overrides)
        return cls(**kw)

    # -- breach plumbing ---------------------------------------------------
    def _rec(self):
        return self.recorder if self.recorder is not None else get_tracer()

    def _flight(self):
        return (self.flight_recorder if self.flight_recorder is not None
                else get_flight_recorder())

    def _counter(self):
        reg = (self.registry if self.registry is not None
               else get_registry())
        return reg.counter("train_health_breaches_total",
                           help="training health-check breaches",
                           labels=("check",))

    def _breach(self, check, now, **context):
        """Count + timeline + flight dump, under the per-check
        cooldown. Returns True when the breach landed (not cooling)."""
        last = self._fired_at.get(check)
        if last is not None and now - last < self.cooldown_s:
            return False
        self._fired_at[check] = now
        self.breaches_total += 1
        self.breach_counts[check] = self.breach_counts.get(check, 0) + 1
        self._counter().labels(check=check).inc()
        ctx = {k: (v if isinstance(v, (str, bool, type(None)))
                   else float(v)) for k, v in context.items()}
        for k, v in list(ctx.items()):
            if isinstance(v, float) and not math.isfinite(v):
                ctx[k] = str(v)     # spans/dumps stay JSON-clean
        self._rec().event("train_health_breach", request="train",
                          check=check, **ctx)
        self._flight().trigger(DUMP_REASONS[check], check=check, **ctx)
        return True

    # -- windowed baselines ------------------------------------------------
    def _prior_values(self, name, now):
        """Ring values inside the window, EXCLUDING samples at `now`
        (the candidate being judged is the newest sample)."""
        left = now - self.window_s
        return [v for ts, v in self.timeseries.ring(name)
                if left <= ts < now and isinstance(v, (int, float))
                and math.isfinite(v)]

    def _robust_threshold(self, values, mads):
        med = _median(values)
        mad = _median([abs(v - med) for v in values])
        floor = self.mad_floor_frac * abs(med)
        return med, med + mads * max(mad, floor, 1e-12)

    # -- the per-step hook -------------------------------------------------
    def observe_step(self, step, loss, gnorm, groups=None,
                    tokens_per_s=None, now=None):
        """Evaluate every check against one telemetry fetch. `groups`
        is the TelemetrySpec.unpack ``groups`` dict (or None when only
        scalars are available); returns the evaluation report."""
        now = time.monotonic() if now is None else float(now)
        loss = float(loss)
        gnorm = float(gnorm)
        self.steps_observed += 1
        unpacked = {"loss": loss, "gnorm": gnorm,
                    "groups": groups or {},
                    "nonfinite_total": sum(
                        r.get("nonfinite", 0.0)
                        for r in (groups or {}).values())}
        record_telemetry(unpacked, registry=self.registry)
        if tokens_per_s is not None:
            reg = (self.registry if self.registry is not None
                   else get_registry())
            reg.gauge("train_tokens_per_s",
                      help="batch tokens / host wall of the last "
                           "dispatched step").set(tokens_per_s)
        # baselines are the PRIOR window: judge first, then sample the
        # candidate into the ring
        report = {"step": int(step), "now": now, "breaches": []}
        if self._last_eval is None \
                or now - self._last_eval >= self.cadence_s:
            self._last_eval = now
            report["breaches"] = self._evaluate(
                step, loss, gnorm, unpacked, tokens_per_s, now)
        self.timeseries.sample(now)
        self.last_report = report
        return report

    def _evaluate(self, step, loss, gnorm, unpacked, tokens_per_s, now):
        fired = []

        def breach(check, **ctx):
            if self._breach(check, now, step=step, **ctx):
                fired.append(check)

        # non-finite: transition-triggered, cooldown on top
        finite = (math.isfinite(loss) and math.isfinite(gnorm)
                  and unpacked["nonfinite_total"] == 0)
        if not finite and self._was_finite:
            breach("non_finite", loss=loss, gnorm=gnorm,
                   nonfinite_grads=unpacked["nonfinite_total"])
        self._was_finite = finite

        # loss spike vs the rolling robust baseline
        prior = self._prior_values("train_loss", now)
        if math.isfinite(loss) and len(prior) >= self.min_count:
            med, thr = self._robust_threshold(prior,
                                              self.loss_spike_mads)
            if loss > thr:
                breach("loss_spike", loss=loss, median=med,
                       threshold=thr, window_samples=len(prior))

        # grad-norm spike
        prior = self._prior_values("train_grad_norm", now)
        if math.isfinite(gnorm) and len(prior) >= self.min_count:
            med, thr = self._robust_threshold(prior,
                                              self.grad_spike_mads)
            if gnorm > thr:
                breach("grad_spike", gnorm=gnorm, median=med,
                       threshold=thr, window_samples=len(prior))

        # per-group update-ratio collapse/explosion (worst offender)
        lo, hi = self.update_ratio_bounds
        worst = None
        for label, row in unpacked["groups"].items():
            r = row.get("update_ratio")
            if r is None or not math.isfinite(r):
                continue        # non-finite state is the check above
            if r < lo or r > hi:
                if worst is None or abs(math.log10(max(r, 1e-300))) \
                        > abs(math.log10(max(worst[1], 1e-300))):
                    worst = (label, r)
        if worst is not None:
            breach("update_ratio", group=worst[0], ratio=worst[1],
                   lo=lo, hi=hi)

        # tokens/s regression (off unless configured: wall-clock
        # throughput on shared CI is noise; the gate proves the check
        # on synthetic clocks instead)
        if self.throughput_drop_frac is not None \
                and tokens_per_s is not None:
            prior = self._prior_values("train_tokens_per_s", now)
            if len(prior) >= self.min_count:
                med = _median(prior)
                if med > 0 and tokens_per_s \
                        < self.throughput_drop_frac * med:
                    breach("throughput", tokens_per_s=tokens_per_s,
                           median=med,
                           drop_frac=self.throughput_drop_frac)
        return fired

    def observe_data_wait(self, wait_s, step=None, now=None):
        """The loader-side hook: stall detection against
        ``data_stall_s`` (no-op when unset). The wait histogram is the
        loader wrapper's job; this only judges."""
        if self.data_stall_s is None:
            return False
        now = time.monotonic() if now is None else float(now)
        wait_s = float(wait_s)
        if wait_s <= self.data_stall_s:
            return False
        reg = (self.registry if self.registry is not None
               else get_registry())
        reg.counter("train_data_stalls_total",
                    help="input-pipeline waits above the stall "
                         "threshold").inc()
        return self._breach("data_stall", now, wait_s=wait_s,
                            threshold_s=self.data_stall_s,
                            **({} if step is None else {"step": step}))

    def report(self):
        """Summary dict."""
        return {
            "steps_observed": self.steps_observed,
            "breaches_total": self.breaches_total,
            "breach_counts": dict(self.breach_counts),
            "window_s": self.window_s,
            "checks": list(CHECKS),
        }


def _median(values):
    s = sorted(values)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty window")
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def breach_summary(dump):
    """Digest of a train-health flight dump (the four reasons this
    module triggers): which check fired with what evidence, plus the
    telemetry gauges the embedded metrics snapshot carried — what
    ``tools/torch_train_monitor.py`` prints per incident and its tests
    validate. Raises ValueError when the dump is not a train-health
    one."""
    reason = dump.get("reason")
    if reason not in set(DUMP_REASONS.values()):
        raise ValueError(
            f"not a train-health dump (reason={reason!r}, expected one "
            f"of {sorted(set(DUMP_REASONS.values()))})")
    ctx = dump.get("context", {})
    metrics = dump.get("metrics", {})

    def gauge(name):
        fam = metrics.get(name) or {}
        kids = fam.get("children", {})
        if list(kids) == [""]:
            return kids[""].get("value")
        return {k: v.get("value") for k, v in kids.items()}

    breach_events = [s for s in dump.get("spans", [])
                     if s.get("name") == "train_health_breach"]
    return {
        "reason": reason,
        "check": ctx.get("check"),
        "context": dict(ctx),
        "loss": gauge("train_loss"),
        "gnorm": gauge("train_grad_norm"),
        "group_grad_norm": gauge("train_group_grad_norm"),
        "group_update_ratio": gauge("train_group_update_ratio"),
        "breach_events": len(breach_events),
        "spans": len(dump.get("spans", [])),
    }
