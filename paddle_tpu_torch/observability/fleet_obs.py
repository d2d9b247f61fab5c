"""Fleet observability plane of the PyTorch port: per-rank mirroring, cross-process
aggregation, straggler detection.

Every surface under this package (registry, span ring, SLO engine,
time series) is process-local; the fleet shapes the ROADMAP asks for —
multi-replica serving behind one gateway, MegaScale-style cross-host
straggler detection — need ONE view over N processes before any
routing, drain, or scaling decision can be proven. Three pieces, same
design constraints as the rest of the package (stdlib-only at import,
lock-protected, host-side only):

* ``RankExporter`` — cadence-gated atomic mirror of a rank's registry
  snapshot + span-ring digest into a shared fleet directory
  (``fleet_rank_<r>.json``, latest-wins, tmp+rename so a reader never
  sees a torn file) plus a merged manifest. Every export is stamped
  with the fleet run id, rank, world size, a sequence number, and a
  clock block (wall / monotonic / perf_counter-µs) — the
  monotonic-clock offset marker: rank clocks are NOT comparable, so
  consumers window each rank on its own timebase and the stamp is
  what lets a viewer line lanes up. Re-arm-adoptable like the flight
  recorder: a restarted rank adopts its previous file's sequence
  instead of rewinding it.
* aggregation — :func:`merge_snapshots` folds N rank snapshots into a
  fleet view: counters sum EXACTLY (deterministic ascending-rank
  order, so the result is bit-equal to a plain sum of the per-rank
  values), fixed-bucket histograms merge EXACTLY (element-wise bucket
  sums — fleet p50/p95/p99 are real quantiles over the pooled
  observations, not averages of per-rank quantiles), and gauges keep
  their per-rank values under an appended ``rank`` label (bounded by
  world size at construction — GL112-safe) plus min/max/mean/skew
  rollups. :func:`snapshot_from_prometheus` rebuilds the same
  snapshot shape from a live ``/metrics`` scrape (de-cumulating the
  bucket series), so aggregation works from scrapes and mirror files
  alike.
* ``FleetMonitor`` — per-rank :class:`~.timeseries.TimeSeries` rings
  fed by ``ingest()`` (seq-gated), comparing each rank's windowed
  ``dispatch_seconds`` / step-phase / collective-wait mean against the
  median of the OTHER ranks with a MAD margin (leave-one-out: a
  straggler must not pollute its own baseline; ``min_count`` guards
  thin windows). A breach lands
  ``fleet_straggler_breaches_total{check}``, a ``fleet_straggler``
  timeline event on the merged span ring, and a ``fleet_straggler``
  flight dump naming the offending rank with both witness bucket
  distributions. The monitor's own ring carries every rank's spans on
  namespaced lanes (``r<rank>:<request>``), so the dump replays in
  tools/request_trace.py as merged per-rank lanes.

A copy of ``paddle_tpu/observability/fleet_obs.py`` (stdlib plus this
package's ``exporters``, ``metrics``, ``timeseries`` and ``tracing``),
kept apart so the PyTorch package imports nothing of the JAX package; the
schema strings are the JAX module's, so snapshots and views of either
package read in the other. Held stdlib-only by
``tools/torch_metrics_snapshot.py --selfcheck`` under a blocked torch
import.
"""
import json
import math
import os
import threading
import time

try:
    import fcntl
except ImportError:         # not POSIX: the manifest goes unlocked
    fcntl = None

from .exporters import parse_prometheus
from .metrics import get_registry
from .timeseries import TimeSeries
from .tracing import FlightRecorder, SpanRecorder, get_tracer

__all__ = [
    "RankExporter", "FleetMonitor", "merge_snapshots",
    "snapshot_from_prometheus", "merged_quantile", "gauge_rollups",
    "load_rank_snapshot", "load_fleet_manifest", "discover_snapshots",
    "SNAPSHOT_SCHEMA", "FLEET_MANIFEST_SCHEMA", "FLEET_VIEW_SCHEMA",
    "FLEET_MANIFEST_NAME", "STRAGGLER_REASON", "DEFAULT_CHECKS",
]

SNAPSHOT_SCHEMA = "paddle_tpu.fleet_rank_snapshot/1"
FLEET_MANIFEST_SCHEMA = "paddle_tpu.fleet_manifest/1"
FLEET_VIEW_SCHEMA = "paddle_tpu.fleet_view/1"
FLEET_MANIFEST_NAME = "fleet_manifest.json"
STRAGGLER_REASON = "fleet_straggler"

# (check label, histogram family) pairs the monitor compares across
# ranks by default: serving dispatch, the train step-phase split, and
# eager collective wait — the distributions a straggling host skews
# first. Families a workload never records simply contribute no window.
DEFAULT_CHECKS = (
    ("dispatch", "dispatch_seconds"),
    ("step", "train_step_seconds"),
    ("data_wait", "train_data_wait_seconds"),
    ("host", "train_host_seconds"),
    ("collective", "collective_seconds"),
)


def _rank_file(rank):
    return f"fleet_rank_{int(rank)}.json"


# -- loaders (stdlib-only validation, load_dump contract) -------------------

def load_rank_snapshot(path):
    """Load + schema-validate one rank mirror file. Raises ValueError
    on anything that is not a v1 rank snapshot, OSError when absent."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) \
            or data.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"{path}: not a {SNAPSHOT_SCHEMA} snapshot (schema="
            f"{data.get('schema') if isinstance(data, dict) else None!r})")
    missing = {"run_id", "rank", "world_size", "seq", "clock",
               "metrics", "spans"} - set(data)
    if missing:
        raise ValueError(f"{path}: snapshot missing keys "
                         f"{sorted(missing)}")
    clock = data["clock"]
    if not isinstance(clock, dict) \
            or not {"time", "monotonic", "perf_us"} <= set(clock):
        raise ValueError(f"{path}: malformed clock block")
    if not isinstance(data["metrics"], dict) \
            or not isinstance(data["spans"], list):
        raise ValueError(f"{path}: metrics/spans have the wrong shape")
    return data


def load_fleet_manifest(fleet_dir):
    """Load + schema-validate ``<dir>/fleet_manifest.json``."""
    path = os.path.join(str(fleet_dir), FLEET_MANIFEST_NAME)
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) \
            or data.get("schema") != FLEET_MANIFEST_SCHEMA:
        raise ValueError(
            f"{path}: not a {FLEET_MANIFEST_SCHEMA} manifest (schema="
            f"{data.get('schema') if isinstance(data, dict) else None!r})")
    ranks = data.get("ranks")
    if not isinstance(ranks, dict):
        raise ValueError(f"{path}: manifest ranks is not a dict")
    for r, e in ranks.items():
        if not {"file", "seq", "time"} <= set(e):
            raise ValueError(
                f"{path}: manifest entry for rank {r} malformed: "
                f"{sorted(e)}")
    return data


def discover_snapshots(fleet_dir, run_id=None):
    """Latest snapshot per rank from a fleet dir: {rank: payload}.
    The manifest indexes the dir but the rank FILES are the authority
    (a lost manifest race self-heals on the next export); unreadable
    or foreign-run files are skipped, never fatal — aggregation must
    work mid-rollout."""
    out = {}
    try:
        names = os.listdir(str(fleet_dir))
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("fleet_rank_")
                and name.endswith(".json")):
            continue
        try:
            snap = load_rank_snapshot(os.path.join(str(fleet_dir), name))
        except (OSError, ValueError):
            continue
        if run_id is not None and snap["run_id"] != run_id:
            continue
        out[int(snap["rank"])] = snap
    return out


# -- per-rank mirroring -----------------------------------------------------

class RankExporter:
    """Cadence-gated atomic mirror of this rank's registry + span ring.

    ``maybe_export()`` is the hot-path entry: a monotonic-clock gate,
    then one snapshot + one tmp-write + one rename. The span digest
    carries only spans that CLOSED since the previous export (disjoint
    windows on the perf_counter watermark), so a monitor ingesting
    every seq sees each span exactly once. Re-arming a restarted rank
    over an existing fleet dir adopts its previous file's seq — the
    flight-recorder adoption idiom — so downstream seq-gating keeps
    rejecting stale files instead of re-ingesting history."""

    def __init__(self, fleet_dir, rank, world_size, run_id="fleet",
                 interval_s=2.0, registry=None, recorder=None):
        rank, world_size = int(rank), int(world_size)
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} outside world of {world_size}")
        self.fleet_dir = str(fleet_dir)
        self.rank = rank
        self.world_size = world_size
        self.run_id = str(run_id)
        self.interval_s = float(interval_s)
        self.registry = registry      # None = the process registry
        self.recorder = recorder      # None = the process tracer
        self.path = os.path.join(self.fleet_dir, _rank_file(rank))
        self._lock = threading.Lock()
        self._last_export = None      # monotonic of last export
        self._span_wm_us = 0.0        # perf_counter watermark (µs)
        self._seq = 0
        self.exports = 0              # files written this process
        # adoption: continue the previous incarnation's sequence
        try:
            prev = load_rank_snapshot(self.path)
            if prev["run_id"] == self.run_id \
                    and int(prev["rank"]) == rank:
                self._seq = int(prev["seq"])
        except (OSError, ValueError):
            pass

    @property
    def seq(self):
        with self._lock:
            return self._seq

    def maybe_export(self, now=None):
        """Export when the cadence elapsed; returns the path or None.
        Cheap when gated: one monotonic read under the lock."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self._last_export is not None \
                    and now - self._last_export < self.interval_s:
                return None
        return self.export(now=now)

    def export(self, now=None):
        """Unconditional export; returns the written path."""
        now = time.monotonic() if now is None else float(now)
        reg = self.registry if self.registry is not None \
            else get_registry()
        # `is not None`: an EMPTY custom ring is falsy (__len__)
        rec = self.recorder if self.recorder is not None \
            else get_tracer()
        now_us = time.perf_counter() * 1e6
        with self._lock:
            wm = self._span_wm_us
            self._span_wm_us = now_us
            self._seq += 1
            seq = self._seq
            self._last_export = now
        spans = [s for s in rec.spans(since_us=wm)
                 if wm < s["ts_us"] + s["dur_us"] <= now_us]
        payload = {
            "schema": SNAPSHOT_SCHEMA,
            "run_id": self.run_id,
            "rank": self.rank,
            "world_size": self.world_size,
            "seq": seq,
            "clock": {"time": time.time(), "monotonic": now,
                      "perf_us": now_us},
            "metrics": reg.snapshot(),
            "spans": spans,
            "span_stats": {"exported": len(spans),
                           "recorded_total": rec.recorded_total},
        }
        os.makedirs(self.fleet_dir, exist_ok=True)
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, self.path)
        self._update_manifest(seq, payload["clock"]["time"])
        with self._lock:
            self.exports += 1
        return self.path

    def _update_manifest(self, seq, wall):
        """Read-merge-write the shared manifest (this rank's entry
        only), under an exclusive ``flock`` of a lock file beside it:
        ranks that export at the same moment (a training step in lock
        step over a collective ends on every rank at once) would
        otherwise lose each other's entry between read and rename, and
        a last export has no later one to mend it. discover_snapshots
        still treats the rank FILES as authority, the manifest as an
        index."""
        path = os.path.join(self.fleet_dir, FLEET_MANIFEST_NAME)
        try:
            with open(path + ".lock", "a") as lock:
                if fcntl is not None:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    data = load_fleet_manifest(self.fleet_dir)
                except (OSError, ValueError):
                    data = {"schema": FLEET_MANIFEST_SCHEMA, "ranks": {}}
                data["run_id"] = self.run_id
                data["world_size"] = self.world_size
                data["ranks"][str(self.rank)] = {
                    "file": _rank_file(self.rank), "seq": seq,
                    "time": wall}
                tmp = path + f".tmp.{self.rank}"
                with open(tmp, "w") as f:
                    json.dump(data, f, indent=1)
                os.replace(tmp, path)
        except OSError:
            pass                    # the next export retries


# -- aggregation ------------------------------------------------------------

def _skew(vals):
    """Fisher-Pearson moment skewness; 0.0 for degenerate spreads."""
    n = len(vals)
    mean = sum(vals) / n
    m2 = sum((v - mean) ** 2 for v in vals) / n
    if m2 <= 0:
        return 0.0
    m3 = sum((v - mean) ** 3 for v in vals) / n
    return m3 / m2 ** 1.5


def merge_snapshots(snapshots):
    """Fold N rank snapshots into one fleet view.

    `snapshots`: rank-snapshot payloads (RankExporter files), raw
    ``registry.snapshot()`` dicts, or a {rank: payload} mapping.
    Ranks merge in ascending order, so float counter sums are
    DETERMINISTIC — bit-equal to summing the per-rank values in the
    same order (what the gate asserts). Histograms must agree on
    bucket edges (they are fixed at construction; a mismatch means
    two code versions and raises). Gauges keep every per-rank value
    under an appended ``rank`` label — bounded by world size, never
    by traffic (GL112) — with min/max/mean/skew rollups per child.
    """
    if isinstance(snapshots, dict):
        items = [snapshots[k] for k in sorted(snapshots)]
    else:
        items = list(snapshots)
        items.sort(key=lambda p: int(p.get("rank", 0))
                   if isinstance(p.get("rank", 0), (int, float, str))
                   else 0)
    ranks, metrics_by_rank, world = [], [], 0
    for i, p in enumerate(items):
        if "metrics" in p and "kind" not in p.get("metrics", {}):
            rank = int(p.get("rank", i))
            world = max(world, int(p.get("world_size", 0)))
            metrics = p["metrics"]
        else:
            rank, metrics = i, p
        if rank in ranks:
            raise ValueError(f"duplicate rank {rank} in merge")
        ranks.append(rank)
        metrics_by_rank.append(metrics)
    world = max(world, len(ranks))
    merged, rollups = {}, {}
    timeline = {"samples": 0, "capacity": 0, "dropped": 0}
    per_rank_gauges = {}        # (family, ckey) -> [(rank, value)]
    for rank, metrics in zip(ranks, metrics_by_rank):
        for name, fam in metrics.items():
            kind = fam.get("kind")
            if name == "_timeline" or kind == "meta":
                for k in timeline:
                    timeline[k] += int(fam.get(k, 0) or 0)
                continue
            if kind not in ("counter", "gauge", "histogram"):
                continue
            ent = merged.get(name)
            if ent is None:
                ent = merged[name] = {
                    "kind": kind, "help": fam.get("help", ""),
                    "labelnames": list(fam.get("labelnames") or ()),
                    "children": {}}
                if kind == "histogram":
                    ent["buckets"] = list(fam["buckets"])
                if kind == "gauge":
                    ent["labelnames"] = ent["labelnames"] + ["rank"]
            else:
                if ent["kind"] != kind:
                    raise ValueError(
                        f"{name}: kind mismatch across ranks "
                        f"({ent['kind']} vs {kind})")
                if kind == "histogram" \
                        and list(fam["buckets"]) != ent["buckets"]:
                    raise ValueError(
                        f"{name}: bucket edges differ across ranks — "
                        "exact histogram merge needs one edge set")
            for ckey, child in (fam.get("children") or {}).items():
                if kind == "counter":
                    c = ent["children"].setdefault(ckey, {"value": 0.0})
                    c["value"] += float(child["value"])
                elif kind == "histogram":
                    c = ent["children"].get(ckey)
                    counts = child["bucket_counts"]
                    if c is None:
                        ent["children"][ckey] = {
                            "bucket_counts": list(counts),
                            "sum": float(child["sum"]),
                            "count": int(child["count"])}
                    else:
                        if len(counts) != len(c["bucket_counts"]):
                            raise ValueError(
                                f"{name}: bucket count width differs")
                        c["bucket_counts"] = [
                            a + b for a, b in
                            zip(c["bucket_counts"], counts)]
                        c["sum"] += float(child["sum"])
                        c["count"] += int(child["count"])
                else:           # gauge: per-rank child + rollup input
                    nkey = f"{ckey},{rank}" if ckey else str(rank)
                    ent["children"][nkey] = {
                        "value": float(child["value"])}
                    per_rank_gauges.setdefault(
                        (name, ckey), []).append(
                            (rank, float(child["value"])))
    for (name, ckey), pairs in sorted(per_rank_gauges.items()):
        vals = [v for _, v in pairs]
        rollups.setdefault(name, {})[ckey] = {
            "min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals), "skew": _skew(vals),
            "per_rank": {str(r): v for r, v in pairs}}
    merged["_timeline"] = {"kind": "meta", "help": "",
                           "labelnames": [], "children": {},
                           **timeline}
    return {"schema": FLEET_VIEW_SCHEMA, "ranks": ranks,
            "world_size": world, "metrics": merged, "gauges": rollups}


def gauge_rollups(view, name):
    """{child-key: {min,max,mean,skew,per_rank}} for one gauge family
    of a merged view (empty when the family recorded nothing)."""
    return view.get("gauges", {}).get(name, {})


def _hist_quantile(buckets, counts, q, total=None):
    """Histogram.quantile interpolation on explicit edges + counts."""
    if not 0 <= q <= 1:
        raise ValueError(f"quantile {q} outside [0, 1]")
    total = sum(counts) if total is None else total
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= rank and c:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            if hi <= lo:
                return hi
            return lo + (hi - lo) * max(0.0, rank - cum) / c
        cum += c
    return buckets[-1]


def merged_quantile(view, name, q, child=""):
    """Real fleet quantile of a merged histogram family: interpolated
    over the POOLED bucket counts (Histogram.quantile semantics), not
    an average of per-rank quantiles. None when the family/child is
    absent or empty."""
    fam = view.get("metrics", {}).get(name)
    if fam is None or fam.get("kind") != "histogram":
        return None
    c = fam["children"].get(child)
    if c is None:
        return None
    return _hist_quantile(fam["buckets"], c["bucket_counts"], q,
                          total=c["count"])


def snapshot_from_prometheus(text):
    """Rebuild a ``registry.snapshot()``-shaped dict from text
    exposition 0.0.4 (the inverse of exporters.to_prometheus via
    parse_prometheus), de-cumulating histogram bucket series — so
    merge_snapshots works identically from live /metrics scrapes and
    mirror files. Untyped families parse as gauges."""
    snap = {}
    for fname, fam in parse_prometheus(text).items():
        samples = fam["samples"]
        if not samples:
            continue
        kind = fam["kind"] or "gauge"
        if kind == "histogram":
            labelnames, per = None, {}
            for sname, labels, val in samples:
                base = {k: v for k, v in labels.items() if k != "le"}
                if labelnames is None:
                    labelnames = list(base)
                key = ",".join(str(base.get(k, "")) for k in labelnames)
                d = per.setdefault(key, {"cum": [], "sum": 0.0,
                                         "count": 0})
                if sname.endswith("_bucket"):
                    d["cum"].append((float(labels.get("le", "inf")
                                           if labels.get("le") not in
                                           ("+Inf", None)
                                           else math.inf), val))
                elif sname.endswith("_sum"):
                    d["sum"] = float(val)
                elif sname.endswith("_count"):
                    d["count"] = int(val)
            edges = None
            children = {}
            for key, d in per.items():
                cum = sorted(d["cum"])
                child_edges = [e for e, _ in cum if math.isfinite(e)]
                if edges is None:
                    edges = child_edges
                elif child_edges != edges:
                    raise ValueError(
                        f"{fname}: bucket edges differ across children")
                counts, prev = [], 0.0
                for _, c in cum:
                    if c < prev:
                        raise ValueError(
                            f"{fname}: non-monotonic bucket series")
                    counts.append(int(c - prev))
                    prev = c
                if len(counts) == len(edges):    # no +Inf series seen
                    counts.append(max(0, d["count"] - int(prev)))
                children[key] = {"bucket_counts": counts,
                                 "sum": d["sum"], "count": d["count"]}
            if not edges:
                continue
            snap[fname] = {"kind": "histogram",
                           "help": fam["help"] or "",
                           "labelnames": labelnames or [],
                           "buckets": edges, "children": children}
        else:
            labelnames, children = None, {}
            for _, labels, val in samples:
                if labelnames is None:
                    labelnames = list(labels)
                key = ",".join(str(labels.get(k, ""))
                               for k in labelnames)
                children[key] = {"value": float(val)}
            snap[fname] = {"kind": kind, "help": fam["help"] or "",
                           "labelnames": labelnames or [],
                           "children": children}
    return snap


# -- straggler detection ----------------------------------------------------

def _median(vals):
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


class FleetMonitor:
    """Cross-rank straggler detector on per-rank TimeSeries rings.

    ``ingest()`` replays one rank snapshot into that rank's ring
    (seq-gated: stale or replayed files are dropped) and copies its
    span digest onto the monitor's merged ring under a namespaced lane
    (``r<rank>:<request>``; rankless spans land on ``r<rank>``).
    ``check()`` compares, per configured (check, histogram-family)
    pair, each rank's windowed mean against the median of the OTHER
    ranks (leave-one-out — the straggler must not drag its own
    baseline) with margin ``mad_factor * MAD(others) + abs_floor_s``
    and a ``min_count`` guard against thin windows. Every rank's
    window is computed on ITS OWN monotonic clock (the snapshot's
    clock stamp) — fleet clocks are never mixed. A breach lands the
    ``fleet_straggler_breaches_total{check}`` counter, a timeline
    event, and a ``fleet_straggler`` flight dump carrying both
    witness distributions (the rank's and the pooled others')."""

    def __init__(self, fleet_dir=None, run_id=None, window_s=30.0,
                 min_count=8, mad_factor=4.0, abs_floor_s=0.005,
                 checks=None, registry=None, recorder=None,
                 flight=None, dump_dir=None, min_interval_s=30.0,
                 capacity=512):
        self.fleet_dir = None if fleet_dir is None else str(fleet_dir)
        self.run_id = run_id
        self.window_s = float(window_s)
        self.min_count = int(min_count)
        self.mad_factor = float(mad_factor)
        self.abs_floor_s = float(abs_floor_s)
        self.checks = tuple(checks if checks is not None
                            else DEFAULT_CHECKS)
        self.registry = registry      # None = the process registry
        self.capacity = int(capacity)
        self.recorder = recorder if recorder is not None \
            else SpanRecorder(capacity=16384)
        # the dump covers the WHOLE merged ring, not a perf_counter
        # window: ingested spans keep their remote rank's perf_counter
        # timebase, so windowing them by the monitor's local clock
        # would silently drop skewed lanes — the bounded ring is the
        # retention here
        self.flight = flight if flight is not None else FlightRecorder(
            recorder=self.recorder, window_s=1e9,
            min_interval_s=min_interval_s)
        if dump_dir is not None:
            self.flight.arm(dump_dir)
        self._lock = threading.RLock()
        self._series = {}             # rank -> TimeSeries
        self._seen = {}               # rank -> last ingested seq
        self._now = {}                # rank -> latest monotonic stamp
        self._clock = {}              # rank -> latest clock block
        self._last_stats = {}         # check -> {rank: mean_s}
        self.breaches = []            # breach dicts, oldest first

    # -- ingestion --------------------------------------------------------
    def ingest(self, payload, validate=True):
        """Feed one rank snapshot; returns True when it advanced the
        rank's ring (False = stale/duplicate seq)."""
        if validate and payload.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(
                f"not a {SNAPSHOT_SCHEMA} payload: "
                f"{payload.get('schema')!r}")
        rank = int(payload["rank"])
        seq = int(payload["seq"])
        with self._lock:
            if self._seen.get(rank, 0) >= seq:
                return False
            self._seen[rank] = seq
            series = self._series.get(rank)
            if series is None:
                series = self._series[rank] = TimeSeries(
                    capacity=self.capacity)
            ts = float(payload["clock"]["monotonic"])
            self._now[rank] = ts
            self._clock[rank] = dict(payload["clock"])
        series.sample_snapshot(payload["metrics"], now=ts)
        lane = f"r{rank}"
        for s in payload.get("spans", ()):
            req = s.get("request")
            args = {k: v for k, v in (s.get("args") or {}).items()
                    if k not in ("name", "start_us", "dur_us",
                                 "request")}
            self.recorder.record_span(
                s["name"], s["ts_us"], s["dur_us"],
                request=f"{lane}:{req}" if req is not None else lane,
                **args)
        return True

    def poll(self, now=None):
        """Discover + ingest anything new in the fleet dir, then run
        the checks; returns the fresh breaches."""
        if self.fleet_dir is not None:
            for rank in sorted(
                    snaps := discover_snapshots(self.fleet_dir,
                                                run_id=self.run_id)):
                self.ingest(snaps[rank], validate=False)
        return self.check(now=now)

    # -- checking ---------------------------------------------------------
    def _rank_window(self, series, family, now_r):
        """Pooled (counts, sum, count) of every child of `family` in
        the rank's window; None when nothing (or mixed widths)."""
        tot_counts, tot_sum, tot_n, edges = None, 0.0, 0, None
        for sname in series.names():
            if sname != family \
                    and not sname.startswith(family + "{"):
                continue
            if series.kind(sname) != "histogram":
                continue
            d = series.hist_delta(sname, self.window_s, now=now_r)
            if d is None:
                continue
            counts, s, n = d
            if tot_counts is None:
                tot_counts = list(counts)
                edges = series._buckets.get(sname)
            elif len(counts) == len(tot_counts):
                tot_counts = [a + b for a, b in
                              zip(tot_counts, counts)]
            else:
                continue        # foreign bucket width: skip the child
            tot_sum += s
            tot_n += n
        if tot_counts is None or tot_n == 0:
            return None
        return tot_counts, tot_sum, tot_n, edges

    def check(self, now=None):
        """Run every configured check over the current rings; returns
        the list of fresh breach dicts (empty = healthy). `now` is
        accepted for API symmetry but each rank is windowed on its own
        snapshot clock — fleet clocks are never comparable."""
        del now
        fresh = []
        with self._lock:
            series_by_rank = dict(self._series)
            now_by_rank = dict(self._now)
        for check_name, family in self.checks:
            stats = {}          # rank -> (mean, counts, n, edges)
            for rank in sorted(series_by_rank):
                w = self._rank_window(series_by_rank[rank], family,
                                      now_by_rank[rank])
                if w is None:
                    continue
                counts, total, n, edges = w
                if n < self.min_count:
                    continue
                stats[rank] = (total / n, counts, n, edges)
            self._last_stats[check_name] = {
                r: v[0] for r, v in stats.items()}
            if len(stats) < 2:
                continue
            for rank in sorted(stats):
                mean, counts, n, edges = stats[rank]
                others = [stats[r][0] for r in stats if r != rank]
                med = _median(others)
                mad = _median([abs(m - med) for m in others])
                margin = self.mad_factor * mad + self.abs_floor_s
                if mean <= med + margin:
                    continue
                fleet_counts = None
                for r in sorted(stats):
                    if r == rank:
                        continue
                    c = stats[r][1]
                    if fleet_counts is None:
                        fleet_counts = list(c)
                    elif len(c) == len(fleet_counts):
                        fleet_counts = [a + b for a, b in
                                        zip(fleet_counts, c)]
                breach = {"check": check_name, "family": family,
                          "rank": rank, "mean_s": mean,
                          "median_s": med, "mad_s": mad,
                          "margin_s": margin, "count": n,
                          "window_s": self.window_s}
                fresh.append(breach)
                self._land(breach, counts, fleet_counts, edges)
        with self._lock:
            self.breaches.extend(fresh)
        return fresh

    def _land(self, breach, rank_counts, fleet_counts, edges):
        reg = self.registry if self.registry is not None \
            else get_registry()
        reg.counter(
            "fleet_straggler_breaches_total",
            help="cross-rank straggler breaches by check",
            labels=("check",)).labels(check=breach["check"]).inc()
        lane = f"r{breach['rank']}"
        self.recorder.event(
            STRAGGLER_REASON, request=lane, check=breach["check"],
            rank=breach["rank"], mean_s=breach["mean_s"],
            median_s=breach["median_s"])
        # witness distributions ride as JSON strings: flight context
        # is scalar/string-only by the _clean_value contract
        self.flight.trigger(
            STRAGGLER_REASON, request=lane, rank=breach["rank"],
            check=breach["check"], family=breach["family"],
            mean_s=breach["mean_s"], median_s=breach["median_s"],
            mad_s=breach["mad_s"], margin_s=breach["margin_s"],
            window_s=breach["window_s"], count=breach["count"],
            rank_hist=json.dumps(rank_counts),
            fleet_hist=json.dumps(fleet_counts),
            hist_buckets=json.dumps(list(edges or ())))

    # -- reporting --------------------------------------------------------
    def fleet_view(self):
        """merge_snapshots over the latest files in the fleet dir."""
        if self.fleet_dir is None:
            raise ValueError("monitor has no fleet_dir")
        return merge_snapshots(
            discover_snapshots(self.fleet_dir, run_id=self.run_id))

    def summary(self):
        """json-safe monitor state for dashboards/reports."""
        with self._lock:
            return {
                "ranks": sorted(self._seen),
                "seqs": {str(r): s for r, s in
                         sorted(self._seen.items())},
                "clocks": {str(r): dict(c) for r, c in
                           sorted(self._clock.items())},
                "checks": {c: {str(r): m for r, m in sorted(st.items())}
                           for c, st in
                           sorted(self._last_stats.items())},
                "breaches_total": len(self.breaches),
                "breaches": [dict(b) for b in self.breaches[-32:]],
            }
