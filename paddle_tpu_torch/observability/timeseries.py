"""Windowed time series over the metrics registry.

A copy of ``paddle_tpu/observability/timeseries.py`` (stdlib only), kept
apart so the PyTorch package imports nothing of the JAX package.

The registry answers "what is the cumulative state"; this module
answers "what happened in the LAST N SECONDS". A long-running server's
SLO is windowed by definition — "p99 TTFT over the last minute", not
"p99 since process start" (a process that was slow for its first hour
and fast ever since still reports an awful lifetime p99) — so the SLO
engine (slo.py) needs deltas between registry snapshots, not the
snapshots themselves.

One ``TimeSeries`` holds a bounded ring per metric child: ``sample()``
walks the registry under its lock and appends ``(ts, payload)`` — a
float for counters/gauges, ``(bucket_counts, sum, count)`` for
histograms — and the query side subtracts the sample at the window's
left edge from the newest one:

* ``rate(name, window_s)`` — counter increase per second over the window
  (None across a registry reset — a negative delta is a reset, not a
  rate).
* ``quantile(name, q, window_s)`` — delta-histogram quantile: the
  observations RECORDED INSIDE the window, interpolated exactly like
  ``Histogram.quantile`` (p99 TTFT over the last N seconds).
* ``fraction_over(name, threshold, window_s)`` — what share of the
  window's observations exceeded ``threshold`` (the burn-rate
  numerator: bad events / events).
* ``gauge_stats(name, window_s)`` — min/max/mean/last of the sampled
  gauge values in the window.

Same design constraints as the rest of the package: stdlib-only at
import (a monitoring sidecar loads this without torch),
lock-protected (the serve loop samples while an exporter reads), and
host-side only — every value came through the registry's ``float()``
tracer guard already. Timestamps default to ``time.monotonic()`` (the
latency-bookkeeping clock, immune to wall-clock jumps); every entry
point takes an explicit ``now=`` so tests and the selfcheck can replay
synthetic streams deterministically.
"""
import collections
import threading
import time

from .metrics import get_registry

__all__ = ["TimeSeries"]


class TimeSeries:
    """Bounded per-metric sample rings + windowed delta queries."""

    def __init__(self, registry=None, capacity=1024):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (windows need a "
                             "baseline sample and a newest sample)")
        self.registry = registry        # None = the process registry
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._rings = {}                # sample name -> deque[(ts, payload)]
        self._kinds = {}                # sample name -> metric kind
        self._buckets = {}              # sample name -> histogram edges
        self.samples_taken = 0          # sample() calls ever
        self.dropped = 0                # ring entries evicted (oldest)

    def _reg(self):
        return self.registry if self.registry is not None \
            else get_registry()

    # -- sampling ---------------------------------------------------------
    def sample(self, now=None):
        """Snapshot every registry child into its ring; returns the
        timestamp used. One registry-lock hold to copy, one own-lock
        hold to append — the serve loop calls this on a cadence, so the
        cost must stay far below a step."""
        reg = self._reg()
        now = time.monotonic() if now is None else float(now)
        rows = []
        with reg._lock:
            for name, fam in reg._metrics.items():
                for key, child in fam._children.items():
                    sname = fam._sample_name(key)
                    if fam.kind == "histogram":
                        rows.append((sname, "histogram", fam.buckets,
                                     (tuple(child.bucket_counts),
                                      child.sum, child.count)))
                    else:
                        rows.append((sname, fam.kind, None, child.value))
        self._append_rows(rows, now)
        return now

    def sample_snapshot(self, snapshot, now):
        """Append one ``registry.snapshot()`` DICT into the rings — the
        fleet-mirroring path (fleet_obs): a remote rank's exported
        snapshot replays into the same windowed machinery sample()
        feeds live, so delta/rate/quantile work identically on mirrored
        data. `now` is the REMOTE rank's monotonic clock (from its
        snapshot's clock stamp) — per-rank rings keep per-rank
        timebases, never mixed. Reserved meta entries ("_timeline")
        are skipped."""
        now = float(now)
        rows = []
        for name, fam in snapshot.items():
            kind = fam.get("kind")
            if name.startswith("_") or kind not in ("counter", "gauge",
                                                    "histogram"):
                continue
            labelnames = fam.get("labelnames") or []
            for ckey, child in (fam.get("children") or {}).items():
                if ckey:
                    kv = ",".join(f"{n}={v}" for n, v in
                                  zip(labelnames, ckey.split(",")))
                    sname = f"{name}{{{kv}}}"
                else:
                    sname = name
                if kind == "histogram":
                    rows.append((sname, kind, tuple(fam["buckets"]),
                                 (tuple(child["bucket_counts"]),
                                  float(child["sum"]),
                                  int(child["count"]))))
                else:
                    rows.append((sname, kind, None,
                                 float(child["value"])))
        self._append_rows(rows, now)
        return now

    def _append_rows(self, rows, now):
        with self._lock:
            self.samples_taken += 1
            for sname, kind, buckets, payload in rows:
                ring = self._rings.get(sname)
                if ring is None:
                    ring = self._rings[sname] = collections.deque(
                        maxlen=self.capacity)
                    self._kinds[sname] = kind
                    if buckets is not None:
                        self._buckets[sname] = tuple(buckets)
                if len(ring) == self.capacity:
                    self.dropped += 1
                ring.append((now, payload))

    # -- ring access ------------------------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._rings)

    def kind(self, name):
        with self._lock:
            return self._kinds.get(name)

    def ring(self, name):
        """Snapshot of one metric's ring, oldest first."""
        with self._lock:
            return list(self._rings.get(name, ()))

    def clear(self):
        with self._lock:
            self._rings.clear()
            self._kinds.clear()
            self._buckets.clear()

    def _window_pair(self, name, window_s, now):
        """(baseline, newest) samples for a delta over the window ending
        at `now`: baseline is the LAST sample at or before the window's
        left edge (so observations that landed just inside the window
        are counted), falling back to the oldest retained sample when
        the ring does not reach back that far (a partial window — the
        span actually covered rides back to the caller). None when
        fewer than two samples exist or nothing precedes `now`."""
        with self._lock:
            ring = list(self._rings.get(name, ()))
        upto = [s for s in ring if s[0] <= now]
        if len(upto) < 2:
            return None
        newest = upto[-1]
        left = now - float(window_s)
        baseline = None
        for s in upto:
            if s[0] <= left:
                baseline = s
            else:
                break
        if baseline is None:
            baseline = upto[0]
        if baseline[0] >= newest[0]:
            return None
        return baseline, newest

    # -- counter / gauge windows -----------------------------------------
    def delta(self, name, window_s, now=None):
        """Increase of a counter (or net change of a gauge) over the
        window. None without enough samples or across a counter reset
        (a negative counter delta can only be a registry reset)."""
        now = time.monotonic() if now is None else float(now)
        pair = self._window_pair(name, window_s, now)
        if pair is None:
            return None
        (t0, v0), (t1, v1) = pair
        d = v1 - v0
        if self._kinds.get(name) == "counter" and d < 0:
            return None
        return d

    def rate(self, name, window_s, now=None):
        """Per-second increase over the window (None like delta)."""
        now = time.monotonic() if now is None else float(now)
        pair = self._window_pair(name, window_s, now)
        if pair is None:
            return None
        (t0, v0), (t1, v1) = pair
        d = v1 - v0
        if self._kinds.get(name) == "counter" and d < 0:
            return None
        return d / (t1 - t0)

    def gauge_stats(self, name, window_s, now=None):
        """{'min','max','mean','last','samples'} of the sampled values
        inside the window (None when the window holds no samples)."""
        now = time.monotonic() if now is None else float(now)
        left = now - float(window_s)
        with self._lock:
            ring = list(self._rings.get(name, ()))
        vals = [v for ts, v in ring if left <= ts <= now]
        if not vals:
            return None
        return {"min": min(vals), "max": max(vals),
                "mean": sum(vals) / len(vals), "last": vals[-1],
                "samples": len(vals)}

    # -- histogram windows ------------------------------------------------
    def hist_delta(self, name, window_s, now=None):
        """(bucket_count_deltas incl +Inf, sum_delta, count_delta) of a
        histogram over the window; None without enough samples or
        across a reset."""
        now = time.monotonic() if now is None else float(now)
        pair = self._window_pair(name, window_s, now)
        if pair is None:
            return None
        (_, (b0, s0, c0)), (_, (b1, s1, c1)) = pair
        if c1 < c0 or len(b0) != len(b1):
            return None                 # registry reset / rebucketing
        counts = [a - b for a, b in zip(b1, b0)]
        if any(c < 0 for c in counts):
            return None
        return counts, s1 - s0, c1 - c0

    def count(self, name, window_s, now=None):
        """Observations a histogram recorded inside the window."""
        d = self.hist_delta(name, window_s, now=now)
        return None if d is None else d[2]

    def quantile(self, name, q, window_s, now=None):
        """Delta-histogram quantile: the q-quantile of the observations
        recorded INSIDE the window — linear interpolation inside the
        crossing bucket, values past the last finite edge clamp to it
        (Histogram.quantile semantics on the windowed delta)."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile {q} outside [0, 1]")
        d = self.hist_delta(name, window_s, now=now)
        if d is None or d[2] == 0:
            return None
        counts, _, total = d
        buckets = self._buckets[name]
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

    def fraction_over(self, name, threshold, window_s, now=None):
        """Share of the window's observations above `threshold` — the
        burn-rate numerator for latency objectives. Interpolates inside
        the bucket containing the threshold; the +Inf bucket counts
        fully above any threshold at or past the last finite edge
        (conservative: a threshold should sit inside the bucket range).
        None when the window recorded nothing."""
        threshold = float(threshold)
        d = self.hist_delta(name, window_s, now=now)
        if d is None or d[2] == 0:
            return None
        counts, _, total = d
        buckets = self._buckets[name]
        over = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else None   # +Inf
            if hi is not None and hi <= threshold:
                continue                # bucket entirely at/below
            if lo >= threshold or hi is None:
                over += c               # entirely above (or +Inf)
            else:
                over += c * (hi - threshold) / (hi - lo)
        return over / total
