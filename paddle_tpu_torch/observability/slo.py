"""Declarative serving SLOs + multi-window burn-rate evaluation.

A copy of ``paddle_tpu/observability/slo.py`` (stdlib only), kept apart
so the PyTorch package imports nothing of the JAX package.

The monitoring loop a production serving fleet runs NEXT TO the
scheduler: objectives are declared once (``p99 ttft < 0.5s``,
``kv_alloc_failure ratio < 0.1%``), and every evaluation asks the
time-series layer (timeseries.py) how fast each objective's error
budget is burning, SRE-style, over TWO windows at once:

* a **fast** window with a high burn threshold catches cliffs — a
  sudden regression torches the budget at 10x+ and should page within
  seconds;
* a **slow** window with a low threshold catches slow burns — a 2x
  burn never trips the fast alarm but exhausts a month's budget in two
  weeks.

Burn rate is the classic ratio: ``bad_fraction / error_budget``. For a
quantile objective (``p99 ttft < X``) the budget is ``1 - q`` (1% of
requests may exceed X) and the bad fraction is the share of the
window's observations above X (delta-histogram interpolation). For a
ratio objective (``kv_alloc_failure ratio < Z``) the budget is Z
itself and the bad fraction is ``delta(num) / delta(den)`` — a zero
budget means ANY bad event is an infinite burn.

A breach (burn >= the window's threshold) lands three ways at once so
an incident ships with its own evidence:

* ``slo_breaches_total{objective,window}`` counters in the registry,
* an ``slo_breach`` event on the engine's timeline lane,
* a flight-recorder ``slo_burn_rate`` trigger — the dump carries the
  last window of request spans + the full metrics snapshot (per-reason
  cooldown keeps a sustained breach from flooding the dump dir; the
  retention policy bounds it regardless).

``SLOMonitor`` packages a TimeSeries + SLOEngine behind the host-side
cadence hook the serving loop calls every step (``tick()`` — cheap
no-op until ``cadence_s`` elapsed). stdlib-only at import, same
contract as the rest of the package.
"""
import math
import time

from .metrics import get_registry
from .timeseries import TimeSeries
from .tracing import get_flight_recorder, get_tracer

__all__ = ["Objective", "SLOEngine", "SLOMonitor", "DEFAULT_WINDOWS",
           "REPORT_SCHEMA", "validate_report", "json_safe"]

REPORT_SCHEMA = "paddle_tpu.slo_report/1"

# SRE multi-window defaults: the fast window catches cliffs (a 14x burn
# exhausts ~1.7% of a 30-day budget per hour), the slow window catches
# slow burns a cliff detector never sees. Serving configs override both
# (the CI leg shrinks them to seconds).
DEFAULT_WINDOWS = (
    {"name": "fast", "window_s": 30.0, "burn_threshold": 14.0},
    {"name": "slow", "window_s": 300.0, "burn_threshold": 2.0},
)


class Objective:
    """One declarative SLO, JSON-friendly both ways.

    kind="quantile": `q` of `metric` (a histogram) must stay < `max` —
      budget = 1 - q, bad fraction = share of windowed observations
      above `max`.
    kind="ratio": delta(`num`) / delta(`den`) (two counters) must stay
      < `max` — budget = `max`, zero budget = any bad event breaches.
    `min_count` guards noise: a window with fewer observations (or a
    smaller denominator delta) than this does not evaluate at all —
    two slow requests at startup are not a p99 regression.
    """

    KINDS = ("quantile", "ratio")

    def __init__(self, name, kind, max, metric=None, q=None,
                 num=None, den=None, min_count=1):
        self.name = str(name)
        if kind not in self.KINDS:
            raise ValueError(f"objective {name}: unknown kind {kind!r} "
                             f"(have {self.KINDS})")
        self.kind = kind
        self.max = float(max)
        self.min_count = int(min_count)
        if kind == "quantile":
            if not metric or q is None or not 0 < float(q) < 1:
                raise ValueError(
                    f"objective {name}: quantile needs metric= and "
                    f"0 < q < 1 (got metric={metric!r} q={q!r})")
            if self.max <= 0:
                raise ValueError(f"objective {name}: max must be > 0")
            self.metric, self.q = str(metric), float(q)
            self.num = self.den = None
        else:
            if not num or not den:
                raise ValueError(
                    f"objective {name}: ratio needs num= and den=")
            if self.max < 0:
                raise ValueError(f"objective {name}: max must be >= 0")
            self.num, self.den = str(num), str(den)
            self.metric = self.q = None

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        return cls(d.pop("name"), d.pop("kind"), d.pop("max"), **d)

    def to_dict(self):
        out = {"name": self.name, "kind": self.kind, "max": self.max,
               "min_count": self.min_count}
        if self.kind == "quantile":
            out["metric"], out["q"] = self.metric, self.q
        else:
            out["num"], out["den"] = self.num, self.den
        return out

    def describe(self):
        if self.kind == "quantile":
            return (f"p{self.q * 100:g} {self.metric} < {self.max:g}")
        return f"{self.num}/{self.den} < {self.max:g}"

    # -- evaluation over one window --------------------------------------
    def evaluate(self, ts, window_s, now=None):
        """{'value','bad_fraction','burn_rate','count'} over the window
        ending at `now`, or None when the window holds too little data
        to judge (below min_count — absence of traffic is not health
        AND not a breach)."""
        if self.kind == "quantile":
            n = ts.count(self.metric, window_s, now=now)
            if n is None or n < self.min_count:
                return None
            bad = ts.fraction_over(self.metric, self.max, window_s,
                                   now=now) or 0.0
            budget = 1.0 - self.q
            burn = bad / budget if budget > 0 else (
                math.inf if bad > 0 else 0.0)
            return {"value": ts.quantile(self.metric, self.q, window_s,
                                         now=now),
                    "bad_fraction": bad, "burn_rate": burn, "count": n}
        dn = ts.delta(self.num, window_s, now=now)
        dd = ts.delta(self.den, window_s, now=now)
        if dn is None or dd is None or dd < self.min_count:
            return None
        bad = dn / dd
        burn = bad / self.max if self.max > 0 else (
            math.inf if bad > 0 else 0.0)
        return {"value": bad, "bad_fraction": bad, "burn_rate": burn,
                "count": dd}


class SLOEngine:
    """Evaluate objectives x windows against a TimeSeries; record
    breaches into the registry / timeline / flight recorder."""

    def __init__(self, objectives, windows=DEFAULT_WINDOWS,
                 timeseries=None, registry=None, recorder=None,
                 flight_recorder=None):
        self.objectives = [o if isinstance(o, Objective)
                           else Objective.from_dict(o) for o in objectives]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.windows = []
        for w in windows:
            w = dict(w)
            if float(w["window_s"]) <= 0 or float(w["burn_threshold"]) <= 0:
                raise ValueError(f"window {w}: window_s and "
                                 "burn_threshold must be > 0")
            self.windows.append({"name": str(w["name"]),
                                 "window_s": float(w["window_s"]),
                                 "burn_threshold":
                                     float(w["burn_threshold"])})
        self.timeseries = timeseries if timeseries is not None \
            else TimeSeries(registry=registry)
        self.registry = registry        # None = process registry
        self.recorder = recorder        # None = process tracer
        self.flight_recorder = flight_recorder  # None = process recorder
        self.evaluations = 0
        self.breaches_total = 0
        self.breach_counts = {}         # (objective, window) -> count
        self.last_report = None

    def _breach_counter(self):
        reg = self.registry if self.registry is not None else get_registry()
        return reg.counter(
            "slo_breaches_total",
            help="SLO burn-rate breaches (objective x evaluation window)",
            labels=("objective", "window"))

    def evaluate(self, now=None):
        """One pass over objectives x windows; returns (and stores) the
        report dict. Breaches increment slo_breaches_total, leave an
        slo_breach timeline event, and fire the flight recorder with
        reason `slo_burn_rate` (its per-reason cooldown rate-limits a
        sustained breach)."""
        now = time.monotonic() if now is None else float(now)
        rec = self.recorder if self.recorder is not None \
            else get_tracer()
        flight = self.flight_recorder if self.flight_recorder is not None \
            else get_flight_recorder()
        self.evaluations += 1
        report = {"schema": REPORT_SCHEMA, "now": now,
                  "windows": [dict(w) for w in self.windows],
                  "objectives": [], "breaches": 0,
                  "breaches_total": self.breaches_total}
        for obj in self.objectives:
            entry = {"name": obj.name, "kind": obj.kind,
                     "max": obj.max, "describe": obj.describe(),
                     "windows": {}, "breached": False}
            for w in self.windows:
                ev = obj.evaluate(self.timeseries, w["window_s"], now=now)
                if ev is None:
                    entry["windows"][w["name"]] = None
                    continue
                burn = ev["burn_rate"]
                breached = burn >= w["burn_threshold"]
                ev = dict(ev, burn_threshold=w["burn_threshold"],
                          breached=breached,
                          burn_rate=burn if math.isfinite(burn)
                          else float("inf"))
                entry["windows"][w["name"]] = ev
                if not breached:
                    continue
                entry["breached"] = True
                report["breaches"] += 1
                self.breaches_total += 1
                key = (obj.name, w["name"])
                self.breach_counts[key] = self.breach_counts.get(key, 0) + 1
                self._breach_counter().labels(
                    objective=obj.name, window=w["name"]).inc()
                burn_arg = burn if math.isfinite(burn) else -1.0
                rec.event("slo_breach", objective=obj.name,
                          window=w["name"], burn_rate=burn_arg,
                          value=ev["value"],
                          bad_fraction=ev["bad_fraction"])
                flight.trigger(
                    "slo_burn_rate", objective=obj.name,
                    window=w["name"], window_s=w["window_s"],
                    burn_rate=burn_arg, threshold=obj.max,
                    value=ev["value"], count=ev["count"])
            report["objectives"].append(entry)
        report["breaches_total"] = self.breaches_total
        self.last_report = report
        return report


def json_safe(obj):
    """Deep copy with non-finite floats spelled as strings ("+Inf",
    "-Inf", "NaN" — the Prometheus exposition spelling). A zero-budget
    ratio breach carries burn_rate = math.inf, which json.dump would
    emit as a bare ``Infinity`` literal — valid to Python's loads, but
    not RFC 8259 JSON, so jq/JS/Go consumers of a serve_monitor report
    would reject the whole file. The in-memory report keeps the real
    float (dashboards compare against thresholds); this runs at the
    serialization boundary only."""
    if isinstance(obj, float) and not math.isfinite(obj):
        if math.isnan(obj):
            return "NaN"
        return "+Inf" if obj > 0 else "-Inf"
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def validate_report(report):
    """Schema-check an SLO report (the serve_monitor JSON embeds one;
    stdlib-only, same contract as tracing.load_dump). Raises ValueError
    on anything that is not a v1 report; returns the report."""
    if not isinstance(report, dict) or report.get("schema") != REPORT_SCHEMA:
        raise ValueError(
            f"not a {REPORT_SCHEMA} report (schema="
            f"{report.get('schema') if isinstance(report, dict) else None!r})")
    missing = {"now", "windows", "objectives", "breaches",
               "breaches_total"} - set(report)
    if missing:
        raise ValueError(f"SLO report missing keys {sorted(missing)}")
    if not isinstance(report["objectives"], list):
        raise ValueError("SLO report objectives is not a list")
    for i, o in enumerate(report["objectives"]):
        if not {"name", "kind", "max", "windows", "breached"} <= set(o):
            raise ValueError(f"SLO report objective {i} malformed: "
                             f"{sorted(o)}")
        for wname, ev in o["windows"].items():
            if ev is None:
                continue
            if not {"burn_rate", "bad_fraction", "count",
                    "breached"} <= set(ev):
                raise ValueError(
                    f"SLO report objective {o['name']} window {wname} "
                    f"malformed: {sorted(ev)}")
    return report


class SLOMonitor:
    """TimeSeries + SLOEngine behind the serve loop's cadence hook.

    The engine calls ``tick()`` once per step (host-side, after the
    compiled step completed); until ``cadence_s`` has elapsed since the
    last evaluation that is one monotonic read and a compare. On
    cadence: one registry sample into the rings, one burn-rate pass.
    Construction is declarative (``SLOMonitor.from_config(json_dict)``)
    so a JSON config can carry the whole policy."""

    def __init__(self, objectives, windows=DEFAULT_WINDOWS,
                 cadence_s=1.0, capacity=1024, registry=None,
                 recorder=None, flight_recorder=None):
        if float(cadence_s) < 0:
            raise ValueError("cadence_s must be >= 0")
        self.cadence_s = float(cadence_s)
        self.timeseries = TimeSeries(registry=registry, capacity=capacity)
        self.engine = SLOEngine(objectives, windows=windows,
                                timeseries=self.timeseries,
                                registry=registry, recorder=recorder,
                                flight_recorder=flight_recorder)
        self._last = None
        self.ticks = 0

    @classmethod
    def from_config(cls, config, **overrides):
        """Build from a JSON-friendly dict: {"objectives": [...],
        "windows": [...], "cadence_s": ..., "capacity": ...} — the
        `monitor` block of a serving config."""
        kw = {"objectives": config["objectives"]}
        for k in ("windows", "cadence_s", "capacity"):
            if k in config:
                kw[k] = config[k]
        kw.update(overrides)
        return cls(**kw)

    @property
    def last_report(self):
        return self.engine.last_report

    @property
    def breaches_total(self):
        return self.engine.breaches_total

    def tick(self, now=None):
        """The per-step hook: no-op until the cadence elapses, then
        sample + evaluate. Returns the report when an evaluation ran,
        None otherwise."""
        now = time.monotonic() if now is None else float(now)
        if self._last is not None and now - self._last < self.cadence_s:
            return None
        self._last = now
        self.timeseries.sample(now)
        return self.engine.evaluate(now)

    def force(self, now=None):
        """Sample + evaluate regardless of cadence (end-of-run report)."""
        now = time.monotonic() if now is None else float(now)
        self._last = now
        self.timeseries.sample(now)
        return self.engine.evaluate(now)

    def report(self, now=None):
        """The /slo endpoint's view: the last cadence evaluation when
        one exists, else a fresh forced one — a gateway scraped before
        the first cadence tick still answers with a schema-valid
        report instead of null. Call on the thread that owns tick()
        (the gateway routes it through the stepper)."""
        rep = self.engine.last_report
        return rep if rep is not None else self.force(now)
