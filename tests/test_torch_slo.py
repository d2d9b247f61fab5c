"""The PyTorch port's observability additions held against the JAX
package on the same inputs: windowed time series over the registry,
the SLO engine and monitor (multi-window burn rates, breaches into the
registry), and the exporters (Prometheus text both ways, JSON snapshot,
chrome counters). Every scenario replays one script of registry
operations at explicit timestamps through each package's modules and
compares what comes out, exactly."""
import json
import math

import pytest

from paddle_tpu.observability import exporters as jax_exporters
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.observability import slo as jax_slo
from paddle_tpu.observability import timeseries as jax_timeseries
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu_torch.observability import exporters as port_exporters
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import slo as port_slo
from paddle_tpu_torch.observability import timeseries as port_timeseries
from paddle_tpu_torch.observability import tracing as port_tracing

PACKAGES = {
    "jax": (jax_metrics, jax_timeseries, jax_slo, jax_tracing,
            jax_exporters),
    "port": (port_metrics, port_timeseries, port_slo, port_tracing,
             port_exporters),
}

WINDOWS = ({"name": "fast", "window_s": 2.0, "burn_threshold": 14.0},
           {"name": "slow", "window_s": 60.0, "burn_threshold": 2.0})


def _canon(obj):
    """JSON text with non-finite floats spelled out, so NaN compares."""
    return json.dumps(obj, sort_keys=True, default=repr)


def _timeseries_script(pkg):
    metrics, timeseries, _, _, _ = pkg
    reg = metrics.MetricsRegistry()
    ts = timeseries.TimeSeries(registry=reg, capacity=6)
    c = reg.counter("req_total", labels=("route",))
    g = reg.gauge("depth")
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0, 10.0))
    h.labels()
    out = []
    for t in range(8):
        c.labels(route="a").inc(3 * t + 1)
        c.labels(route="b").inc(t % 3)
        g.set((t * 7) % 5)
        for k in range(10 * t + 1):
            h.observe(0.004 * (k % 17) + 0.5 * (k % 11 == 0) + 3.0 * (
                k % 29 == 0))
        ts.sample(now=float(t))
        for w in (0.5, 2.0, 5.0, 100.0):
            now = float(t) + 0.25
            out.append([
                ts.delta("req_total{route=a}", w, now=now),
                ts.rate("req_total{route=b}", w, now=now),
                ts.gauge_stats("depth", w, now=now),
                ts.count("lat_seconds", w, now=now),
                ts.hist_delta("lat_seconds", w, now=now),
                [ts.quantile("lat_seconds", q, w, now=now)
                 for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                [ts.fraction_over("lat_seconds", x, w, now=now)
                 for x in (0.005, 0.05, 0.5, 1.0, 10.0, 20.0)],
            ])
    reg.reset()
    reg.counter("req_total", labels=("route",)).labels(route="a").inc(2)
    ts.sample(now=9.0)
    out.append([ts.delta("req_total{route=a}", 5.0, now=9.0),
                ts.rate("req_total{route=a}", 5.0, now=9.0),
                ts.names(), ts.kind("lat_seconds"), ts.samples_taken,
                ts.dropped, ts.ring("depth")])
    return out


def _slo_engine(pkg, objectives, windows=WINDOWS):
    metrics, timeseries, slo, tracing, _ = pkg
    reg = metrics.MetricsRegistry()
    ts = timeseries.TimeSeries(registry=reg)
    ring = tracing.SpanRecorder()
    fr = tracing.FlightRecorder(recorder=ring, min_interval_s=0.0)
    eng = slo.SLOEngine(objectives, windows=windows, timeseries=ts,
                        registry=reg, recorder=ring, flight_recorder=fr)
    return reg, ts, eng, ring


TTFT = [{"name": "ttft_p99", "kind": "quantile", "metric": "ttft_seconds",
         "q": 0.99, "max": 0.1, "min_count": 5}]
RATIO = [{"name": "alloc_fail", "kind": "ratio",
          "num": "kv_alloc_failures_total", "den": "serve_tokens_total",
          "max": 0.0},
         {"name": "shed", "kind": "ratio", "num": "shed_total",
          "den": "serve_tokens_total", "max": 0.05, "min_count": 10}]


def _burn_script(pkg, kind):
    """Cliffs, slow burns, total outages and zero-budget ratios through
    SLOEngine.evaluate at explicit times; the reports, the breach
    counters and the breach events."""
    reg, ts, eng, ring = _slo_engine(pkg, TTFT if kind != "ratio"
                                     else RATIO)
    if kind == "ratio":
        fails = reg.counter("kv_alloc_failures_total")
        shed = reg.counter("shed_total")
        toks = reg.counter("serve_tokens_total")
        fails.inc(0)
        shed.inc(0)
        toks.inc(0)
    else:
        h = reg.histogram("ttft_seconds", buckets=(0.01, 0.1, 1.0))
        h.labels()
    ts.sample(now=0.0)
    reports = []
    for t in range(1, 40):
        if kind == "cliff":
            bad = t > 30
            for _ in range(40):
                h.observe(0.5 if bad else 0.05)
        elif kind == "slow_burn":
            for k in range(100):
                h.observe(0.5 if k < 3 else 0.05)
        elif kind == "outage":
            for _ in range(t % 4):
                h.observe(0.5)
        else:
            toks.inc(20)
            shed.inc(2 if 10 < t < 20 else 0)
            fails.inc(1 if t == 25 else 0)
        ts.sample(now=float(t))
        reports.append(eng.evaluate(now=float(t) + 0.5))
    breaches = reg.snapshot().get("slo_breaches_total", {})
    events = [(s["name"], sorted((s["args"] or {}).items()))
              for s in ring.spans() if s["name"] == "slo_breach"]
    return [_canon(pkg[2].json_safe(reports)), eng.breaches_total,
            sorted(eng.breach_counts.items()), _canon(breaches), events]


def _monitor_script(pkg):
    metrics, _, slo, tracing, _ = pkg
    reg = metrics.MetricsRegistry()
    ring = tracing.SpanRecorder()
    mon = slo.SLOMonitor.from_config(
        {"objectives": TTFT, "windows": list(WINDOWS), "cadence_s": 1.5,
         "capacity": 16},
        registry=reg, recorder=ring,
        flight_recorder=tracing.FlightRecorder(recorder=ring))
    h = reg.histogram("ttft_seconds", buckets=(0.01, 0.1, 1.0))
    out = [mon.report(now=0.0)]
    for k in range(24):
        now = 0.4 * k
        for j in range(k % 5 + 3):
            h.observe(0.05 if (j + k) % 4 else 0.4)
        out.append(mon.tick(now=now))
    out.append(mon.force(now=10.0))
    out.append(mon.report(now=11.0))
    return [_canon(out), mon.ticks, mon.breaches_total,
            mon.timeseries.samples_taken, mon.last_report["now"]]


SCRIPTS = {
    "timeseries": _timeseries_script,
    "cliff": lambda pkg: _burn_script(pkg, "cliff"),
    "slow_burn": lambda pkg: _burn_script(pkg, "slow_burn"),
    "outage": lambda pkg: _burn_script(pkg, "outage"),
    "ratio": lambda pkg: _burn_script(pkg, "ratio"),
    "monitor": _monitor_script,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_windows_and_burn_rates_equal_jax(script):
    got = SCRIPTS[script](PACKAGES["port"])
    ref = SCRIPTS[script](PACKAGES["jax"])
    assert _canon(got) == _canon(ref)


def test_breaches_are_reached_by_the_scripts():
    """The parity above compares something: the burn scripts breach."""
    for kind, n in (("cliff", 1), ("slow_burn", 1), ("outage", 1),
                    ("ratio", 1)):
        assert _burn_script(PACKAGES["port"], kind)[1] >= n, kind


def _filled_registry(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("gateway_responses_total",
                    help='responses "by" route\\code\nline two',
                    labels=("route", "code"))
    c.labels(route="generate", code="200").inc(7)
    c.labels(route='we"ird\\path\nx', code="aborted").inc()
    g = reg.gauge("kv_blocks_free", help="free blocks")
    g.set(12)
    g.set(11.5)
    reg.gauge("nan_gauge").set(math.nan)
    reg.gauge("inf_gauge", labels=("side",)).labels(side="hi").set(
        math.inf)
    reg.gauge("inf_gauge", labels=("side",)).labels(side="lo").set(
        -math.inf)
    h = reg.histogram("serve_ttft_seconds", help="ttft",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.004, 0.02, 0.02, 0.5, 3.0, 3.0):
        h.observe(v)
    hl = reg.histogram("gateway_request_seconds", labels=("route",),
                       buckets=(0.1, 1.0))
    hl.labels(route="metrics").observe(0.05)
    hl.labels(route="generate").observe(2.5)
    reg.counter("empty_total")
    return reg


def test_prometheus_text_and_parse_equal_jax():
    text = port_exporters.to_prometheus(_filled_registry(port_metrics))
    ref = jax_exporters.to_prometheus(_filled_registry(jax_metrics))
    assert text == ref
    got = port_exporters.parse_prometheus(text)
    assert _canon(got) == _canon(jax_exporters.parse_prometheus(ref))
    assert got["serve_ttft_seconds"]["kind"] == "histogram"
    assert any(lab.get("route") == 'we"ird\\path\nx'
               for _, lab, _ in got["gateway_responses_total"]["samples"])


@pytest.mark.parametrize("text", [
    "# TYPE a counter\na 1\n", "x{le=\"+Inf\"} +Inf\ny -Inf\nz NaN\n",
    "not a sample line\n", "m{a=\"1\",b=\"\\\\n\"} 2.5\n# random\n\n",
    "h_bucket{le=\"1\"} 1\n# TYPE h histogram\nh_sum 3\nh_count 1\n",
])
def test_parse_prometheus_equal_jax(text):
    def parse(mod):
        try:
            return _canon(mod.parse_prometheus(text))
        except ValueError as e:
            return f"ValueError: {e}"
    assert parse(port_exporters) == parse(jax_exporters)


def test_json_snapshot_and_chrome_counters_equal_jax():
    def run(pkg):
        metrics, _, _, _, exporters = pkg
        reg = _filled_registry(metrics)
        snap = json.loads(exporters.to_json(reg))
        timeline = snap["metrics"].pop("_timeline", None)
        events = exporters.chrome_counter_events(reg, pid=1)
        return [_canon(snap["metrics"]), timeline is not None,
                [(e["name"], e["ph"], e["args"], e["pid"]) for e in events]]
    got, ref = run(PACKAGES["port"]), run(PACKAGES["jax"])
    assert _canon(got) == _canon(ref)
    assert got[2], "the gauges left timeline samples"


def _reports():
    good = {"schema": jax_slo.REPORT_SCHEMA, "now": 1.0, "windows": [],
            "objectives": [{"name": "a", "kind": "ratio", "max": 0.0,
                            "windows": {"fast": None,
                                        "slow": {"burn_rate": math.inf,
                                                 "bad_fraction": 1.0,
                                                 "count": 3,
                                                 "breached": True}},
                            "breached": True}],
            "breaches": 1, "breaches_total": 4}
    return [good, dict(good, schema="other/1"), {"schema": None}, [],
            {k: v for k, v in good.items() if k != "breaches"},
            dict(good, objectives="x"),
            dict(good, objectives=[{"name": "a"}]),
            dict(good, objectives=[dict(good["objectives"][0], windows={
                "fast": {"burn_rate": 1.0}})])]


@pytest.mark.parametrize("i", range(len(_reports())))
def test_validate_report_and_json_safe_equal_jax(i):
    rep = _reports()[i]

    def verdict(slo):
        try:
            slo.validate_report(rep)
            return "ok"
        except ValueError as e:
            return f"ValueError: {e}"
    assert verdict(port_slo) == verdict(jax_slo)
    assert json.dumps(port_slo.json_safe(rep), sort_keys=True) == \
        json.dumps(jax_slo.json_safe(rep), sort_keys=True)
