#!/usr/bin/env python
"""Dump the PyTorch port's observability registry, or selfcheck it (the
port's form of ``tools/metrics_snapshot.py``).

* ``python tools/torch_metrics_snapshot.py [--format
  prometheus|json|chrome]`` prints the process-wide registry (useful
  embedded: ``from tools.torch_metrics_snapshot import dump``).
* ``python tools/torch_metrics_snapshot.py --selfcheck`` exercises every
  section of the JAX tool's selfcheck whose module the port has: the
  metrics core (registry, concurrency, histogram bucket edges, the three
  exporters with the 0.0.4 help-vs-label escaping split), the span ring
  (wraparound, concurrent recording, the arg guard), the flight-recorder
  dump schema and retention manifest, the windowed time series, the
  registry timeline ring, the SLO engine (breach -> counter +
  ``validate_report`` + ``slo_burn_rate`` dump), the cost catalog
  (record -> program_* gauges -> intensity / MFU / roofline against a
  synthetic device-complete time), the memory layer (synthetic census ->
  live_array gauges; MemoryMonitor breach -> ``hbm_pressure`` dump), the
  resilience families and dump schemas, the host-step families, the
  training health layer (telemetry spec, train_group_* families, the
  monitor's detector matrix and its four dump reasons, the instrumented
  loader's surfaces), the serving front door (SSE framing, validators,
  gateway families, the prometheus round trip), the router's policies
  and families, and the fleet layer (rank exporter, exact merges, the
  prometheus ingestion, the straggler monitor and its dump). It prints
  ``metrics selfcheck: OK`` or lists its problems, and exits non-zero on
  any. Not covered until the port has their modules: the kernel-autotune
  families (ROADMAP Queue 1 item 8) and the comm watchdog's collective
  telemetry (Queue 1 item 7).

The selfcheck runs stdlib-only: when ``paddle_tpu_torch`` is not already
imported, ``paddle_tpu_torch/observability`` (and ``serving``, under a
namespace stub for the package, whose ``__init__`` imports torch) load
BY PATH; that load failing IS a selfcheck failure.
"""
import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import types

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "paddle_tpu_torch"


def _load_observability():
    """The already-imported package when present; otherwise a standalone
    by-path load that never runs paddle_tpu_torch/__init__ (no torch)."""
    mod = sys.modules.get(f"{PKG}.observability")
    if mod is not None:
        return mod
    if PKG not in sys.modules:
        stub = types.ModuleType(PKG)
        stub.__path__ = [os.path.join(REPO_ROOT, PKG)]
        sys.modules[PKG] = stub
    pkg_dir = os.path.join(REPO_ROOT, PKG, "observability")
    spec = importlib.util.spec_from_file_location(
        f"{PKG}.observability", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"{PKG}.observability"] = mod
    spec.loader.exec_module(mod)
    return mod


def _load_serving():
    """paddle_tpu_torch.serving, stdlib-only, over the standalone
    observability load above (a namespace stub stands in for the
    package)."""
    mod = sys.modules.get(f"{PKG}.serving")
    if mod is not None:
        return mod
    _load_observability()
    return importlib.import_module(f"{PKG}.serving")


def dump(fmt="json", registry=None, obs=None):
    """Render the registry in one of the three exporter formats."""
    obs = obs or _load_observability()
    registry = registry or obs.get_registry()
    if fmt == "prometheus":
        return obs.to_prometheus(registry)
    if fmt == "json":
        return obs.to_json(registry, indent=1)
    if fmt == "chrome":
        return json.dumps({"traceEvents":
                           obs.chrome_counter_events(registry)}, indent=1)
    raise ValueError(f"unknown format {fmt!r}")


def selfcheck():
    """Exercise the metrics core; returns a list of failure strings."""
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    try:
        obs = _load_observability()
    except Exception as e:
        return [f"standalone (pre-torch) observability import failed: {e}"]

    reg = obs.MetricsRegistry()    # private registry: no global pollution

    # counters: monotonic, concurrent-exact
    c = reg.counter("sc_requests_total", help="selfcheck")
    threads = [threading.Thread(
        target=lambda: [c.inc() for _ in range(1000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(c.value == 8000, f"concurrent counter lost updates: {c.value}")
    try:
        c.inc(-1)
        check(False, "negative counter increment not rejected")
    except ValueError:
        pass

    # gauges: set/inc/dec/set_max, labels
    g = reg.gauge("sc_depth", labels=("queue",))
    g.labels(queue="a").set(3)
    g.labels(queue="a").inc(2)
    g.labels(queue="a").dec()
    check(g.labels(queue="a").value == 4.0,
          f"gauge arithmetic wrong: {g.labels(queue='a').value}")
    g.labels(queue="a").set_max(2)
    check(g.labels(queue="a").value == 4.0, "set_max lowered the gauge")

    # histograms: inclusive `le` edges, count/sum, quantiles
    h = reg.histogram("sc_latency_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.1, 0.5, 1.0, 5.0, 100.0):
        h.observe(v)
    child = h.labels()
    check(child.bucket_counts == [1, 2, 1, 1],
          f"bucket edges not inclusive-upper: {child.bucket_counts}")
    check(child.count == 5 and abs(child.sum - 106.6) < 1e-9,
          f"count/sum wrong: {child.count}/{child.sum}")
    q50 = h.quantile(0.5)
    check(q50 is not None and 0.1 <= q50 <= 1.0,
          f"median {q50} outside its bucket")
    check(reg.histogram("sc_latency_seconds") is h,
          "histogram get-or-create returned a different family")
    try:
        reg.counter("sc_latency_seconds")
        check(False, "kind conflict not rejected")
    except ValueError:
        pass

    # tracer guard: non-scalars must be rejected loudly
    try:
        reg.counter("sc_bad_total").inc(object())
        check(False, "non-scalar record not rejected")
    except TypeError:
        pass

    # exporters
    prom = obs.to_prometheus(reg)
    for needle in ("# TYPE sc_requests_total counter",
                   "# TYPE sc_depth gauge",
                   "# TYPE sc_latency_seconds histogram",
                   'sc_latency_seconds_bucket{le="+Inf"} 5',
                   'sc_depth{queue="a"} 4'):
        check(needle in prom, f"prometheus output missing {needle!r}")
    # exposition 0.0.4 escaping SPLIT: help text escapes only \ and
    # newline (quotes stay raw — help is unquoted); label VALUES escape
    # the quote too (they sit inside quotes)
    reg.counter('sc_esc_total', help='say "hi"\nback\\slash',
                labels=("q",)).labels(q='a"b\\c').inc()
    prom = obs.to_prometheus(reg)
    check('# HELP sc_esc_total say "hi"\\nback\\\\slash' in prom,
          "help escaping wrong (quotes must stay raw, \\n/\\\\ escape): "
          + [l for l in prom.splitlines()
             if l.startswith("# HELP sc_esc_total")][0])
    check('sc_esc_total{q="a\\"b\\\\c"} 1' in prom,
          "label-value escaping wrong: "
          + [l for l in prom.splitlines()
             if l.startswith("sc_esc_total{")][0])
    snap = json.loads(obs.to_json(reg))
    check(set(snap) == {"time", "metrics"}, "json envelope wrong")
    check(snap["metrics"]["sc_requests_total"]["children"][""]["value"]
          == 8000, "json snapshot value wrong")
    ev = obs.chrome_counter_events(reg, pid=1)
    check(len(ev) > 0, "no chrome counter samples recorded")
    check(all(e["ph"] == "C" and {"name", "ts", "dur", "pid", "tid",
                                  "args"} <= set(e) for e in ev),
          "chrome counter events malformed")

    # span recorder: bounded ring, wraparound, concurrent recording
    tr = obs.tracing.SpanRecorder(capacity=32)
    for i in range(50):
        tr.event("warm", request=0, i=i)
    check(len(tr) == 32 and tr.recorded_total == 50,
          f"ring wraparound wrong: len={len(tr)} "
          f"recorded={tr.recorded_total}")
    threads = [threading.Thread(
        target=lambda: [tr.event("t", request=1) for _ in range(500)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(len(tr) == 32 and tr.recorded_total == 50 + 2000,
          f"concurrent span recording lost appends: "
          f"{tr.recorded_total}")
    # recorded AFTER the storm so it survives the bounded ring into
    # the flight dump below
    with tr.span("prefill_chunk", request=7, width=4, granted=4):
        pass
    got = tr.spans(request=7)
    check(len(got) == 1 and got[0]["name"] == "prefill_chunk"
          and got[0]["args"]["width"] == 4 and got[0]["dur_us"] >= 0,
          f"span record malformed: {got}")
    try:
        tr.event("bad", v=object())
        check(False, "span arg guard let a non-scalar through")
    except TypeError:
        pass
    sev = obs.tracing.chrome_span_events(tr, pid=1)
    check(any(e["ph"] == "X" for e in sev)
          and any(e["ph"] == "M" for e in sev),
          "chrome span events missing X spans or M lane names")
    check(all({"name", "ph", "ts", "dur", "pid", "tid", "args"}
              <= set(e) for e in sev), "chrome span events malformed")

    # flight-recorder dump: write, stdlib-load, schema-validate
    fr = obs.tracing.FlightRecorder(recorder=tr)
    check(fr.trigger("sc_anomaly") is None,
          "disarmed flight recorder wrote a dump")
    d = tempfile.mkdtemp(prefix="sc_flightrec_")
    try:
        fr.arm(d, window_s=60.0)
        path = fr.trigger("sc_anomaly", request=7, step=3)
        check(path is not None and os.path.exists(path),
              "armed flight recorder wrote nothing")
        check(fr.trigger("sc_anomaly") is None,
              "per-reason cooldown did not rate-limit")
        dump = obs.tracing.load_dump(path)      # schema validation
        check(dump["reason"] == "sc_anomaly" and 7 in dump["requests"],
              f"dump content wrong: reason={dump['reason']} "
              f"requests={dump['requests']}")
        check(dump["context"].get("step") == 3,
              f"dump context lost: {dump['context']}")
        check(len(dump["spans"]) == len(tr),
              f"dump spans {len(dump['spans'])} != ring {len(tr)}")
        check(isinstance(dump["metrics"], dict),
              "dump metrics snapshot missing")
        digest = obs.tracing.request_summary(7, spans=dump["spans"])
        check(digest["prefill_chunks"] == [{"granted": 4,
                                            "requested": None}],
              f"request_summary from dump wrong: {digest}")
        # a truncated/foreign file must be REJECTED, not half-parsed
        bad = os.path.join(d, "not_a_dump.json")
        with open(bad, "w") as f:
            json.dump({"schema": "something/else"}, f)
        try:
            obs.tracing.load_dump(bad)
            check(False, "load_dump accepted a foreign schema")
        except ValueError:
            pass
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # timeseries ring: windowed rate / delta-quantile / gauge stats on
    # a synthetic clock (explicit now= — determinism is the contract)
    reg2 = obs.MetricsRegistry()
    ts = obs.TimeSeries(registry=reg2, capacity=8)
    c2 = reg2.counter("ts_total")
    h2 = reg2.histogram("ts_seconds", buckets=(0.1, 1.0, 10.0))
    g2 = reg2.gauge("ts_depth")
    c2.inc(0); g2.set(0)            # create children before sampling
    h2.observe(0.05)
    ts.sample(now=0.0)
    c2.inc(50)
    for v in (0.5, 0.5, 5.0):
        h2.observe(v)
    g2.set(4)
    ts.sample(now=10.0)
    check(ts.rate("ts_total", 10.0, now=10.0) == 5.0,
          f"windowed counter rate wrong: "
          f"{ts.rate('ts_total', 10.0, now=10.0)}")
    q = ts.quantile("ts_seconds", 0.5, 10.0, now=10.0)
    check(q is not None and 0.1 < q <= 1.0,
          f"delta-histogram median {q} outside its bucket (the 0.05 "
          "observed BEFORE the window must not count)")
    check(ts.count("ts_seconds", 10.0, now=10.0) == 3,
          "windowed observation count wrong")
    frac = ts.fraction_over("ts_seconds", 1.0, 10.0, now=10.0)
    check(frac is not None and abs(frac - 1 / 3) < 1e-9,
          f"fraction_over wrong: {frac} != 1/3")
    st = ts.gauge_stats("ts_depth", 20.0, now=10.0)
    check(st == {"min": 0.0, "max": 4.0, "mean": 2.0, "last": 4.0,
                 "samples": 2}, f"gauge stats wrong: {st}")
    for i in range(20):             # bounded ring: drops are counted
        ts.sample(now=20.0 + i)
    check(len(ts.ring("ts_total")) == 8 and ts.dropped > 0,
          f"timeseries ring not bounded: len="
          f"{len(ts.ring('ts_total'))} dropped={ts.dropped}")

    # registry timeline ring: overflow must be visible, not silent
    reg3 = obs.MetricsRegistry(timeline_capacity=4)
    g3 = reg3.gauge("tl_depth")
    for i in range(10):
        g3.set(i)
    tstats = reg3.timeline_stats()
    check(tstats == {"samples": 4, "capacity": 4, "dropped": 6},
          f"timeline drop accounting wrong: {tstats}")
    check(reg3.snapshot().get("_timeline", {}).get("dropped") == 6,
          "snapshot() does not carry the timeline drop count")

    # SLO engine: synthetic breach -> counter + schema + burn-rate
    # flight dump with retention manifest
    reg4 = obs.MetricsRegistry()
    ts4 = obs.TimeSeries(registry=reg4)
    lat = reg4.histogram("slo_ttft_seconds", buckets=(0.01, 0.1, 1.0))
    lat.observe(0.005)
    ts4.sample(now=0.0)
    for _ in range(10):
        lat.observe(0.5)            # 100% of the window over a 0.1 SLO
    ts4.sample(now=5.0)
    ring4 = obs.tracing.SpanRecorder()
    fr4 = obs.tracing.FlightRecorder(recorder=ring4, min_interval_s=0.0)
    eng = obs.SLOEngine(
        [{"name": "ttft_p99", "kind": "quantile",
          "metric": "slo_ttft_seconds", "q": 0.99, "max": 0.1}],
        windows=[{"name": "fast", "window_s": 10.0,
                  "burn_threshold": 14.0}],
        timeseries=ts4, registry=reg4, recorder=ring4,
        flight_recorder=fr4)
    d4 = tempfile.mkdtemp(prefix="sc_slo_")
    try:
        fr4.arm(d4, max_dumps=2)
        rep = eng.evaluate(now=5.0)
        obs.validate_report(rep)    # schema contract
        check(rep["breaches"] == 1 and eng.breaches_total == 1,
              f"synthetic cliff did not breach: {rep['breaches']}")
        ev = rep["objectives"][0]["windows"]["fast"]
        check(ev["breached"] and ev["burn_rate"] >= 14.0,
              f"burn rate wrong: {ev}")
        snap4 = reg4.snapshot()
        bc = snap4.get("slo_breaches_total", {}).get("children", {})
        check(sum(ch["value"] for ch in bc.values()) == 1,
              f"slo_breaches_total not counted: {bc}")
        dumps4 = [f for f in os.listdir(d4)
                  if f.startswith("flightrec_slo_burn_rate")]
        check(len(dumps4) == 1, f"no slo_burn_rate dump: {dumps4}")
        man = obs.tracing.load_manifest(d4)
        check([e["file"] for e in man["dumps"]] == dumps4
              and man["dumps"][0]["reason"] == "slo_burn_rate",
              f"retention manifest wrong: {man}")
        # a healthy stream must NOT breach: the cliff era ends at t=5;
        # by t=16 the 10s window holds only healthy observations
        lat2 = reg4.histogram("slo_ttft_seconds")
        ts4.sample(now=6.0)
        for _ in range(10):
            lat2.observe(0.005)
        ts4.sample(now=16.0)
        rep2 = eng.evaluate(now=16.0)
        check(eng.breaches_total == 1,
              f"healthy window breached: {rep2['breaches']}")
        ev2 = rep2["objectives"][0]["windows"]["fast"]
        check(ev2 is not None and ev2["burn_rate"] == 0.0
              and not ev2["breached"],
              f"healthy burn rate not zero: {ev2}")
        try:
            obs.validate_report({"schema": "something/else"})
            check(False, "validate_report accepted a foreign schema")
        except ValueError:
            pass
    finally:
        shutil.rmtree(d4, ignore_errors=True)

    # cost catalog: record -> program_* gauges -> derived MFU/roofline
    # against a synthetic device-complete time (all host numbers: the
    # counted calls are exercised by the cost gate,
    # tools/torch_cost_report.py)
    reg5 = obs.MetricsRegistry()
    cat = obs.CostCatalog(registry=reg5)
    e = cat.record("sc_step", flops=2e9, bytes_accessed=1e9,
                   arg_bytes=6e8, out_bytes=1e8, temp_bytes=3e8,
                   signature="s0")
    check(e["intensity"] == 2.0 and e["peak_hbm"] == 1e9,
          f"catalog intensity/peak wrong: {e}")
    snap5 = reg5.snapshot()
    for fam in ("program_flops", "program_bytes",
                "program_peak_hbm_bytes", "program_arithmetic_intensity"):
        v = snap5.get(fam, {}).get("children", {}).get("sc_step",
                                                       {}).get("value")
        check(v is not None and v > 0,
              f"catalog gauge {fam} missing from the snapshot: {v}")
    cat.observe_seconds("sc_step", 0.01)     # the device-complete time
    h5 = reg5.get("program_device_seconds")
    check(h5 is not None and h5._children[("sc_step",)].count == 1,
          "program_device_seconds not observed")
    derived = cat.derive(registry=reg5, peak_flops_override=1e12,
                         peak_bw_override=1e11)
    check(derived.get("sc_step", {}).get("device_s") == 0.01,
          f"derive did not divide by the observed time: {derived}")
    row = derived.get("sc_step")
    check(row is not None and row["mfu"] is not None
          and 0 < row["mfu"] <= 1.0,
          f"derived MFU wrong: {row}")
    # intensity 2.0 * bw 1e11 = 2e11 attainable < 1e12 peak: the
    # program is bandwidth-bound, so roofline_frac > mfu
    check(row["roofline_frac"] > row["mfu"],
          f"roofline did not clamp to bandwidth: {row}")
    check(reg5.snapshot()["program_mfu"]["children"]["sc_step"]["value"]
          == row["mfu"], "program_mfu gauge not set")
    # re-analysis updates, second signature recorded
    cat.record("sc_step", flops=4e9, bytes_accessed=1e9, signature="s1")
    ent = cat.entries()["sc_step"]
    check(ent["analyses"] == 2 and len(ent["signatures"]) == 2,
          f"catalog signature history wrong: {ent}")
    check(len(cat.table()) == 1 and cat.table()[0]["signatures"] == 2,
          "catalog table wrong")

    # memory layer: synthetic census -> gauges; monitor breach ->
    # hbm_pressure dump with a validated schema + context
    reg6 = obs.MetricsRegistry()
    census = {"kv_cache": {"count": 4, "bytes": 4096},
              "float32[8, 8]": {"count": 2, "bytes": 512}}
    obs.record_census(census, registry=reg6)
    snap6 = reg6.snapshot()
    check(snap6["live_arrays"]["children"]["kv_cache"]["value"] == 4
          and snap6["live_array_bytes_total"]["children"][""]["value"]
          == 4608, f"census gauges wrong")
    check(obs.census_diff(census, census) == {},
          "identical censuses diffed nonempty")
    diff = obs.census_diff(census, {"kv_cache": {"count": 5,
                                                 "bytes": 5120}})
    check(diff == {"kv_cache": {"count": 1, "bytes": 1024},
                   "float32[8, 8]": {"count": -2, "bytes": -512}},
          f"census diff wrong: {diff}")
    ring6 = obs.tracing.SpanRecorder()
    fr6 = obs.tracing.FlightRecorder(recorder=ring6, min_interval_s=0.0)
    try:
        obs.MemoryMonitor(min_headroom_frac=1.5)
        check(False, "min_headroom_frac >= 1 not rejected")
    except ValueError:
        pass
    mon = obs.MemoryMonitor(budget_bytes=1000.0, min_headroom_frac=0.2,
                            registry=reg6, flight_recorder=fr6)
    rep = mon.update(in_use_bytes=500.0)
    check(rep["pressure"] is False and rep["headroom_frac"] == 0.5,
          f"healthy headroom misreported: {rep}")
    d6 = tempfile.mkdtemp(prefix="sc_hbm_")
    try:
        fr6.arm(d6, window_s=60.0)
        rep = mon.update(in_use_bytes=950.0)
        check(rep["pressure"] is True and mon.pressure_events == 1,
              f"pressure not detected: {rep}")
        dumps = [f for f in os.listdir(d6)
                 if f.startswith("flightrec_hbm_pressure")]
        check(len(dumps) == 1, f"no hbm_pressure dump: {dumps}")
        if dumps:
            dump = obs.tracing.load_dump(os.path.join(d6, dumps[0]))
            check(dump["reason"] == "hbm_pressure"
                  and dump["context"].get("in_use_bytes") == 950
                  and dump["context"].get("budget_bytes") == 1000
                  and dump["context"].get("min_headroom_frac") == 0.2,
                  f"hbm_pressure dump context wrong: {dump['context']}")
        g6 = reg6.snapshot()
        check(g6["hbm_bytes_in_use"]["children"][""]["value"] == 950.0
              and g6["hbm_bytes_high_water"]["children"][""]["value"]
              == 950.0
              and abs(g6["hbm_headroom_frac"]["children"][""]["value"]
                      - 0.05) < 1e-9,
              "hbm gauges wrong after pressure update")
    finally:
        shutil.rmtree(d6, ignore_errors=True)

    # resilience telemetry: the preemption/cancel/shed
    # counter families, and the `preemption` / `operator_abort` dump
    # schemas with their request_summary digests — all stdlib-only
    reg7 = obs.MetricsRegistry()
    pre = reg7.counter("serve_preemptions_total", labels=("reason",))
    pre.labels(reason="kv_alloc").inc()
    pre.labels(reason="admission").inc(2)
    reg7.counter("serve_requests_cancelled_total").inc()
    reg7.counter("serve_requests_shed_total",
                 labels=("reason",)).labels(reason="slo_burn").inc()
    reg7.counter("serve_requests_failed_total",
                 labels=("reason",)).labels(
                     reason="kv_alloc_failure").inc()
    snap7 = reg7.snapshot()
    ch = snap7["serve_preemptions_total"]["children"]
    check(sum(c["value"] for c in ch.values()) == 3 and len(ch) == 2,
          f"preemption counter children wrong: {ch}")
    prom7 = obs.to_prometheus(reg7)
    check('serve_preemptions_total{reason="admission"} 2' in prom7,
          "preemption counter missing from exposition")
    ring7 = obs.tracing.SpanRecorder()
    ring7.event("submit", request="rq1", prompt_tokens=8, priority=2)
    ring7.event("preempt", request="rq1", reason="admission",
                priority=2, generated=3, blocks_freed=2)
    ring7.event("resume", request="rq1", generated=3, preemptions=1)
    ring7.event("retire", request="rq1", status="finished", generated=6,
                spec_drafted=0, spec_accepted=0)
    ring7.event("cancel", request="rq2", status="cancelled", generated=1)
    digest = obs.tracing.request_summary("rq1", recorder=ring7)
    check(digest["preemptions"] == 1 and digest["status"] == "finished"
          and digest["retired"],
          f"preempt/resume digest wrong: {digest}")
    digest2 = obs.tracing.request_summary("rq2", recorder=ring7)
    check(digest2["status"] == "cancelled" and not digest2["retired"],
          f"cancel digest wrong: {digest2}")
    fr7 = obs.tracing.FlightRecorder(recorder=ring7, min_interval_s=0.0)
    d7 = tempfile.mkdtemp(prefix="sc_resil_")
    try:
        fr7.arm(d7, window_s=60.0)
        p = fr7.trigger("preemption", request="rq1",
                        preempt_reason="kv_alloc", step=7,
                        blocks_freed=2, generated=3)
        dump = obs.tracing.load_dump(p)
        check(dump["reason"] == "preemption"
              and dump["context"].get("preempt_reason") == "kv_alloc"
              and dump["context"].get("blocks_freed") == 2
              and "rq1" in dump["requests"],
              f"preemption dump context wrong: {dump['context']}")
        check(any(s["name"] == "preempt" for s in dump["spans"]),
              "preemption dump lost the preempt event")
        p2 = fr7.trigger("operator_abort", signal="KeyboardInterrupt",
                         step=9)
        dump2 = obs.tracing.load_dump(p2)
        check(dump2["reason"] == "operator_abort"
              and dump2["context"].get("signal") == "KeyboardInterrupt"
              and isinstance(dump2["metrics"], dict),
              f"operator_abort dump wrong: {dump2['context']}")
    finally:
        shutil.rmtree(d7, ignore_errors=True)

    # host-step fast path: the serve_host_phase_seconds
    # histogram's bounded six-phase label set, the work-segment /
    # assembly counter families, and the step-input copy-bytes counter
    # whose steady-state zero the serve_host gate pins — stdlib-only
    reg8 = obs.MetricsRegistry()
    hp8 = reg8.histogram("serve_host_phase_seconds", labels=("phase",))
    hp8.labels(phase="schedule").observe(1e-3)
    hp8.labels(phase="build").observe(2e-3)
    hp8.labels(phase="dispatch").observe(3e-3)
    hp8.labels(phase="overlap").observe(0.0)
    hp8.labels(phase="fetch").observe(4e-3)
    hp8.labels(phase="commit").observe(1e-3)
    kids8 = reg8.snapshot()["serve_host_phase_seconds"]["children"]
    check(sorted(kids8) == ["build", "commit", "dispatch", "fetch",
                            "overlap", "schedule"]
          and all(c["count"] == 1 for c in kids8.values()),
          f"host-phase histogram children wrong: {sorted(kids8)}")
    segs8 = reg8.counter("serve_work_segments_total", labels=("event",))
    segs8.labels(event="reused").inc(15)
    segs8.labels(event="rebuilt").inc(3)
    asm8 = reg8.counter("serve_work_assemblies_total", labels=("mode",))
    asm8.labels(mode="incremental").inc(5)
    asm8.labels(mode="full").inc(1)
    copy8 = reg8.counter("serve_step_input_copy_bytes_total")
    copy8.inc(0)        # the fast path's steady state: increments of 0
    prom8 = obs.to_prometheus(reg8)
    for needle in ('serve_work_segments_total{event="reused"} 15',
                   'serve_work_segments_total{event="rebuilt"} 3',
                   'serve_work_assemblies_total{mode="incremental"} 5',
                   'serve_work_assemblies_total{mode="full"} 1',
                   "serve_step_input_copy_bytes_total 0",
                   'serve_host_phase_seconds_bucket{phase="fetch",'
                   'le="+Inf"} 1'):
        check(needle in prom8, f"prometheus output missing {needle!r}")

    # training health: telemetry spec grouping + packed
    # layout, the train_group_* gauge families (bounded GL112-safe
    # label sets), the TrainHealthMonitor detector matrix on a
    # synthetic clock, all FOUR dump reasons (non_finite_loss /
    # grad_norm_spike / loss_divergence / data_stall) loadable with
    # their breach_summary digests, and the instrumented-loader
    # surfaces — stdlib-only like everything above
    th = obs.train_health
    specA = th.build_telemetry_spec(
        {"m.embed_tokens.weight": 2, "m.layers.0.attn.q.weight": 2,
         "m.layers.1.mlp.up.weight": 2, "m.layers.0.norm.weight": 1,
         "lm_head.weight": 2}, max_block_buckets=2)
    check(specA.labels == ("embed", "blocks_00_00", "blocks_01_01",
                           "norm_bias", "head"),
          f"telemetry grouping wrong: {specA.labels}")
    vecA = [0.0] * len(specA)
    vecA[0], vecA[1] = 5.0, 1.25
    off = len(th.HEADER_FIELDS)
    vecA[off:off + 4] = [1.0, 4.0, 0.2, 0.0]
    upA = specA.unpack(vecA)
    check(upA["loss"] == 5.0 and upA["groups"]["embed"]["update_ratio"]
          == 0.05, f"telemetry unpack wrong: {upA}")
    try:
        specA.unpack(vecA[:-1])
        check(False, "short telemetry vector not rejected")
    except ValueError:
        pass
    regT = obs.MetricsRegistry()
    th.record_telemetry(upA, registry=regT)
    snapT = regT.snapshot()
    for fam in ("train_loss", "train_grad_norm",
                "train_group_grad_norm", "train_group_param_norm",
                "train_group_update_ratio", "train_group_nonfinite"):
        check(fam in snapT, f"telemetry gauge family missing: {fam}")
    check(snapT["train_group_grad_norm"]["children"]["embed"]["value"]
          == 1.0, "group gauge value wrong")
    check(set(snapT["train_group_grad_norm"]["children"])
          == set(specA.labels),
          "group gauge label set != spec labels (cardinality leak?)")

    ringT = obs.tracing.SpanRecorder()
    frT = obs.tracing.FlightRecorder(recorder=ringT, min_interval_s=0.0)
    dT = tempfile.mkdtemp(prefix="sc_trainhealth_")
    try:
        frT.arm(dT)
        monT = obs.TrainHealthMonitor(
            window_s=100.0, min_count=3, loss_spike_mads=6.0,
            grad_spike_mads=6.0, update_ratio_bounds=(1e-9, 1.0),
            data_stall_s=0.5, cooldown_s=1000.0, registry=regT,
            recorder=ringT, flight_recorder=frT)
        groupsOK = {"embed": {"grad_norm": 0.5, "param_norm": 2.0,
                              "update_norm": 0.01,
                              "update_ratio": 0.005, "nonfinite": 0.0}}
        for i in range(6):          # healthy baseline: quiet
            monT.observe_step(i, 4.8, 1.3, groups=groupsOK,
                              now=float(i))
        check(monT.breaches_total == 0,
              f"healthy synthetic run breached: {monT.breach_counts}")
        # loss spike -> loss_divergence; sustained -> still once
        monT.observe_step(6, 60.0, 1.3, now=6.0)
        monT.observe_step(7, 60.0, 1.3, now=7.0)
        # grad spike -> grad_norm_spike
        monT.observe_step(8, 4.8, 50.0, now=8.0)
        # NaN -> non_finite_loss, transition-fired exactly once
        monT.observe_step(9, float("nan"), float("nan"), now=9.0)
        monT.observe_step(10, float("nan"), float("nan"), now=10.0)
        # loader stall -> data_stall
        check(monT.observe_data_wait(2.0, now=11.0) is True,
              "data stall not detected")
        check(monT.breach_counts == {"loss_spike": 1, "grad_spike": 1,
                                     "non_finite": 1, "data_stall": 1},
              f"detector matrix wrong: {monT.breach_counts}")
        bcT = regT.snapshot()["train_health_breaches_total"]["children"]
        check(sum(c["value"] for c in bcT.values()) == 4,
              f"breach counter family wrong: {bcT}")
        reasons = sorted(
            obs.load_dump(p)["reason"] for p in frT.dumps)
        check(reasons == ["data_stall", "grad_norm_spike",
                          "loss_divergence", "non_finite_loss"],
              f"train-health dump reasons wrong: {reasons}")
        for p in frT.dumps:         # all four schemas + digests
            dump = obs.load_dump(p)
            dg = th.breach_summary(dump)
            check(dg["reason"] == dump["reason"]
                  and dg["check"] in th.CHECKS
                  and th.DUMP_REASONS[dg["check"]] == dump["reason"],
                  f"breach digest wrong for {dump['reason']}: {dg}")
        try:
            th.breach_summary({"reason": "slo_burn_rate"})
            check(False, "breach_summary accepted a foreign dump")
        except ValueError:
            pass
        # the instrumented loader: wait histogram + batch counter +
        # data_wait spans, stall routed through the monitor
        regL = obs.MetricsRegistry()
        ringL = obs.tracing.SpanRecorder()
        outL = list(th.instrument_loader(
            iter([1, 2, 3]), registry=regL, recorder=ringL,
            queue_depth=lambda: 2))
        check(outL == [1, 2, 3], "instrumented loader altered batches")
        snapL = regL.snapshot()
        check(snapL["train_data_batches_total"]["children"][""]["value"]
              == 3, "loader batch counter wrong")
        check(snapL["train_data_wait_seconds"]["children"][""]["count"]
              == 3, "loader wait histogram wrong")
        check(snapL["train_data_queue_depth"]["children"][""]["value"]
              == 2, "loader queue-depth gauge wrong")
        check(sum(1 for s in ringL.spans()
                  if s["name"] == "data_wait") == 3,
              "data_wait spans missing")
        th.pop_data_wait()          # drain the module accumulator
        th.add_data_wait(0.5)
        check(th.pop_data_wait() == 0.5 and th.pop_data_wait() == 0.0,
              "pending data-wait accumulator wrong")
        try:
            obs.TrainHealthMonitor(window_s=0)
            check(False, "window_s=0 not rejected")
        except ValueError:
            pass
        try:
            obs.TrainHealthMonitor(update_ratio_bounds=(2.0, 1.0))
            check(False, "inverted update_ratio_bounds not rejected")
        except ValueError:
            pass
    finally:
        shutil.rmtree(dT, ignore_errors=True)

    # serving gateway: the front-door package must import
    # stdlib-only, its SSE framing must round-trip, its body/healthz
    # validators must hold their contracts, its metric families must
    # export under fixed label sets, and parse_prometheus must invert
    # to_prometheus — all in a bare (torch-less) container
    try:
        srv = _load_serving()
    except Exception as e:
        failures.append(
            f"standalone (pre-torch) serving import failed: {e}")
        return failures
    frame = srv.format_event("token", {"tokens": [5, 9], "step": 3,
                                       "request": "r1", "index": 0})
    check(frame.startswith(b"event: token\ndata: ")
          and frame.endswith(b"\n\n"),
          f"SSE frame framing wrong: {frame!r}")
    evs = srv.parse_events(frame + srv.format_event(
        "end", {"status": "finished", "tokens": [5, 9]}))
    check(evs == [("token", {"tokens": [5, 9], "step": 3,
                             "request": "r1", "index": 0}),
                  ("end", {"status": "finished", "tokens": [5, 9]})],
          f"SSE parse roundtrip wrong: {evs}")
    inc = list(srv.iter_events([":comment\n", "data: {\"a\": 1}\n",
                                "\n"]))
    check(inc == [("message", {"a": 1})],
          f"SSE bare-data/comment handling wrong: {inc}")

    spec, err = srv.validate_generate_body(
        {"prompt": [1, 2], "max_new_tokens": 4, "priority": 1,
         "deadline_steps": 3, "spec_k": 2, "stream": False})
    check(err is None and spec["prompt"] == [1, 2]
          and spec["stream"] is False and spec["deadline_steps"] == 3,
          f"generate-body happy path wrong: {spec} {err}")
    for bad in ({"prompt": [], "max_new_tokens": 1},
                {"prompt": [1], "max_new_tokens": 0},
                {"prompt": [1.5], "max_new_tokens": 1},
                {"prompt": [1], "max_new_tokens": 1, "priority": -1},
                {"prompt": [1], "max_new_tokens": 1, "stream": "yes"},
                {"prompt": [1], "max_new_tokens": 1, "bogus": 1},
                "not a dict"):
        s, e = srv.validate_generate_body(bad)
        check(s is None and isinstance(e, str),
              f"generate-body validator let {bad!r} through")

    hz = {"schema": srv.HEALTHZ_SCHEMA, "status": "ok", "reason": None,
          "inflight": 0, "queue_depth": 0, "steps": 5, "finished": 2}
    check(srv.validate_healthz(hz) is hz, "healthz happy path rejected")
    srv.validate_healthz(dict(hz, status="degraded",
                              reason="slo_burn"))
    for bad in (dict(hz, schema="x/1"),
                dict(hz, status="meh"),
                dict(hz, status="degraded", reason=None),
                {k: v for k, v in hz.items() if k != "steps"},
                dict(hz, inflight=-1)):
        try:
            srv.validate_healthz(bad)
            check(False, f"validate_healthz accepted {bad!r}")
        except ValueError:
            pass

    # gateway metric families: fixed label sets, present in exposition
    inst = obs.instrument
    inst.gateway_request_seconds().labels(route="generate").observe(0.01)
    inst.gateway_stream_seconds().observe(0.5)
    inst.gateway_responses().labels(route="generate", code="200").inc()
    inst.gateway_live_connections().set(2)
    inst.gateway_live_streams().set(1)
    inst.gateway_sse_pending_events().set(0)
    inst.gateway_sse_events().labels(event="token").inc(3)
    inst.gateway_health_transitions().labels(to="degraded").inc()
    prom8 = obs.to_prometheus()
    for needle in ("# TYPE gateway_request_seconds histogram",
                   'gateway_responses_total{route="generate",code="200"} 1',
                   "gateway_live_connections 2",
                   'gateway_sse_events_total{event="token"} 3',
                   'gateway_health_transitions_total{to="degraded"} 1'):
        check(needle in prom8,
              f"gateway family missing from exposition: {needle!r}")
    parsed = obs.parse_prometheus(prom8)
    check(parsed["gateway_request_seconds"]["kind"] == "histogram"
          and any(n == "gateway_request_seconds_count"
                  and lbl.get("route") == "generate" and v == 1
                  for n, lbl, v
                  in parsed["gateway_request_seconds"]["samples"]),
          "parse_prometheus lost the gateway histogram")
    check(any(n == "gateway_responses_total" and v == 1
              and lbl == {"route": "generate", "code": "200"}
              for n, lbl, v
              in parsed["gateway_responses_total"]["samples"]),
          "parse_prometheus lost the labeled counter")
    # escaping survives the roundtrip (the help / label split)
    reg9 = obs.MetricsRegistry()
    reg9.counter("rt_esc_total", labels=("q",)).labels(
        q='a"b\\c\nd').inc()
    rt = obs.parse_prometheus(obs.to_prometheus(reg9))
    check(rt["rt_esc_total"]["samples"][0][1]["q"] == 'a"b\\c\nd',
          f"label escaping did not round-trip: "
          f"{rt['rt_esc_total']['samples']}")
    # the adversarial case: a LITERAL backslash followed by 'n' (a
    # Windows path, a repr'd error) — unescaping must run one
    # left-to-right pass, not sequential replaces
    reg10 = obs.MetricsRegistry()
    reg10.counter("rt_esc2_total", labels=("p",)).labels(
        p="back\\nslash\\\\x").inc()
    rt2 = obs.parse_prometheus(obs.to_prometheus(reg10))
    check(rt2["rt_esc2_total"]["samples"][0][1]["p"]
          == "back\\nslash\\\\x",
          f"literal-backslash label did not round-trip: "
          f"{rt2['rt_esc2_total']['samples']}")
    lone = obs.parse_prometheus('x_bucket{le="+Inf"} 3\n')
    check(lone["x_bucket"]["samples"]
          == [("x_bucket", {"le": "+Inf"}, 3.0)],
          f"parse_prometheus mishandled a bucket sample: {lone}")
    try:
        obs.parse_prometheus("not a metric line at all {{{")
        check(False, "parse_prometheus accepted garbage")
    except ValueError:
        pass

    # multi-replica router: the policy registry and the
    # route-choice math are pure stdlib (no engine, no torch), and the
    # router/replica metric families must export under their bounded
    # label sets (`policy` a fixed literal set, `replica` world-bounded
    # like `device`)
    check(set(srv.POLICIES)
          == {"round_robin", "least_loaded", "prefix_affinity"},
          f"routing policy registry drifted: {sorted(srv.POLICIES)}")
    RouteView = srv.router.RouteView
    rr = srv.RoundRobinPolicy()
    rv = RouteView((0, 1), {0: 3, 1: 0},
                   {0: frozenset({"k1"}), 1: frozenset()},
                   ("k1", "k2"))
    check([rr.choose(rv) for _ in range(4)] == [0, 1, 0, 1],
          "round-robin rotation wrong")
    check(srv.LeastLoadedPolicy().choose(rv) == 1,
          "least-loaded did not pick the idle replica")
    aff = srv.PrefixAffinityPolicy(imbalance_cap=4)
    check(aff.choose(rv) == (0, "hit"),
          "affinity missed the replica holding the prefix")
    check(srv.PrefixAffinityPolicy(imbalance_cap=2).choose(rv)
          == (1, "miss"),
          "imbalance cap did not veto the overloaded match")
    check(srv.PrefixAffinityPolicy().choose(
        RouteView((0, 1), {0: 0, 1: 0}, {0: frozenset(),
                                         1: frozenset()},
                  ("k1",))) == (0, "miss"),
          "no-match affinity did not fall back to least-loaded")
    try:
        srv.EngineRouter([])
        check(False, "empty replica pool not rejected")
    except ValueError:
        pass
    inst.routed_requests().labels(policy="prefix_affinity",
                                  replica="0").inc(2)
    inst.router_affinity_hits().inc()
    inst.router_affinity_misses().inc()
    inst.router_resubmits().labels(replica="1").inc()
    inst.router_replica_inflight().labels(replica="0").set(2)
    inst.router_replicas_live().set(2)
    promR = obs.to_prometheus()
    for needle in (
            'routed_requests_total{policy="prefix_affinity",'
            'replica="0"} 2',
            "router_affinity_hits_total 1",
            "router_affinity_misses_total 1",
            'router_resubmits_total{replica="1"} 1',
            'router_replica_inflight{replica="0"} 2',
            "router_replicas_live 2"):
        check(needle in promR,
              f"router family missing from exposition: {needle!r}")
    parsedR = obs.parse_prometheus(promR)
    check(any(n == "routed_requests_total" and v == 2
              and lbl == {"policy": "prefix_affinity", "replica": "0"}
              for n, lbl, v
              in parsedR["routed_requests_total"]["samples"]),
          "parse_prometheus lost the routed-requests counter")

    # fleet layer: per-rank mirroring through RankExporter
    # (atomic snapshot files + manifest, seq adoption), merge math
    # (counters sum exactly, fixed-bucket histograms merge exactly so
    # fleet quantiles are real, gauges keep rank-labeled children with
    # rollups), the prometheus-scrape ingestion path, and the
    # FleetMonitor straggler detector fire/no-fire on synthetic
    # clocks with a schema-valid fleet_straggler dump — stdlib-only
    # like everything above
    fdir = tempfile.mkdtemp(prefix="sc_fleet_")
    try:
        regs = []
        for rank in range(2):
            freg = obs.MetricsRegistry()
            freg.counter("fl_tokens_total").inc(10 * (rank + 1))
            fh = freg.histogram("fl_step_seconds",
                                buckets=(0.01, 0.1, 1.0))
            for v in ((0.005, 0.05) if rank == 0 else (0.5, 2.0)):
                fh.observe(v)
            freg.gauge("fl_depth").set(float(rank + 3))
            regs.append(freg)
        exps = [obs.RankExporter(fdir, r, 2, run_id="sc",
                                 registry=regs[r], interval_s=0.0)
                for r in range(2)]
        for e in exps:
            e.export()
        snaps = obs.discover_snapshots(fdir, run_id="sc")
        check(sorted(snaps) == [0, 1],
              f"fleet discovery missed ranks: {sorted(snaps)}")
        man = obs.load_fleet_manifest(fdir)
        check(man["run_id"] == "sc"
              and sorted(man["ranks"]) == ["0", "1"]
              and all(man["ranks"][str(r)]["seq"] == snaps[r]["seq"]
                      for r in snaps),
              "fleet manifest does not round-trip the rank files")
        # adoption: a re-armed exporter continues the rank's seq
        check(obs.RankExporter(fdir, 0, 2, run_id="sc",
                               registry=regs[0]).seq
              == snaps[0]["seq"],
              "re-armed RankExporter did not adopt the previous seq")
        view = obs.merge_snapshots(snaps)
        tok = view["metrics"]["fl_tokens_total"]["children"][""]
        check(tok["value"] == 30.0,
              f"fleet counter sum not exact: {tok['value']}")
        hch = view["metrics"]["fl_step_seconds"]["children"][""]
        check(hch["bucket_counts"] == [1, 1, 1, 1]
              and hch["count"] == 4,
              f"fleet histogram merge not exact: {hch}")
        q95 = obs.merged_quantile(view, "fl_step_seconds", 0.95)
        check(q95 is not None and 0.1 < q95 <= 1.0,
              f"fleet p95 {q95} outside the pooled crossing bucket")
        dfam = view["metrics"]["fl_depth"]
        check(dfam["labelnames"] == ["rank"]
              and dfam["children"]["0"]["value"] == 3.0
              and dfam["children"]["1"]["value"] == 4.0,
              "merged gauge lost its rank-labeled children")
        roll = obs.gauge_rollups(view, "fl_depth")[""]
        check(roll["min"] == 3.0 and roll["max"] == 4.0
              and roll["mean"] == 3.5,
              f"gauge rollups wrong: {roll}")
        # scrape path: exposition text -> snapshot -> same merge
        scraped = obs.snapshot_from_prometheus(
            obs.to_prometheus(regs[0]))
        sch = scraped["fl_step_seconds"]["children"][""]
        check(sch["bucket_counts"]
              == regs[0].snapshot()["fl_step_seconds"]["children"][""][
                  "bucket_counts"],
              "snapshot_from_prometheus did not de-cumulate buckets")
        # straggler detector on synthetic clocks: rank 1's dispatch
        # mean sits far over the fleet median; rank 0 must stay quiet
        ddir = os.path.join(fdir, "dumps")
        monf = obs.FleetMonitor(window_s=60.0, min_count=3,
                                mad_factor=4.0, abs_floor_s=0.005,
                                checks=(("dispatch",
                                         "fl_dispatch_seconds"),),
                                registry=obs.MetricsRegistry(),
                                dump_dir=ddir, min_interval_s=0.0)
        sregs, shs, seqs = [], [], [0, 0, 0]

        def feed(rank, t):
            seqs[rank] += 1
            monf.ingest({"schema": obs.fleet_obs.SNAPSHOT_SCHEMA,
                         "run_id": "sc", "rank": rank, "world_size": 3,
                         "seq": seqs[rank],
                         "clock": {"time": 0.0,
                                   "monotonic": 100.0 + t,
                                   "perf_us": 0.0},
                         "metrics": sregs[rank].snapshot(),
                         "spans": []})

        for rank in range(3):
            sregs.append(obs.MetricsRegistry())
            shs.append(sregs[rank].histogram(
                "fl_dispatch_seconds", buckets=(0.01, 0.1, 1.0, 10.0)))
        for t in range(5):
            for rank in range(3):
                if t:
                    shs[rank].observe(0.02)
                feed(rank, t)
        check(monf.check() == [],
              "straggler detector fired on a symmetric healthy fleet")
        for t in range(5, 8):
            for rank in range(3):
                shs[rank].observe(0.02 if rank < 2 else 2.0)
                feed(rank, t)
        fired = monf.check()
        check(len(fired) == 1 and fired[0]["rank"] == 2
              and fired[0]["check"] == "dispatch",
              f"straggler detector wrong breach set: {fired}")
        fdumps = [f for f in os.listdir(ddir)
                  if f.startswith("flightrec_fleet_straggler")]
        check(len(fdumps) == 1,
              f"expected one fleet_straggler dump: {fdumps}")
        if fdumps:
            fd = obs.load_dump(os.path.join(ddir, fdumps[0]))
            fctx = fd.get("context", {})
            check(fd["reason"] == "fleet_straggler"
                  and fctx.get("rank") == 2
                  and sum(json.loads(fctx["rank_hist"])) > 0
                  and sum(json.loads(fctx["fleet_hist"])) > 0,
                  "fleet_straggler dump schema/witnesses wrong")
    finally:
        shutil.rmtree(fdir, ignore_errors=True)
    return failures


def main():
    ap = argparse.ArgumentParser(
        description="dump or selfcheck the port's observability registry")
    ap.add_argument("--format", default="json",
                    choices=["prometheus", "json", "chrome"])
    ap.add_argument("--selfcheck", action="store_true",
                    help="exercise the metrics core and exit 0/1 (runs "
                         "without torch)")
    args = ap.parse_args()
    if args.selfcheck:
        failures = selfcheck()
        if failures:
            print(f"metrics selfcheck: FAIL ({len(failures)} problems)")
            for f in failures:
                print("  " + f)
            return 1
        print("metrics selfcheck: OK")
        return 0
    print(dump(args.format))
    return 0


if __name__ == "__main__":
    sys.exit(main())
