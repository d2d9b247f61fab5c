"""The PyTorch port's fleet plane (``paddle_tpu_torch/observability/
fleet_obs.py``, a copy of the JAX package's module): every case of
tests/test_fleet_obs.py run against the port's modules (the per-rank
mirror, the merge math, the scrape ingestion, the straggler monitor, the
windowed queries over ingested snapshots), then the reports of the two
packages compared field by field on the same synthetic inputs: merged
views, quantiles, rollups, the Prometheus round trip and the monitor's
breaches. Host-side, no torch, no engine."""
import json
import os
import time

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import fleet_obs as jfleet
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import fleet_obs


def _rank_registry(rank, o=obs):
    reg = o.MetricsRegistry()
    reg.counter("fo_tokens_total").inc(7 * (rank + 1))
    reg.counter("fo_steps_total", labels=("mode",)).labels(
        mode="plain").inc(rank + 1)
    h = reg.histogram("fo_lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in ((0.005, 0.05, 0.5) if rank == 0 else (0.05, 0.5, 5.0)):
        h.observe(v)
    reg.gauge("fo_depth").set(float(rank + 2))
    return reg


# -- RankExporter -----------------------------------------------------------

def test_rank_exporter_writes_manifest_and_adopts(tmp_path):
    fdir = str(tmp_path)
    regs = [_rank_registry(r) for r in range(2)]
    exps = [fleet_obs.RankExporter(fdir, r, 2, run_id="t",
                                   registry=regs[r], interval_s=0.0)
            for r in range(2)]
    for e in exps:
        e.export()
        e.export()
    snaps = fleet_obs.discover_snapshots(fdir, run_id="t")
    assert sorted(snaps) == [0, 1]
    for r, snap in snaps.items():
        assert snap["schema"] == fleet_obs.SNAPSHOT_SCHEMA
        assert snap["seq"] == 2 and snap["world_size"] == 2
        assert {"time", "monotonic", "perf_us"} <= set(snap["clock"])
    man = fleet_obs.load_fleet_manifest(fdir)
    assert man["run_id"] == "t"
    assert {int(r) for r in man["ranks"]} == {0, 1}
    assert all(man["ranks"][str(r)]["seq"] == snaps[r]["seq"]
               for r in snaps)
    # a restarted rank adopts its previous seq (never rewinds it)
    again = fleet_obs.RankExporter(fdir, 1, 2, run_id="t",
                                   registry=regs[1])
    assert again.seq == 2
    # a different run id starts fresh and is invisible to "t"
    other = fleet_obs.RankExporter(fdir, 1, 2, run_id="u",
                                   registry=regs[1])
    assert other.seq == 0


def test_rank_exporter_cadence_gate(tmp_path):
    exp = fleet_obs.RankExporter(str(tmp_path), 0, 1, run_id="t",
                                 registry=_rank_registry(0),
                                 interval_s=10.0)
    assert exp.maybe_export(now=100.0) is not None
    assert exp.maybe_export(now=105.0) is None     # inside the cadence
    assert exp.maybe_export(now=111.0) is not None


def test_rank_exporter_rejects_bad_rank(tmp_path):
    with pytest.raises(ValueError):
        fleet_obs.RankExporter(str(tmp_path), 3, 2)


def test_span_digest_windows_are_disjoint(tmp_path):
    # the digest watermark lives on the perf_counter timebase (same as
    # SpanRecorder timestamps), so spans here must too; back-date each
    # start so the span has definitely CLOSED before the next export
    rec = obs.SpanRecorder(capacity=64)
    rec.record_span("a", time.perf_counter() * 1e6 - 100.0, 10.0,
                    request="q")
    exp = fleet_obs.RankExporter(str(tmp_path), 0, 1, run_id="t",
                                 registry=obs.MetricsRegistry(),
                                 recorder=rec, interval_s=0.0)
    exp.export()
    snap1 = fleet_obs.load_rank_snapshot(exp.path)
    first = snap1["spans"]
    assert [s["name"] for s in first] == ["a"]
    # clock.perf_us is the export's watermark: a span that closes just
    # past it lands in (and only in) the next digest, deterministically
    rec.record_span("b", snap1["clock"]["perf_us"] + 1.0, 10.0,
                    request="q")
    exp.export()
    second = fleet_obs.load_rank_snapshot(exp.path)["spans"]
    assert [s["name"] for s in second] == ["b"]    # 'a' not re-sent


# -- merge math -------------------------------------------------------------

def test_merge_counters_and_histograms_exact(tmp_path):
    snaps = {r: {"rank": r, "world_size": 2,
                 "metrics": _rank_registry(r).snapshot()}
             for r in range(2)}
    view = fleet_obs.merge_snapshots(snaps)
    assert view["schema"] == fleet_obs.FLEET_VIEW_SCHEMA
    m = view["metrics"]
    assert m["fo_tokens_total"]["children"][""]["value"] == 21.0
    assert m["fo_steps_total"]["children"]["plain"]["value"] == 3.0
    h = m["fo_lat_seconds"]["children"][""]
    # rank0 [1,1,1,0] + rank1 [0,1,1,1] pooled exactly
    assert h["bucket_counts"] == [1, 2, 2, 1]
    assert h["count"] == 6
    # merged quantile == quantile over the pooled counts: p50 rank=3
    # crosses the (0.01, 0.1] bucket at (3-1)/2 of its width
    q50 = fleet_obs.merged_quantile(view, "fo_lat_seconds", 0.5)
    assert q50 == pytest.approx(0.01 + (0.1 - 0.01) * 1.0, rel=1e-12)


def test_merge_gauges_rank_labels_and_rollups():
    snaps = [{"rank": r, "world_size": 3,
              "metrics": _rank_registry(r).snapshot()}
             for r in range(3)]
    view = fleet_obs.merge_snapshots(snaps)
    fam = view["metrics"]["fo_depth"]
    assert fam["labelnames"] == ["rank"]
    assert {k: c["value"] for k, c in fam["children"].items()} == {
        "0": 2.0, "1": 3.0, "2": 4.0}
    roll = fleet_obs.gauge_rollups(view, "fo_depth")[""]
    assert roll["min"] == 2.0 and roll["max"] == 4.0
    assert roll["mean"] == pytest.approx(3.0)
    assert roll["skew"] == pytest.approx(0.0)      # symmetric
    # per-rank keys are strings (JSON round-trip safe)
    assert roll["per_rank"] == {"0": 2.0, "1": 3.0, "2": 4.0}


def test_merge_rejects_bucket_mismatch_and_duplicate_rank():
    a = obs.MetricsRegistry()
    a.histogram("fo_x_seconds", buckets=(0.1, 1.0)).observe(0.5)
    b = obs.MetricsRegistry()
    b.histogram("fo_x_seconds", buckets=(0.2, 2.0)).observe(0.5)
    with pytest.raises(ValueError):
        fleet_obs.merge_snapshots([a.snapshot(), b.snapshot()])
    with pytest.raises(ValueError):
        fleet_obs.merge_snapshots([
            {"rank": 0, "metrics": a.snapshot()},
            {"rank": 0, "metrics": a.snapshot()}])


def test_snapshot_from_prometheus_roundtrip():
    reg = _rank_registry(0)
    snap = fleet_obs.snapshot_from_prometheus(obs.to_prometheus(reg))
    truth = reg.snapshot()
    assert snap["fo_lat_seconds"]["children"][""]["bucket_counts"] \
        == truth["fo_lat_seconds"]["children"][""]["bucket_counts"]
    assert snap["fo_tokens_total"]["children"][""]["value"] == 7.0
    # a live-scrape merge equals the registry-snapshot merge
    view = fleet_obs.merge_snapshots([
        {"rank": 0, "metrics": snap},
        {"rank": 1, "metrics": _rank_registry(1).snapshot()}])
    assert view["metrics"]["fo_tokens_total"]["children"][""][
        "value"] == 21.0


def test_snapshot_from_prometheus_rejects_non_monotonic():
    bad = ("# TYPE x_seconds histogram\n"
           'x_seconds_bucket{le="0.1"} 5\n'
           'x_seconds_bucket{le="+Inf"} 3\n'
           "x_seconds_sum 1.0\nx_seconds_count 3\n")
    with pytest.raises(ValueError):
        fleet_obs.snapshot_from_prometheus(bad)


# -- FleetMonitor -----------------------------------------------------------

def _payload(rank, seq, mono, metrics, spans=()):
    return {"schema": fleet_obs.SNAPSHOT_SCHEMA, "run_id": "t",
            "rank": rank, "world_size": 3, "seq": seq,
            "clock": {"time": 0.0, "monotonic": mono, "perf_us": 0.0},
            "metrics": metrics, "spans": list(spans)}


def _drive(mon, skewed_rank=None, ranks=3, ticks=6, o=obs):
    regs = [o.MetricsRegistry() for _ in range(ranks)]
    hists = [r.histogram("fo_dispatch_seconds",
                         buckets=(0.01, 0.1, 1.0, 10.0)) for r in regs]
    for t in range(ticks):
        for rank in range(ranks):
            if t:
                hists[rank].observe(
                    2.0 if rank == skewed_rank else 0.02)
            mon.ingest(_payload(rank, t + 1, 100.0 + t,
                                regs[rank].snapshot()))


def test_monitor_no_fire_on_symmetric_fleet(tmp_path):
    mon = fleet_obs.FleetMonitor(
        window_s=60.0, min_count=3, mad_factor=4.0, abs_floor_s=0.005,
        checks=(("dispatch", "fo_dispatch_seconds"),),
        registry=obs.MetricsRegistry(),
        dump_dir=str(tmp_path / "dumps"), min_interval_s=0.0)
    _drive(mon, skewed_rank=None)
    assert mon.check() == []
    assert mon.breaches == []


def test_monitor_fires_on_exactly_the_skewed_rank(tmp_path):
    reg = obs.MetricsRegistry()
    ddir = str(tmp_path / "dumps")
    mon = fleet_obs.FleetMonitor(
        window_s=60.0, min_count=3, mad_factor=4.0, abs_floor_s=0.005,
        checks=(("dispatch", "fo_dispatch_seconds"),),
        registry=reg, dump_dir=ddir, min_interval_s=0.0)
    _drive(mon, skewed_rank=1)
    fired = mon.check()
    assert [(b["rank"], b["check"]) for b in fired] == [(1, "dispatch")]
    assert fired[0]["mean_s"] > fired[0]["median_s"] \
        + fired[0]["margin_s"]
    # the breach counter landed under its check label
    snap = reg.snapshot()["fleet_straggler_breaches_total"]
    assert snap["children"]["dispatch"]["value"] == 1.0
    # the dump: schema-valid, names the rank, carries both witness
    # distributions as parseable JSON
    dumps = [f for f in os.listdir(ddir)
             if f.startswith("flightrec_fleet_straggler")]
    assert len(dumps) == 1
    dump = obs.load_dump(os.path.join(ddir, dumps[0]))
    ctx = dump["context"]
    assert dump["reason"] == "fleet_straggler"
    assert ctx["rank"] == 1 and ctx["check"] == "dispatch"
    # windowed deltas baseline at the oldest in-window sample, so the
    # 5 observations show up as 4 deltas per rank (x2 for the others)
    assert sum(json.loads(ctx["rank_hist"])) == 4
    assert sum(json.loads(ctx["fleet_hist"])) == 8    # the two others
    assert json.loads(ctx["hist_buckets"]) == [0.01, 0.1, 1.0, 10.0]


def test_monitor_min_count_guard_blocks_thin_windows():
    mon = fleet_obs.FleetMonitor(
        window_s=60.0, min_count=50, mad_factor=4.0, abs_floor_s=0.005,
        checks=(("dispatch", "fo_dispatch_seconds"),),
        registry=obs.MetricsRegistry())
    _drive(mon, skewed_rank=2)          # 5 obs/rank < min_count=50
    assert mon.check() == []


def test_monitor_seq_gating_and_stale_ingest():
    mon = fleet_obs.FleetMonitor(registry=obs.MetricsRegistry(),
                                 checks=())
    reg = _rank_registry(0)
    assert mon.ingest(_payload(0, 3, 100.0, reg.snapshot())) is True
    assert mon.ingest(_payload(0, 3, 101.0, reg.snapshot())) is False
    assert mon.ingest(_payload(0, 2, 102.0, reg.snapshot())) is False
    assert mon.ingest(_payload(0, 4, 103.0, reg.snapshot())) is True
    with pytest.raises(ValueError):
        mon.ingest({"schema": "bogus/1"})


def test_monitor_merges_span_lanes_per_rank():
    mon = fleet_obs.FleetMonitor(registry=obs.MetricsRegistry(),
                                 checks=())
    reg = obs.MetricsRegistry()
    mon.ingest(_payload(0, 1, 100.0, reg.snapshot(), spans=[
        {"name": "step", "ts_us": 1.0, "dur_us": 2.0,
         "request": "q7", "args": {}}]))
    mon.ingest(_payload(1, 1, 100.0, reg.snapshot(), spans=[
        {"name": "step", "ts_us": 1.0, "dur_us": 2.0,
         "request": None, "args": {}}]))
    lanes = {s["request"] for s in mon.recorder.spans()}
    assert lanes == {"r0:q7", "r1"}


def test_monitor_poll_discovers_fleet_dir(tmp_path):
    fdir = str(tmp_path)
    regs = [_rank_registry(r) for r in range(2)]
    for r in range(2):
        fleet_obs.RankExporter(fdir, r, 2, run_id="t",
                               registry=regs[r],
                               interval_s=0.0).export()
    mon = fleet_obs.FleetMonitor(fleet_dir=fdir, run_id="t",
                                 registry=obs.MetricsRegistry(),
                                 checks=())
    mon.poll()
    assert sorted(mon.summary()["ranks"]) == [0, 1]
    view = mon.fleet_view()
    assert view["metrics"]["fo_tokens_total"]["children"][""][
        "value"] == 21.0


# -- TimeSeries snapshot ingestion -----------------------------------------

def test_sample_snapshot_feeds_windowed_queries():
    reg = obs.MetricsRegistry()
    c = reg.counter("fo_ticks_total")
    h = reg.histogram("fo_lat_seconds", buckets=(0.01, 0.1, 1.0))
    ts = obs.TimeSeries(capacity=16)
    for t in range(4):
        c.inc(5)
        h.observe(0.05)
        ts.sample_snapshot(reg.snapshot(), now=100.0 + t)
    # the window baseline is the LAST sample at/before the left edge
    # (100.5), i.e. the sample at t=100 — so the delta spans 3 ticks
    assert ts.delta("fo_ticks_total", 2.5, now=103.0) == 15.0
    assert ts.count("fo_lat_seconds", 2.5, now=103.0) == 3
    q = ts.quantile("fo_lat_seconds", 0.5, 2.5, now=103.0)
    assert q is not None and 0.01 < q <= 0.1


# -- the two packages, field by field ---------------------------------------

PACKAGES = ((jobs, jfleet), (obs, fleet_obs))


def _view(o, f):
    snaps = [{"rank": r, "world_size": 3,
              "metrics": _rank_registry(r, o).snapshot()} for r in range(3)]
    view = f.merge_snapshots(snaps)
    view.pop("time", None)
    return view


def test_merged_views_equal_jax():
    (jo, jf), (to, tf) = PACKAGES
    jv, tv = _view(jo, jf), _view(to, tf)
    assert json.dumps(tv, sort_keys=True) == json.dumps(jv, sort_keys=True)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert tf.merged_quantile(tv, "fo_lat_seconds", q) == \
            jf.merged_quantile(jv, "fo_lat_seconds", q)
    assert tf.gauge_rollups(tv, "fo_depth") == \
        jf.gauge_rollups(jv, "fo_depth")


def test_prometheus_roundtrip_equals_jax():
    (jo, jf), (to, tf) = PACKAGES
    jt = jf.snapshot_from_prometheus(jo.to_prometheus(_rank_registry(1, jo)))
    tt = tf.snapshot_from_prometheus(to.to_prometheus(_rank_registry(1, to)))
    assert tt == jt


def test_monitor_breaches_equal_jax(tmp_path):
    got = []
    for i, (o, f) in enumerate(PACKAGES):
        mon = f.FleetMonitor(
            window_s=60.0, min_count=3, mad_factor=4.0, abs_floor_s=0.005,
            checks=(("dispatch", "fo_dispatch_seconds"),),
            registry=o.MetricsRegistry(),
            dump_dir=str(tmp_path / f"d{i}"), min_interval_s=0.0)
        _drive(mon, skewed_rank=2, o=o)
        got.append(([{k: v for k, v in b.items() if k != "time"}
                     for b in mon.check()], mon.summary()["ranks"]))
    assert got[1] == got[0]
    assert [b["rank"] for b in got[1][0]] == [2]


def test_rank_snapshots_equal_jax(tmp_path):
    out = []
    for i, (o, f) in enumerate(PACKAGES):
        exp = f.RankExporter(str(tmp_path / f"r{i}"), 1, 2, run_id="t",
                             registry=_rank_registry(1, o),
                             recorder=o.SpanRecorder(), interval_s=0.0)
        exp.export()
        snap = f.load_rank_snapshot(exp.path)
        out.append({k: v for k, v in snap.items() if k not in ("clock",)})
    for s in out:
        s["metrics"].pop("time", None)
    assert out[1] == out[0]
