#!/usr/bin/env python
"""Fleet-observability gate of the PyTorch port (the port's counterpart of
``tools/fleet_obs.py``): real rank processes under one fleet directory.

Two legs, each spawning WORLD rank subprocesses that run the
instrumented serving stepper loop (continuous batching over the port's
tiny f32 engine, ``tools/torch_serve_gates.tiny_engine``), mirroring the
registry and the span ring through ``RankExporter`` after every step
while the parent's ``FleetMonitor`` polls the shared directory live. The
healthy leg adds a short pretrain on the port's mesh, dp = 2 over gloo
between the two processes (a ``FileStore`` in the fleet directory), with
the JAX gate's model (the tiny Llama, heads 4 and 2) and batches.

* **healthy** - the same workload on every rank (file barriers keep the
  phases aligned). PASS: no straggler breach in any live poll, the
  fleet's merged counters equal to the plain ascending-rank sum of the
  per-rank snapshots, merged-histogram quantiles equal to quantiles over
  independently pooled bucket counts, the manifest round-trips, and every
  merged gauge child's rank label inside the world.
* **fault** - ``inference.set_dispatch_delay("paged_step", 2.5)`` on rank
  1. PASS: the detector fires on exactly that rank (check "dispatch"),
  the ``fleet_straggler`` dump loads, names the rank with both witness
  histograms, and its merged per-rank span lanes render (each lane's
  request digest through the port's ``tracing.request_summary``).

  python tools/torch_fleet_obs.py [--json out.json]
  python tools/torch_fleet_obs.py --check tools/fleet_obs.json

``--check`` holds the report to every ``exact`` field and ``bounds``
entry of the JAX gate's committed baseline. It runs on the CPU, as the
JAX gate does: its monitor's margins are host-time margins. The hidden
``--rank-worker`` mode is the subprocess body.
"""
import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPORT_SCHEMA = "paddle_tpu.fleet_obs_report/1"
BASELINE_SCHEMA = "paddle_tpu.fleet_obs/1"

WORLD = 2
RUN_ID = "fleet-gate"
FAULT_RANK = 1
FAULT_DELAY_S = 2.5
TRAIN_STEPS = 4        # healthy leg: step 1 warms, 2..4 measured
REQUESTS = 3           # instrumented serving requests per rank
STORE_TIMEOUT_S = 300.0
# the JAX gate's monitor policy: at world 2 the leave-one-out MAD is zero,
# so abs_floor_s alone is the margin over symmetric contention noise
MON_CFG = dict(window_s=900.0, min_count=3, mad_factor=8.0,
               abs_floor_s=1.0, min_interval_s=5.0)
HEALTHY_CHECKS = (
    ("dispatch", "dispatch_seconds{program=paged_step}"),
    ("train_dispatch", "dispatch_seconds{program=pretrain_step}"),
    ("step", "train_step_seconds"),
    ("host", "train_host_seconds"),
)
FAULT_CHECKS = (("dispatch", "dispatch_seconds{program=paged_step}"),)


# -- rank worker ------------------------------------------------------------

def _barrier(fleet_dir, name, rank, world, timeout_s=900.0):
    """File barrier: the phases stay aligned across ranks, or scheduler
    contention (one rank training while the other still serves) would
    read as a straggler. ``rank`` "parent" waits for the parent's mark
    alone (``_mark``)."""
    waits = [f"barrier_{name}.r{r}" for r in range(world)]
    if rank == "parent":
        waits = [f"barrier_{name}.parent"]
    else:
        _mark(fleet_dir, name, rank)
    t0 = time.monotonic()
    while not all(os.path.exists(os.path.join(fleet_dir, w))
                  for w in waits):
        if time.monotonic() - t0 > timeout_s:
            raise RuntimeError(f"rank {rank}: barrier {name} timed out")
        time.sleep(0.05)


def _mark(fleet_dir, name, who):
    """Reach barrier ``name`` as rank ``who`` (or as the parent)."""
    tag = "parent" if who == "parent" else f"r{who}"
    open(os.path.join(fleet_dir, f"barrier_{name}.{tag}"), "w").close()


def _pretrain(args, exporter):
    """A short dp = 2 pretrain on the port's mesh, the two rank processes
    joined over a FileStore; an export after every step."""
    import numpy as np

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         pretrain)

    group = collective.new_group(args.rank, args.world,
                                 os.path.join(args.fleet_dir, "store"),
                                 timeout=STORE_TIMEOUT_S)
    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=16, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    mesh = pretrain.make_mesh(args.world, dp=args.world, group=group,
                              device="cpu")
    params, opt_state, meta = pretrain.make_train_state(model, mesh)
    step = pretrain.make_train_step(model, mesh, meta, telemetry=True)
    brng = np.random.default_rng(1)
    for i in range(args.train_steps):
        b = {"input_ids": brng.integers(0, 128, (4, 16)).astype(np.int32),
             "labels": brng.integers(0, 128, (4, 16)).astype(np.int32)}
        params, opt_state, loss, gnorm = step(
            params, opt_state, pretrain.shard_batch(b, mesh))
        float(loss)
        exporter.export()
        if i == 0:      # both ranks leave the warm step together
            _barrier(args.fleet_dir, "train_warm", args.rank, args.world)


def rank_worker(args):
    import numpy as np

    from paddle_tpu_torch import inference
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from tools.torch_serve_gates import tiny_engine

    rng = np.random.default_rng(0)      # the same workload on every rank
    eng, V = tiny_engine(rng, max_seq_len=32, device="cpu")
    cb = ContinuousBatchingEngine(eng, num_blocks=12, block_size=8,
                                  max_batch=2)

    def mk(p, n):
        return GenerationRequest(rng.integers(1, V, p).astype(np.int32), n)

    # warm before the mirror's baseline export: first-call costs stay out
    # of the windowed deltas
    cb.submit(mk(6, 3))
    cb.run()
    _barrier(args.fleet_dir, "warm", args.rank, args.world)
    exporter = obs.RankExporter(args.fleet_dir, args.rank, args.world,
                                run_id=args.run_id, interval_s=0.0)
    exporter.export()                   # delta baseline
    # the parent's monitor must hold every rank's baseline before the
    # ranks serve: the port's steps can end between two of its polls
    _barrier(args.fleet_dir, "baseline_ingested", "parent", 0)
    if args.delay > 0:
        inference.set_dispatch_delay("paged_step", args.delay)
    for _ in range(args.requests):
        cb.submit(mk(6, 3))
    while cb.queue or cb.num_active:
        cb.step()
        exporter.export()
    inference.set_dispatch_delay("paged_step", None)
    _barrier(args.fleet_dir, "serve_done", args.rank, args.world)
    if args.pretrain:
        _pretrain(args, exporter)
    exporter.export()
    return 0


# -- parent: one leg --------------------------------------------------------

def _spawn(fleet_dir, rank, fault):
    cmd = [sys.executable, os.path.abspath(__file__), "--rank-worker",
           "--rank", str(rank), "--world", str(WORLD),
           "--fleet-dir", fleet_dir, "--run-id", RUN_ID,
           "--requests", str(REQUESTS)]
    if fault:
        cmd += ["--delay",
                str(FAULT_DELAY_S if rank == FAULT_RANK else 0.0)]
    else:
        cmd += ["--pretrain", "--train-steps", str(TRAIN_STEPS)]
    out = open(os.path.join(fleet_dir, f"worker_{rank}.log"), "w")
    return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                            cwd=REPO), out


def _run_fleet(fault):
    """Spawn the ranks, poll the monitor live; (monitor, fleet_dir,
    rcs)."""
    from paddle_tpu_torch import observability as obs

    fleet_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_fleet_")
    mon = obs.FleetMonitor(
        fleet_dir=fleet_dir, run_id=RUN_ID,
        checks=FAULT_CHECKS if fault else HEALTHY_CHECKS,
        dump_dir=os.path.join(fleet_dir, "dumps"), **MON_CFG)
    procs = [_spawn(fleet_dir, r, fault) for r in range(WORLD)]
    acked = False
    try:
        while any(p.poll() is None for p, _ in procs):
            mon.poll()
            if not acked and len(mon.summary()["ranks"]) == WORLD:
                _mark(fleet_dir, "baseline_ingested", "parent")
                acked = True
            time.sleep(0.1 if not acked else 0.5)
    finally:
        for p, f in procs:
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
            f.close()
    mon.poll()                          # final ingest + check
    rcs = [p.returncode for p, _ in procs]
    if any(rc != 0 for rc in rcs):
        for r in range(WORLD):
            log = os.path.join(fleet_dir, f"worker_{r}.log")
            print(f"--- worker {r} (rc={rcs[r]}) ---")
            with open(log) as f:
                print(f.read()[-4000:])
    return mon, fleet_dir, rcs


# -- aggregation ground truth ----------------------------------------------

def _truth_quantile(buckets, counts, q, total):
    """Independent Histogram.quantile interpolation over pooled
    counts: the gate's ground truth for merged quantiles."""
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


def _aggregation_report(snaps, view):
    """Diff merge_snapshots' fleet view against plain-python sums of
    the per-rank snapshots (the same ascending-rank order: the counter
    comparison is exact float equality)."""
    from paddle_tpu_torch import observability as obs

    ranks = sorted(snaps)
    counters, hists, gauge_children = {}, {}, {}
    for r in ranks:
        for name, fam in snaps[r]["metrics"].items():
            kind = fam.get("kind")
            for ck, ch in (fam.get("children") or {}).items():
                if kind == "counter":
                    counters[(name, ck)] = (
                        counters.get((name, ck), 0.0) + ch["value"])
                elif kind == "histogram":
                    e = hists.get((name, ck))
                    if e is None:
                        hists[(name, ck)] = {
                            "counts": list(ch["bucket_counts"]),
                            "sum": ch["sum"], "count": ch["count"],
                            "buckets": list(fam["buckets"])}
                    else:
                        e["counts"] = [a + b for a, b in zip(
                            e["counts"], ch["bucket_counts"])]
                        e["sum"] += ch["sum"]
                        e["count"] += ch["count"]
                elif kind == "gauge":
                    gauge_children[(name, ck, r)] = ch["value"]
    m = view["metrics"]
    counter_bad = sum(
        1 for (name, ck), want in counters.items()
        if m.get(name, {}).get("children", {}).get(
            ck, {}).get("value") != want)
    hist_bad = 0
    q_checks, q_bad = 0, 0
    for (name, ck), e in hists.items():
        got = m.get(name, {}).get("children", {}).get(ck)
        if (got is None or got["bucket_counts"] != e["counts"]
                or got["sum"] != e["sum"]
                or got["count"] != e["count"]):
            hist_bad += 1
            continue
        for q in (0.5, 0.95, 0.99):
            q_checks += 1
            want = _truth_quantile(e["buckets"], e["counts"], q,
                                   e["count"])
            if obs.merged_quantile(view, name, q, child=ck) != want:
                q_bad += 1
    gauge_bad, bounded = 0, True
    for (name, ck, r), want in gauge_children.items():
        nkey = f"{ck},{r}" if ck else str(r)
        got = m.get(name, {}).get("children", {}).get(nkey)
        if got is None or got["value"] != want:
            gauge_bad += 1
        if not 0 <= r < view["world_size"]:
            bounded = False
    return {
        "counter_families": len({n for n, _ in counters}),
        "counter_children": len(counters),
        "counter_mismatches": counter_bad,
        "histogram_children": len(hists),
        "histogram_mismatches": hist_bad,
        "quantile_checks": q_checks,
        "quantile_mismatches": q_bad,
        "gauge_children": len(gauge_children),
        "gauge_mismatches": gauge_bad,
        "gauge_rank_labels_bounded": bounded,
    }


# -- legs -------------------------------------------------------------------

def render_lanes(dump, out):
    """Each request lane of a merged dump ("r<rank>:<request>") with its
    digest from the port's ``tracing.request_summary``; returns the
    digests."""
    from paddle_tpu_torch.observability import tracing
    print(f"flight dump: reason={dump['reason']} spans="
          f"{len(dump['spans'])} requests={dump['requests']}", file=out)
    digests = {}
    for r in dump["requests"]:
        d = tracing.request_summary(r, spans=dump["spans"])
        digests[r] = d
        spans = [s for s in dump["spans"] if s["request"] == r]
        print(f"request {r}: {len(spans)} spans; prompt "
              f"{d['prompt_tokens']}, generated {d['generated_tokens']}, "
              f"ttft {d['ttft_s']}", file=out)
    return digests


def healthy_leg():
    from paddle_tpu_torch import observability as obs

    mon, fleet_dir, rcs = _run_fleet(False)
    try:
        return _healthy_report(mon, fleet_dir, rcs)
    finally:
        shutil.rmtree(fleet_dir, ignore_errors=True)


def _healthy_report(mon, fleet_dir, rcs):
    from paddle_tpu_torch import observability as obs

    snaps = obs.discover_snapshots(fleet_dir, run_id=RUN_ID)
    view = obs.merge_snapshots(snaps)
    out = {"rc": rcs, "breaches": len(mon.breaches),
           "ranks": sorted(snaps),
           "exports": {str(r): snaps[r]["seq"] for r in sorted(snaps)}}
    try:
        man = obs.load_fleet_manifest(fleet_dir)
        out["manifest_ok"] = (
            man["run_id"] == RUN_ID
            and sorted(int(r) for r in man["ranks"]) == sorted(snaps)
            and all(man["ranks"][str(r)]["seq"] == snaps[r]["seq"]
                    for r in snaps))
    except (OSError, ValueError) as e:
        out["manifest_ok"] = False
        out["manifest_error"] = str(e)
    out.update(_aggregation_report(snaps, view))
    out["train_steps_seen"] = {
        str(r): snaps[r]["metrics"].get("train_steps_total", {})
        .get("children", {}).get("", {}).get("value")
        for r in sorted(snaps)}
    out["fleet_p50_dispatch_s"] = obs.merged_quantile(
        view, "dispatch_seconds", 0.5, child="paged_step")
    out["monitor"] = mon.summary()
    out["monitor"].pop("clocks", None)
    out["monitor"].pop("breaches", None)
    return out


def fault_leg():
    from paddle_tpu_torch import observability as obs

    mon, fleet_dir, rcs = _run_fleet(True)
    try:
        return _fault_report(mon, fleet_dir, rcs)
    finally:
        shutil.rmtree(fleet_dir, ignore_errors=True)


def _fault_report(mon, fleet_dir, rcs):
    from paddle_tpu_torch import observability as obs

    out = {"rc": rcs, "breaches": len(mon.breaches),
           "breach_ranks": sorted({b["rank"] for b in mon.breaches}),
           "breach_checks": sorted({b["check"] for b in mon.breaches})}
    dump_dir = os.path.join(fleet_dir, "dumps")
    dumps = sorted(
        f for f in (os.listdir(dump_dir)
                    if os.path.isdir(dump_dir) else [])
        if f.startswith("flightrec_fleet_straggler"))
    out["dumps"] = len(dumps)
    out["dump_valid"] = False
    if dumps:
        try:
            dump = obs.load_dump(os.path.join(dump_dir, dumps[0]))
            ctx = dump["context"]
            out["dump_valid"] = dump["reason"] == "fleet_straggler"
            out["dump_rank"] = ctx.get("rank")
            rank_hist = json.loads(ctx.get("rank_hist", "null"))
            fleet_hist = json.loads(ctx.get("fleet_hist", "null"))
            out["witness_hists_ok"] = (
                isinstance(rank_hist, list) and sum(rank_hist) > 0
                and isinstance(fleet_hist, list)
                and sum(fleet_hist) > 0)
            lane_ranks = sorted({
                int(s["request"].split(":")[0][1:])
                for s in dump["spans"]
                if isinstance(s.get("request"), str)
                and s["request"].startswith("r")})
            out["merged_lane_ranks"] = lane_ranks
            buf = io.StringIO()
            render_lanes(dump, buf)
            text = buf.getvalue()
            out["trace_renders"] = (
                len(text) > 0
                and any(f"r{r}:" in text for r in lane_ranks))
        except (ValueError, KeyError, OSError) as e:
            out["dump_valid"] = False
            out["dump_error"] = str(e)
    return out


def build_report():
    report = {"schema": REPORT_SCHEMA, "world": WORLD,
              "monitor_cfg": dict(MON_CFG), "fault_delay_s": FAULT_DELAY_S}
    report["healthy"] = healthy_leg()
    report["fault"] = fault_leg()
    return report


def print_report(report):
    h, f = report["healthy"], report["fault"]
    print(f"healthy: rc={h['rc']} breaches={h['breaches']} "
          f"counters {h['counter_children']} children "
          f"({h['counter_mismatches']} mismatched), "
          f"hists {h['histogram_children']} "
          f"({h['histogram_mismatches']} mismatched), "
          f"quantiles {h['quantile_checks']} "
          f"({h['quantile_mismatches']} off), "
          f"manifest_ok={h['manifest_ok']}")
    p50 = h.get("fleet_p50_dispatch_s")
    print(f"  fleet p50 dispatch: "
          f"{'-' if p50 is None else f'{p50 * 1e3:.1f}ms'}; "
          f"exports={h['exports']} train_steps={h['train_steps_seen']}")
    print(f"fault: rc={f['rc']} breaches={f['breaches']} on ranks "
          f"{f['breach_ranks']} checks {f['breach_checks']}; "
          f"dumps={f['dumps']} valid={f['dump_valid']} "
          f"rank={f.get('dump_rank')} "
          f"lanes={f.get('merged_lane_ranks')} "
          f"renders={f.get('trace_renders')}")


def _lookup(report, dotted):
    cur = report
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def check(baseline_path):
    with open(baseline_path) as f:
        base = json.load(f)
    if base.get("schema") != BASELINE_SCHEMA:
        print(f"{baseline_path}: not a {BASELINE_SCHEMA} baseline")
        return 1
    report = build_report()
    print_report(report)
    bad = []
    for dotted, want in base.get("exact", {}).items():
        got = _lookup(report, dotted)
        if got != want:
            bad.append(f"{dotted}: {got!r} != required {want!r}")
    for dotted, (lo, hi) in base.get("bounds", {}).items():
        got = _lookup(report, dotted)
        if got is None:
            bad.append(f"{dotted}: missing (bounds [{lo}, {hi}])")
        elif not (lo <= got <= hi):
            bad.append(f"{dotted}: {got} outside [{lo}, {hi}]")
    if bad:
        print(f"fleet_obs gate: FAIL ({len(bad)} problems)")
        for b in bad:
            print("  " + b)
        return 1
    print(f"fleet_obs gate OK: {len(base.get('exact', {}))} exact "
          f"fields, {len(base.get('bounds', {}))} bounds")
    return 0


def main():
    ap = argparse.ArgumentParser(
        description="the port's multi-process fleet observability drive "
                    "and gate")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--check", metavar="BASELINE_JSON", default=None)
    # hidden subprocess mode
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=WORLD,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fleet-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--run-id", default=RUN_ID, help=argparse.SUPPRESS)
    ap.add_argument("--delay", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--requests", type=int, default=REQUESTS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--pretrain", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        return rank_worker(args)
    if args.check:
        return check(args.check)
    report = build_report()
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
