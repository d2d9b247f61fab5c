#!/usr/bin/env python
"""Training health monitor drive of the PyTorch port, and its train_health
gate (the port's counterpart of ``tools/train_monitor.py``).

Drives a short pretraining run of the port on one device with the
per-layer-group telemetry and the ``TrainHealthMonitor`` on, healthy and
under injected faults (``paddle_tpu_torch.testing.TrainFaultInjector``),
and checks the same contract as the JAX package's gate, against the same
committed baseline:

* **neutrality** - telemetry on gives the same loss bits as telemetry
  off over the same seeded workload, and no compile after the warm-up
  (``observability.compile_watch``: kernel builds, library loads and
  ``torch.compile``);
* **healthy** - a monitored run through the instrumented
  ``io.DataLoader`` (two workers, ``instrument=True``) raises no breach
  and reports the per-group norms and the data-wait / host / dispatch
  split;
* **faults** - each injected failure fires exactly its detectors, once,
  with a flight dump that loads: a NaN'd batch (out-of-vocab ids read
  NaN embedding rows) fires ``non_finite`` and training carries on; one
  update at 4096 x lr (``run(..., lr_scale=)``) fires ``update_ratio``
  at that step and ``loss_spike`` + ``grad_spike`` at the next; a
  throttled loader fires ``data_stall``.

The workload is the JAX gate's: the tiny Llama (vocab 128, width 64, 2
layers), batches of 8 x 16 from seed 0, model seed 0. By default it runs
on one device, with heads 2 and 1 (head dim 32, the flash kernels'
smallest) on both devices, where the JAX gate has 4 and 2.

``--mesh dp2,fsdp2,mp2`` runs it on the JAX gate's mesh instead: eight
ranks, each a thread with a gloo group over one ``HashStore``
(``testing.run_thread_ranks``), the port's sharded pretraining step
(ZeRO-3 over fsdp, Megatron and the vocab-parallel LM head over mp) with
the JAX gate's heads, 4 and 2. Every rank runs each leg's steps on its
rows of the same batches with the same injected faults; rank 0 holds the
monitor, the instrumented loader and the report (the telemetry vector
and the loss are the global ones on every rank).

  python tools/torch_train_monitor.py [--device cpu|cuda]      # report
  python tools/torch_train_monitor.py --json out.json
  python tools/torch_train_monitor.py --device cpu \
      --check tools/train_health.json
  python tools/torch_train_monitor.py --device cpu --mesh dp2,fsdp2,mp2 \
      --check tools/train_health.json

``--check`` holds the report to every ``exact`` field and ``bounds``
entry of the baseline. The default device is ``cuda``.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPORT_SCHEMA = "paddle_tpu.train_health_report/1"
BASELINE_SCHEMA = "paddle_tpu.train_health/1"

BATCH, SEQ, VOCAB = 8, 16, 128
HEADS, KV_HEADS = 2, 1
MESH_HEADS = (4, 2)         # the JAX gate's, on its mesh
RANK_TIMEOUT_S = 120.0

DEFAULT_MONITOR = {
    "window_s": 120.0, "min_count": 4, "loss_spike_mads": 8.0,
    "grad_spike_mads": 8.0, "mad_floor_frac": 0.05,
    "update_ratio_bounds": [1e-9, 1.0], "data_stall_s": 0.3,
    "cooldown_s": 600.0,
}


def parse_mesh(text):
    """"dp2,fsdp2,mp2" -> {"dp": 2, "fsdp": 2, "mp": 2}."""
    out = {}
    for part in text.split(","):
        axis = part.rstrip("0123456789")
        if axis not in ("dp", "fsdp", "mp") or axis == part:
            raise ValueError(f"--mesh: {part!r} is not dpN, fsdpN or mpN")
        out[axis] = int(part[len(axis):])
    return out


def _on_ranks(device, mesh_kw, leg):
    """``leg(mesh)`` on one device (``mesh`` None) or on every thread rank
    of the mesh; rank 0's result."""
    if mesh_kw is None:
        return leg(None)
    from paddle_tpu_torch.models import pretrain
    from paddle_tpu_torch.testing import run_thread_ranks
    world = int(np.prod(list(mesh_kw.values())))

    def rank(r, group):
        return leg(pretrain.make_mesh(world, group=group, device=device,
                                      **mesh_kw))
    return run_thread_ranks(world, rank, timeout=RANK_TIMEOUT_S)[0]


def _lead(mesh):
    """Whether this rank holds the monitor, the loader and the report."""
    return mesh is None or mesh.rank == 0


def _fresh_run(device, telemetry=False, monitor=None, mesh=None):
    """A freshly seeded model, its train state and its step (this rank's
    shards on a mesh): every leg starts from the same parameters."""
    from paddle_tpu_torch.core import random as _random
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         pretrain)
    if mesh is None:
        _random.seed(0)
    heads = (HEADS, KV_HEADS) if mesh is None else MESH_HEADS
    cfg = LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=heads[0],
        num_key_value_heads=heads[1], max_position_embeddings=SEQ,
        dtype="float32")
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    params, opt_state, meta = pretrain.make_train_state(model, mesh)
    step = pretrain.make_train_step(model, mesh, meta, telemetry=telemetry,
                                    monitor=monitor)
    return params, opt_state, step


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (BATCH, SEQ)).astype(
                 np.int32),
             "labels": rng.integers(0, VOCAB, (BATCH, SEQ)).astype(
                 np.int32)}
            for _ in range(n)]


def _to_device(batch, device, mesh=None):
    """The batch on the device; on a mesh this rank's rows of it."""
    from paddle_tpu_torch.models import pretrain
    batch = {k: np.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        return pretrain.shard_batch(batch, mesh)
    return pretrain.batch_to_device(batch, device)


def _monitor(base_cfg, flight_dir, **overrides):
    from paddle_tpu_torch import observability as obs
    flight = obs.FlightRecorder(min_interval_s=0.0)
    flight.arm(flight_dir)
    return obs.TrainHealthMonitor.from_config(
        base_cfg, flight_recorder=flight, **overrides)


def _collect_dumps(flight):
    """Load and check every dump the leg's recorder wrote."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import train_health as th
    out, ok = [], True
    for path in flight.dumps:
        try:
            dump = obs.load_dump(path)
            digest = th.breach_summary(dump)
            out.append({"reason": dump["reason"],
                        "check": digest["check"], "valid": True})
        except (OSError, ValueError) as e:
            ok = False
            out.append({"reason": os.path.basename(path),
                        "check": None, "valid": False, "error": str(e)})
    return out, ok


def _collate(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def neutrality_leg(device, steps=6, mesh_kw=None):
    """Telemetry on against off: the same loss bits, and no compile after
    the two warm-up steps."""
    from paddle_tpu_torch.observability import compile_watch

    compile_watch.install()
    return _on_ranks(device, mesh_kw,
                     lambda mesh: _neutrality(device, steps, mesh))


def _neutrality(device, steps, mesh):
    from paddle_tpu_torch.observability import compile_watch

    def drive(telemetry):
        params, opt_state, step = _fresh_run(device, telemetry=telemetry,
                                             mesh=mesh)
        losses = []
        after_warmup = None
        for i, b in enumerate(_batches(steps)):
            if i == 2:
                after_warmup = compile_watch.compiles()
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh))
            losses.append(float(loss))
        return losses, float(compile_watch.compiles() - after_warmup)

    losses_off, _ = drive(False)
    losses_on, new_compiles = drive(True)
    return {
        "steps": steps,
        "losses_off": losses_off,
        "losses_on": losses_on,
        "loss_exact": losses_off == losses_on,
        "new_compiles_after_warmup": new_compiles,
    }


def healthy_leg(device, monitor_cfg, steps=10, mesh_kw=None):
    """A monitored run through the instrumented DataLoader: no breach,
    the per-group norms, the step-phase split."""
    from paddle_tpu_torch.observability import train_health as th

    th.pop_data_wait()      # no stale wait from an earlier leg
    return _on_ranks(device, mesh_kw,
                     lambda mesh: _healthy(device, monitor_cfg, steps, mesh))


def _healthy(device, monitor_cfg, steps, mesh):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.io import DataLoader

    if not _lead(mesh):
        params, opt_state, step = _fresh_run(device, telemetry=True,
                                             mesh=mesh)
        for b in _batches(steps):
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh))
        return None
    flight_dir = tempfile.mkdtemp(prefix="train_health_ok_")
    try:
        mon = _monitor(monitor_cfg, flight_dir, data_stall_s=30.0)
        params, opt_state, step = _fresh_run(device, monitor=mon, mesh=mesh)
        samples = []
        for b in _batches(steps):
            for j in range(BATCH):
                samples.append({"input_ids": b["input_ids"][j],
                                "labels": b["labels"][j]})
        loader = DataLoader(samples, batch_size=BATCH, num_workers=2,
                            instrument=True, collate_fn=_collate)
        loader.health_monitor = mon
        n = 0
        for b in loader:
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh))
            n += 1
            if n >= steps:
                break
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)

    reg = obs.get_registry()
    snap = reg.snapshot()

    def gauge_children(name):
        return {k: v["value"]
                for k, v in snap.get(name, {}).get("children", {}).items()}

    def p50(name):
        fam = reg.get(name)
        return None if fam is None or not fam.count else fam.quantile(0.5)

    groups = {}
    for label, g in gauge_children("train_group_grad_norm").items():
        groups[label] = {
            "grad_norm": g,
            "param_norm": gauge_children(
                "train_group_param_norm").get(label),
            "update_ratio": gauge_children(
                "train_group_update_ratio").get(label),
        }
    return {
        "steps": n,
        "breaches": mon.breaches_total,
        "breach_counts": dict(mon.breach_counts),
        "data_batches": int(
            snap.get("train_data_batches_total", {}).get(
                "children", {}).get("", {}).get("value", 0)),
        "group_norms": groups,
        "phase_p50_s": {"data_wait": p50("train_data_wait_seconds"),
                        "host": p50("train_host_seconds"),
                        "dispatch": p50("train_step_seconds")},
    }


def _leg_run(device, monitor_cfg, flight_dir, mesh):
    """(monitor or None, params, opt_state, step) of one fault leg's rank:
    rank 0 (or the one device) holds the monitor."""
    mon = _monitor(monitor_cfg, flight_dir) if _lead(mesh) else None
    return (mon,) + _fresh_run(device, telemetry=True, monitor=mon,
                               mesh=mesh)


def nan_batch_leg(device, monitor_cfg, steps=8, fault_at=5, mesh_kw=None):
    """Out-of-vocab ids at one step: non-finite loss and grads, the
    non_finite detector fires once (on the transition), a
    non_finite_loss dump lands and the loop runs to its end."""
    from paddle_tpu_torch.observability import train_health as th

    th.pop_data_wait()
    return _on_ranks(device, mesh_kw, lambda mesh: _nan_batch(
        device, monitor_cfg, steps, fault_at, mesh))


def _nan_batch(device, monitor_cfg, steps, fault_at, mesh):
    from paddle_tpu_torch.testing.faults import TrainFaultInjector

    flight_dir = tempfile.mkdtemp(prefix="train_health_nan_")
    try:
        mon, params, opt_state, step = _leg_run(device, monitor_cfg,
                                                flight_dir, mesh)
        inj = TrainFaultInjector().nan_batch(fault_at)
        completed = 0
        for i, b in enumerate(_batches(steps)):
            b = inj.adjust_batch(i, b)
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh))
            completed += 1
        if mon is None:
            return None
        dumps, dumps_valid = _collect_dumps(mon.flight_recorder)
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    return {
        "steps": completed,
        "fault_at": fault_at,
        "injected": dict(inj.injected),
        "fired": dict(mon.breach_counts),
        "dump_reasons": sorted(d["reason"] for d in dumps),
        "dumps_valid": dumps_valid,
        "continued_after_fault": completed == steps,
    }


def lr_spike_leg(device, monitor_cfg, steps=10, fault_at=6, factor=4096.0,
                 mesh_kw=None):
    """One update at factor x lr: update_ratio at the faulted step, then
    loss_spike and grad_spike at the next."""
    from paddle_tpu_torch.observability import train_health as th

    th.pop_data_wait()
    return _on_ranks(device, mesh_kw, lambda mesh: _lr_spike(
        device, monitor_cfg, steps, fault_at, factor, mesh))


def _lr_spike(device, monitor_cfg, steps, fault_at, factor, mesh):
    from paddle_tpu_torch.testing.faults import TrainFaultInjector

    flight_dir = tempfile.mkdtemp(prefix="train_health_lr_")
    try:
        mon, params, opt_state, step = _leg_run(device, monitor_cfg,
                                                flight_dir, mesh)
        inj = TrainFaultInjector().lr_spike(fault_at, factor=factor)
        for i, b in enumerate(_batches(steps)):
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh),
                lr_scale=inj.lr_scale_for(i))
        if mon is None:
            return None
        dumps, dumps_valid = _collect_dumps(mon.flight_recorder)
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    return {
        "steps": steps,
        "fault_at": fault_at,
        "factor": factor,
        "injected": dict(inj.injected),
        "fired": dict(mon.breach_counts),
        "dump_reasons": sorted(d["reason"] for d in dumps),
        "dumps_valid": dumps_valid,
    }


def data_stall_leg(device, monitor_cfg, steps=6, stall_at=3, delay_s=1.0,
                   mesh_kw=None):
    """A throttled loader: the sleep sits upstream of the instrumented
    loader's wait measurement, so the stall detector sees a starved
    pipeline and fires the data_stall dump."""
    from paddle_tpu_torch.observability import train_health as th

    th.pop_data_wait()
    return _on_ranks(device, mesh_kw, lambda mesh: _data_stall(
        device, monitor_cfg, steps, stall_at, delay_s, mesh))


def _data_stall(device, monitor_cfg, steps, stall_at, delay_s, mesh):
    from paddle_tpu_torch.observability import train_health as th
    from paddle_tpu_torch.testing.faults import TrainFaultInjector

    flight_dir = tempfile.mkdtemp(prefix="train_health_stall_")
    try:
        mon, params, opt_state, step = _leg_run(device, monitor_cfg,
                                                flight_dir, mesh)
        inj = TrainFaultInjector().stall_loader(stall_at, delay_s=delay_s)
        loader = _batches(steps) if mon is None else th.instrument_loader(
            inj.wrap_loader(_batches(steps)), monitor=mon)
        for b in loader:
            params, opt_state, loss, gnorm = step(
                params, opt_state, _to_device(b, device, mesh))
        if mon is None:
            return None
        dumps, dumps_valid = _collect_dumps(mon.flight_recorder)
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    return {
        "steps": steps,
        "stall_at": stall_at,
        "delay_s": delay_s,
        "injected": dict(inj.injected),
        "fired": dict(mon.breach_counts),
        "dump_reasons": sorted(d["reason"] for d in dumps),
        "dumps_valid": dumps_valid,
    }


def build_report(monitor_cfg, device="cuda", mesh_kw=None):
    from paddle_tpu_torch.observability import train_health as th

    _, _, step = _fresh_run(device, telemetry=True)
    return {
        "schema": REPORT_SCHEMA,
        "workload": {"device": device, "batch": BATCH, "seq": SEQ,
                     "vocab": VOCAB, "mesh": mesh_kw,
                     "heads": list(MESH_HEADS) if mesh_kw
                     else [HEADS, KV_HEADS]},
        "monitor": dict(monitor_cfg),
        "groups": list(step._telemetry_spec.labels),
        "checks": list(th.CHECKS),
        "neutrality": neutrality_leg(device, mesh_kw=mesh_kw),
        "healthy": healthy_leg(device, monitor_cfg, mesh_kw=mesh_kw),
        "faults": {
            "nan_batch": nan_batch_leg(device, monitor_cfg,
                                       mesh_kw=mesh_kw),
            "lr_spike": lr_spike_leg(device, monitor_cfg, mesh_kw=mesh_kw),
            "data_stall": data_stall_leg(device, monitor_cfg,
                                         mesh_kw=mesh_kw),
        },
    }


def print_report(report):
    n = report["neutrality"]
    print(f"neutrality: loss_exact={n['loss_exact']} over {n['steps']} "
          f"steps, {n['new_compiles_after_warmup']} compiles after "
          f"warmup")
    h = report["healthy"]
    ph = h["phase_p50_s"]

    def ms(v):
        return "-" if v is None else f"{v * 1e3:.1f}ms"

    print(f"healthy: {h['breaches']} breaches over {h['steps']} steps "
          f"({h['data_batches']} batches); p50 data-wait "
          f"{ms(ph['data_wait'])} / host {ms(ph['host'])} / dispatch "
          f"{ms(ph['dispatch'])}")
    print(f"{'group':>14} | {'grad_norm':>10} | {'param_norm':>10} | "
          f"{'upd/param':>10}")
    for label in report["groups"]:
        g = h["group_norms"].get(label)
        if g is None:
            continue
        print(f"{label:>14} | {g['grad_norm']:>10.4f} | "
              f"{g['param_norm']:>10.2f} | {g['update_ratio']:>10.2e}")
    for name, leg in report["faults"].items():
        print(f"fault {name}: fired={leg['fired']} "
              f"dumps={leg['dump_reasons']} valid={leg['dumps_valid']}")


def _lookup(report, dotted):
    cur = report
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def check(baseline_path, device="cuda", mesh_kw=None):
    """The train_health gate: every exact field and bound of the
    baseline."""
    with open(baseline_path) as f:
        base = json.load(f)
    if base.get("schema") != BASELINE_SCHEMA:
        print(f"{baseline_path}: not a {BASELINE_SCHEMA} baseline")
        return 1
    report = build_report(base.get("monitor", DEFAULT_MONITOR), device,
                          mesh_kw)
    print_report(report)
    bad = []
    if report.get("schema") != REPORT_SCHEMA:
        bad.append(f"report schema {report.get('schema')!r}")
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
    where = device if mesh_kw is None else f"{device}, mesh " + ",".join(
        f"{a}{n}" for a, n in mesh_kw.items())
    if bad:
        print(f"train_health gate ({where}): FAIL ({len(bad)} problems)")
        for b in bad:
            print("  " + b)
        return 1
    print(f"train_health gate OK ({where}): {len(base.get('exact', {}))} "
          f"exact fields, {len(base.get('bounds', {}))} bounds")
    return 0


def main():
    ap = argparse.ArgumentParser(
        description="the port's training health monitor drive and "
                    "train_health gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--check", metavar="BASELINE_JSON", default=None,
                    help="gate the report against a committed "
                         "train_health baseline")
    ap.add_argument("--mesh", default=None, metavar="dp2,fsdp2,mp2",
                    help="run on this mesh of thread ranks (the JAX "
                         "gate's: dp2,fsdp2,mp2)")
    args = ap.parse_args()
    mesh_kw = None if args.mesh is None else parse_mesh(args.mesh)
    if args.check:
        return check(args.check, args.device, mesh_kw)
    report = build_report(DEFAULT_MONITOR, args.device, mesh_kw)
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
