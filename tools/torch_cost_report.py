#!/usr/bin/env python
"""Per-program cost and memory report of the PyTorch port, and its leg of
the ``train_obs`` gate (the port's form of ``tools/cost_report.py``'s
serve leg).

The serve leg drives the ragged continuous-batching workload of the JAX
tool (tiny engine of ``tools/torch_serve_gates.py``, prompts of a
repeated pattern, speculative decode and prefix caching on) with the
cost catalog enabled (``paddle_tpu_torch.observability.costs``), so that
all three serving programs are dispatched and counted: ``paged_step``,
``paged_rewind`` and ``paged_copy``. It asserts that the catalog only
observes: tokens equal a run with the catalog off, no new step bucket and
no new ``compiles_total`` child (an ``nvcc`` build or a library load)
after warm-up; and it takes a live-tensor census before and after the
replay churn, which must come back to its baseline with the KV pool at
zero blocks in use.

Modes:
  python tools/torch_cost_report.py [--device cpu] [--json OUT]
  python tools/torch_cost_report.py --device cpu --check tools/train_obs.json

The pretrain leg is the JAX tool's (``tools/cost_report.py``
``pretrain_cost_leg``) over the port's mesh: dp 2 x fsdp 2 x mp 2, eight
ranks that are threads of this process (gloo over one ``HashStore``),
the same tiny config and batches; rank 0's step is counted by the
catalog (``pretrain_step``: flops, bytes and the peak; the other ranks
step with catalogs of their own that stay disabled), ``shard_skew`` of the placed masters over the world
group, and then one eager all_reduce and all_gather over the world with
the comm watchdog on, whose (op, axis) labels the baseline names. It also
reports rank 0's collectives of the last step by op and axis.

``--check`` holds the report to the committed JAX baseline: its required
programs, its exact fields and its bounds at the same tiny workload (the
count is of the same work). Skipped, by name (``SKIPPED``), with the
reason the port's count cannot meet them; no bound is widened. On the
card (the default device) the engine's head dim is 32, the kernel's
smallest, so the baseline's CPU numbers do not apply there: the report
is printed, and the neutrality, leak and compile gates are held.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPORT_SCHEMA = "paddle_tpu.cost_report/1"
BASELINE_SCHEMA = "paddle_tpu.train_obs/1"

SERVE_PROGRAMS = ("paged_step", "paged_rewind", "paged_copy")

_NO_PRODUCTS = ("FlopCounterMode counts products (matmul, convolution, "
                "attention) only; {} does none, so the count is 0 and no "
                "MFU follows, where XLA counts each element-wise op")

# baseline keys the port's count cannot meet, with the reason
SKIPPED = {
    "serve.programs.paged_rewind.flops": _NO_PRODUCTS.format(
        "a rewind zeroes cache slots and"),
    "serve.programs.paged_rewind.mfu": _NO_PRODUCTS.format(
        "a rewind zeroes cache slots and"),
    "serve.programs.paged_copy.flops": _NO_PRODUCTS.format(
        "a block copy"),
    "serve.programs.paged_copy.mfu": _NO_PRODUCTS.format("a block copy"),
    "serve.programs.paged_copy.bytes_accessed": (
        "the port copies one block in place in each layer's cache; XLA's "
        "functional update reads and writes each layer's whole cache"),
}
_IN_PLACE_PEAK = ("the port {} in place and makes no new storage, so the "
                  "peak is the arguments' bytes; XLA's functional update "
                  "allocates each updated cache as an output")
SKIPPED.update({
    "serve.programs.paged_rewind.peak_hbm": _IN_PLACE_PEAK.format(
        "zeroes the rewound cache slots"),
    "serve.programs.paged_copy.peak_hbm": _IN_PLACE_PEAK.format(
        "copies one block"),
})
# the port's own exact fields beside the baseline's
PORT_EXACT = {"serve.new_compiles_after_warmup": 0}


def serve_cost_leg(device, new_tokens=24, spec_k=4, chunk=8, block_size=8):
    """The ragged serving workload with the catalog on; the per-program
    attribution plus the neutrality, compile and leak gates."""
    import numpy as np

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from paddle_tpu_torch.observability import compile_watch
    from tools.torch_serve_gates import tiny_engine

    compile_watch.install()
    rng = np.random.default_rng(0)
    eng, _ = tiny_engine(rng, 128, device)
    pattern = [7, 23, 41, 11]
    prompts = [np.asarray(pattern * 8, np.int32),
               np.asarray(pattern * 4, np.int32)]

    def make_cb():
        return ContinuousBatchingEngine(
            eng, num_blocks=24, block_size=block_size, max_batch=2,
            prefill_chunk=chunk, spec_k=spec_k, prefix_cache=True)

    def drive(cb, tag):
        reqs = [GenerationRequest(p.copy(), new_tokens,
                                  request_id=f"{tag}{j}")
                for j, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        out = cb.run()
        return [out[r.request_id] for r in reqs]

    def compile_children():
        fam = obs.get_registry().snapshot().get("compiles_total", {})
        return {k: c["value"] for k, c in fam.get("children", {}).items()}

    catalog = obs.get_cost_catalog()
    catalog.reset()
    catalog.enabled = True
    cb = make_cb()
    try:
        drive(cb, "cw")             # cold: counted at the first calls
        drive(cb, "cm")             # resume: the prefix cache's buckets
        cb.declare_warm()
        warm_buckets = set(cb._seen_buckets)
        warm_compiles = compile_children()
        baseline_census = obs.live_array_census()
        out_on = drive(cb, "cr")    # replay churn: the leak window
        final_census = obs.live_array_census()
        new_buckets = len(set(cb._seen_buckets) - warm_buckets)
        new_compiles = int(sum(v - warm_compiles.get(k, 0)
                               for k, v in compile_children().items()))
    finally:
        catalog.enabled = False
    cb_off = make_cb()              # the reference: the catalog off
    drive(cb_off, "cf")
    out_off = drive(cb_off, "cg")
    leak = obs.census_diff(baseline_census, final_census)
    rows = {r["program"]: r for r in catalog.table()
            if r["program"] in SERVE_PROGRAMS}
    obs.record_census(final_census)
    return {
        "device": device,
        "workload": {"prompt_lens": [len(p) for p in prompts],
                     "new_tokens": new_tokens, "spec_k": spec_k,
                     "chunk": chunk, "block_size": block_size},
        "token_exact": out_on == out_off,
        "new_buckets_after_warmup": new_buckets,
        "new_compiles_after_warmup": new_compiles,
        "leak": {
            "census_delta_groups": len(leak),
            "census_delta": leak,
            "kv_used_final": cb.allocator.num_used,
            "kv_pooled_final": cb.allocator.num_pooled,
        },
        "programs": rows,
    }


def pretrain_cost_leg(device, steps=3, dp=2, fsdp=2, mp=2):
    """The sharded pretrain step on thread ranks: rank 0's pretrain_step
    cost and MFU (each step's loss read, so the host wall is the step's),
    the shard skew of the placed masters, and eager-collective telemetry
    through the watchdog."""
    import numpy as np
    import torch

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import collective, comm_watchdog
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         pretrain)
    from paddle_tpu_torch.testing import run_thread_ranks

    n = dp * fsdp * mp
    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, dtype="float32")
    rng = np.random.default_rng(0)
    b, s = max(2, dp * fsdp), 32
    batches = [{"input_ids": rng.integers(0, 128, (b, s)).astype(np.int32),
                "labels": rng.integers(0, 128, (b, s)).astype(np.int32)}
               for _ in range(steps)]
    catalog = obs.get_cost_catalog()

    def rank(r, group):
        mesh = pretrain.make_mesh(n, dp=dp, fsdp=fsdp, mp=mp, group=group,
                                  device=device)
        model = LlamaForCausalLM(cfg, device=device)
        params, opt, meta = pretrain.make_train_state(model, mesh)
        skew = obs.shard_skew(params, group=group)
        step = pretrain.make_train_step(
            model, mesh, meta,
            catalog=catalog if r == 0 else obs.CostCatalog())
        loss = None
        for batch in batches:
            params, opt, loss, _ = step(params, opt,
                                        pretrain.shard_batch(batch, mesh))
            float(loss)     # block: the host wall is the step's
        return {"skew": skew, "loss": float(loss), "comm": dict(step.comm)}

    catalog.enabled = True
    try:
        ranks = run_thread_ranks(n, rank, timeout=120)
    finally:
        catalog.enabled = False

    def eager(r, group):
        dev = "cuda" if device != "cpu" else "cpu"
        collective.all_reduce(torch.ones(4096, device=dev), group=group,
                              axis="world")
        collective.all_gather([], torch.ones(1024, device=dev), group=group,
                              axis="world")
    # eager-collective telemetry through the watchdog: one all_reduce and
    # one all_gather over the world, the fleet.metrics path of the JAX leg
    comm_watchdog.enable_comm_watchdog(timeout=600, poll_interval=60)
    try:
        run_thread_ranks(n, eager, timeout=120)
    finally:
        comm_watchdog.disable_comm_watchdog()
    snap = obs.get_registry().snapshot()
    coll = sorted(snap.get("collective_seconds", {}).get("children", {}))
    bw = {k: v["value"] for k, v in snap.get(
        "collective_bandwidth_bytes_per_s", {}).get("children",
                                                    {}).items()}
    rows = {r["program"]: r for r in catalog.table()
            if r["program"] == "pretrain_step"}
    skew = ranks[0]["skew"]
    return {
        "mesh": {"dp": dp, "fsdp": fsdp, "mp": mp},
        "steps": steps,
        "tokens_per_step": b * s,
        "final_loss": ranks[0]["loss"],
        "shard_skew": skew.get("skew"),
        "shard_devices": len(skew.get("devices", {})),
        "shard_bytes": skew.get("devices", {}),
        "collectives": coll,
        "collective_bandwidth": bw,
        "step_collectives_rank0": ranks[0]["comm"],
        "programs": rows,
    }


def build_report(device):
    from paddle_tpu_torch import observability as obs
    return {
        "schema": REPORT_SCHEMA,
        "peaks": {"flops_per_s": obs.peak_flops(),
                  "bytes_per_s": obs.peak_bandwidth()},
        "serve": serve_cost_leg(device),
        "pretrain": pretrain_cost_leg(device),
    }


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        for div, unit in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
            if v >= div:
                return f"{v / div:.2f}{unit}"
        return f"{v:.4g}"
    return str(v)


def _program_row(name, r):
    lat = r.get("device_s")
    return " | ".join(f"{v:>12}" for v in (
        name, _fmt(r.get("flops")), _fmt(r.get("bytes_accessed")),
        "-" if r.get("intensity") is None else f"{r['intensity']:.2f}",
        _fmt(r.get("peak_hbm")),
        "-" if lat is None else f"{lat * 1e3:.3f}ms",
        "-" if r.get("mfu") is None else f"{r['mfu']:.2e}",
        "-" if r.get("roofline_frac") is None
        else f"{r['roofline_frac']:.2e}"))


def print_report(report):
    s = report["serve"]
    print(f"peaks: {_fmt(report['peaks']['flops_per_s'])}FLOP/s, "
          f"{_fmt(report['peaks']['bytes_per_s'])}B/s"
          + (" (nominal CPU peaks: MFU is coverage evidence, not a speed "
             "claim)" if s["device"] == "cpu" else ""))
    cols = ("program", "flops", "bytes", "intensity", "peak_hbm",
            "device_p50", "mfu", "roofline")
    print(" | ".join(f"{c:>12}" for c in cols))
    p = report["pretrain"]
    for name, r in sorted(list(s["programs"].items())
                          + list(p["programs"].items())):
        print(_program_row(name, r))
        for k, kc in sorted(r.get("kernels", {}).items()):
            print(f"{'':>14}{k}: {kc['launches']} launches, "
                  f"{_fmt(float(kc['bytes']))}B, {_fmt(float(kc['flops']))}"
                  "FLOP")
    print(f"serve: token_exact={s['token_exact']}, "
          f"{s['new_buckets_after_warmup']} new buckets and "
          f"{s['new_compiles_after_warmup']} new compiles after warmup, "
          f"census leak groups={s['leak']['census_delta_groups']}, "
          f"KV used after retirement={s['leak']['kv_used_final']}")
    print(f"pretrain: mesh {p['mesh']} on thread ranks, {p['steps']} steps "
          f"of {p['tokens_per_step']} tokens, final loss "
          f"{p['final_loss']:.4f}, shard_skew {p['shard_skew']:.3f} over "
          f"{p['shard_devices']} ranks, watchdog labels {p['collectives']}")
    print("pretrain: rank 0's collectives a step: "
          + ", ".join(f"{k} {v['calls']} calls {_fmt(float(v['bytes']))}B"
                      for k, v in sorted(
                          p["step_collectives_rank0"].items())))


def _lookup(report, dotted):
    cur = report
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def check(baseline_path, device):
    """The train_obs gate: schema, required programs, exact fields and
    bounds against the committed baseline, less the named skips."""
    with open(baseline_path) as f:
        base = json.load(f)
    if base.get("schema") != BASELINE_SCHEMA:
        print(f"{baseline_path}: not a {BASELINE_SCHEMA} baseline")
        return 1
    report = build_report(device)
    print_report(report)
    skipped = SKIPPED
    bad, skips = [], []

    def skip(key, why):
        skips.append((key, why))

    if report.get("schema") != REPORT_SCHEMA:
        bad.append(f"report schema {report.get('schema')!r}")
    programs = dict(report["serve"]["programs"],
                    **report["pretrain"]["programs"])
    for name in base["require_programs"]:
        r = programs.get(name)
        if r is None:
            bad.append(f"program {name} not attributed")
            continue
        leg = "serve" if name in SERVE_PROGRAMS else "pretrain"
        for field in ("flops", "bytes_accessed", "peak_hbm", "mfu"):
            key = f"{leg}.programs.{name}.{field}"
            if r.get(field) is not None:
                continue
            if key in skipped:
                skip(f"require {key}", skipped[key])
            else:
                bad.append(f"{name}.{field} missing")
    exact = dict(base.get("exact", {}), **PORT_EXACT)
    for dotted, want in exact.items():
        got = _lookup(report, dotted)
        if got != want:
            bad.append(f"{dotted}: {got!r} != required {want!r}")
    if device != "cpu":
        print("bounds: the baseline's are CPU numbers at head dim 16; on "
              "the card (head dim 32) they are not compared")
    for dotted, (lo, hi) in base.get("bounds", {}).items():
        if dotted in skipped:
            skip(dotted, skipped[dotted])
            continue
        if device != "cpu":
            continue
        got = _lookup(report, dotted)
        if got is None:
            bad.append(f"{dotted}: missing (bounds [{lo}, {hi}])")
        elif not (lo <= got <= hi):
            bad.append(f"{dotted}: {got} outside [{lo}, {hi}]")
    for key, why in skips:
        print(f"  skipped {key}: {why}")
    if bad:
        print(f"train_obs gate (port): FAIL ({len(bad)} problems)")
        for b in bad:
            print("  " + b)
        return 1
    print(f"train_obs gate (port) OK: "
          f"{len(base['require_programs'])} programs attributed, "
          f"{len(exact)} exact fields, {len(base.get('bounds', {}))} "
          f"bounds, {len(skips)} skipped by name")
    return 0


def main():
    ap = argparse.ArgumentParser(
        description="the port's per-program cost / memory report and its "
                    "leg of the train_obs gate")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--check", metavar="BASELINE_JSON", default=None,
                    help="gate the report against a committed train_obs "
                         "baseline")
    args = ap.parse_args()
    if args.check:
        return check(args.check, args.device)
    report = build_report(args.device)
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
