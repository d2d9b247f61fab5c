#!/usr/bin/env python
"""Serve a llama-style model over the HTTP/SSE gateway with the PyTorch
port (``paddle_tpu_torch``) on an NVIDIA GPU.

The port's counterpart of examples/serve_gateway.py: the port's
continuous-batching engine (paged ragged attention on the hand-written
CUDA kernel, chunked prefill, speculative decode, prefix caching,
priority/deadline resilience) on a dedicated stepper thread, fronted by
the asyncio gateway — per-token SSE streaming, mid-stream cancellation,
and the live observability control plane (/metrics, /slo, /requests,
/dumps, /healthz).

The engine runs on the GPU ("cuda") and the script fails where there is
none; ``--device cpu`` runs the kernels' plain PyTorch versions instead.
The flight recorder is armed by default with bounded retention, and
Ctrl-C (or a mid-run sys.exit) leaves an `operator_abort` flight dump
carrying the span window + a final metrics snapshot.

``--tp N`` serves the model tensor-parallel over N ranks: this process
is rank 0 (the scheduler, the stepper, the gateway) and starts N-1
follower processes of this script, each holding 1/N of the heads, the
FFN width and the paged KV cache and replaying rank 0's steps; the group
is gloo over a FileStore in a temporary directory (every operation
bounded by 60 s), so all ranks may share one card. /healthz then reports
one device row per rank.

Try it:
  python examples/torch_serve_gateway.py --port 8000 &
  curl -N -X POST localhost:8000/v1/generate \
    -d '{"prompt": [11, 7, 19], "max_new_tokens": 8}'
  curl localhost:8000/metrics | head
  curl localhost:8000/healthz
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser(
        description="HTTP/SSE serving gateway over the PyTorch port's "
                    "continuous-batching engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--num-blocks", type=int, default=64,
                    help="paged-KV pool size (blocks)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length (greedy only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed COW prefix sharing")
    ap.add_argument("--shed-on-pressure", action="store_true",
                    help="shed low-priority queued work on SLO burn")
    ap.add_argument("--no-flight-recorder", action="store_true",
                    help="do not arm the anomaly flight recorder "
                         "(armed by default with bounded retention)")
    ap.add_argument("--flight-dir", default=None)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (this process and tp-1 "
                         "followers)")
    ap.add_argument("--follower-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.follower_rank:
        return follow(args)

    from paddle_tpu_torch.observability import tracing

    if not args.no_flight_recorder:
        fr = tracing.arm_default(args.flight_dir)
        print(f"flight recorder armed: {fr._dir} "
              f"(max_dumps={fr.max_dumps}, max_bytes={fr.max_bytes})")

    procs, tmp, group = [], None, None
    if args.tp > 1:
        tmp = tempfile.mkdtemp(prefix="torch_serve_gateway_tp_")
        args.store = os.path.join(tmp, "store")
        for rank in range(1, args.tp):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)] + sys.argv[1:]
                + ["--follower-rank", str(rank), "--store", args.store,
                   "--no-flight-recorder"]))
        from paddle_tpu_torch.distributed.collective import new_group
        group = new_group(0, args.tp, args.store, timeout=TP_TIMEOUT_S)
    engine = None
    try:
        engine, V, L = build_engine(args, group)
        return serve(args, engine, V, L)
    finally:
        stop_followers(engine, procs)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


TP_TIMEOUT_S = 60.0


def build_engine(args, group):
    """The serve_llama demo model (random weights, llama-shaped config),
    with a head dim the card's attention kernel takes (32, 64 or 128);
    under --tp this rank's shard. Returns (engine, vocab, layers)."""
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine

    rng = np.random.default_rng(0)
    V, E, H, G, D, L, F = 512, 128, 4, 2, 32, 4, 344
    SMAX = 128

    def mk(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    weights = dict(
        ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        qkv_weights=[mk(H + 2 * G, D, E) for _ in range(L)],
        linear_weights=[mk(H * D, E) for _ in range(L)],
        ffn_ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        ffn1_weights=[mk(E, 2 * F) for _ in range(L)],
        ffn2_weights=[mk(F, E) for _ in range(L)],
        embedding=mk(V, E), lm_head=mk(E, V))
    engine = FusedMultiTransformerEngine(
        weights, num_heads=H, head_dim=D, max_seq_len=SMAX, dtype="float32",
        norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
        tp=args.tp, group=group, device=args.device)
    return engine, V, L


def follow(args):
    """A follower rank: its shard of the model, replaying rank 0's steps
    until rank 0 stops it (or exits)."""
    from paddle_tpu_torch.distributed.collective import new_group
    group = new_group(args.follower_rank, args.tp, args.store,
                      timeout=TP_TIMEOUT_S)
    engine, _, _ = build_engine(args, group)
    engine.serve_follower()
    return 0


def stop_followers(engine, procs):
    """Stop and join (bounded) every follower process; one that does not
    stop is killed."""
    if not procs:
        return
    if engine is not None:
        try:
            engine.stop_followers()
        except RuntimeError as e:     # a follower already gone
            print(f"stopping followers: {e}", file=sys.stderr)
    for proc in procs:
        try:
            proc.wait(TP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def serve(args, engine, V, L):
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from paddle_tpu_torch.observability import SLOMonitor, get_registry
    from paddle_tpu_torch.serving import run_gateway

    monitor = SLOMonitor.from_config({
        "cadence_s": 1.0,
        "objectives": [
            {"name": "ttft_p99", "kind": "quantile",
             "metric": "serve_ttft_seconds", "q": 0.99, "max": 60.0},
            {"name": "kv_alloc_failure_ratio", "kind": "ratio",
             "num": "kv_alloc_failures_total",
             "den": "serve_tokens_total", "max": 0.001},
        ]})
    kw = dict(num_blocks=args.num_blocks, block_size=args.block_size,
              max_batch=args.max_batch, prefill_chunk=args.prefill_chunk,
              token_budget=args.token_budget, spec_k=args.spec_k)
    # build and load the kernels, and take one step, on this thread before
    # the stepper starts: the first request must not wait for the build
    warm = ContinuousBatchingEngine(engine, **kw)
    warm.submit(GenerationRequest(np.arange(1, 9, dtype=np.int32), 2))
    warm.run()
    if warm.tp > 1:
        rows = warm.device_kv_report()
        comm = get_registry().get("collective_bytes_total")
        total = sum(c.value for c in comm._children.values()) \
            if comm is not None else 0
        print(f"  tensor parallel: tp={warm.tp}, per-device KV high-water "
              f"{rows[0]['kv_bytes_high_water']} B (1/{warm.tp} of "
              f"single-device), collective payload {int(total)} B "
              f"(all_reduce over 'tp')")
    del warm
    cb = ContinuousBatchingEngine(
        engine, prefix_cache=args.prefix_cache, monitor=monitor,
        shed_on_pressure=args.shed_on_pressure, **kw)
    print(f"engine up on {engine.device}: vocab {V}, {L} layers, "
          f"{args.num_blocks} KV blocks x {args.block_size}, max_batch "
          f"{args.max_batch}, tp {engine.tp}")
    return run_gateway(cb, host=args.host, port=args.port, monitor=monitor)


if __name__ == "__main__":
    # operator abort (Ctrl-C / sys.exit mid-serve) leaves evidence: an
    # operator_abort flight dump (span window + full metrics snapshot)
    # before exiting 130
    from paddle_tpu_torch.observability import tracing
    sys.exit(tracing.run_with_abort_evidence(main))
