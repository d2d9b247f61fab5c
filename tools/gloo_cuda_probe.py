#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors as they are.

Run from the repository root on a machine with a CUDA card:

    python tools/gloo_cuda_probe.py

For each operation that ``paddle_tpu_torch.distributed.collective`` calls
on a group (allreduce, allgather, reduce_scatter, broadcast,
alltoall_base, alltoall, send / recv), two processes of this script
build a gloo group over a FileStore and call the group's own method on
CUDA tensors (bf16 and f32), with no staging. The collectives of a dtype
run in one pair of fresh processes, each op caught on its own;
send / recv, which may hand gloo's transport a device pointer, in a pair
of their own, so an operation that crashes its processes is reported,
not fatal. Prints one line a case and, last, a JSON object
{"op/dtype": "ok" | "wrong values" | "error: ..." | "crashed rc"}. An
operation that is not "ok" belongs in ``collective.GLOO_STAGED``.
"""
import json
import os
import subprocess
import sys
import tempfile

OPS = ("allreduce", "allgather", "reduce_scatter", "broadcast",
       "alltoall_base", "alltoall", "send_recv")
DTYPES = ("float32", "bfloat16")


def rank_main(ops, dtype, rank, store_path, out_path):
    import datetime
    import torch
    import torch.distributed as dist
    dt = getattr(torch, dtype)
    store = dist.FileStore(store_path, 2)
    g = dist.ProcessGroupGloo(store, rank, 2, datetime.timedelta(seconds=30))
    result = {}
    for op in ops.split(","):
        try:
            ok = run_op(torch, dist, g, op, dt, rank)
            result[op] = "ok" if ok else "wrong values"
        except Exception as e:
            result[op] = f"error: {type(e).__name__}: {e}"[:200] \
                .replace("\n", " ")
        with open(out_path, "w") as f:
            json.dump(result, f)
    return 0


def run_op(torch, dist, g, op, dt, rank):
    dev = "cuda"
    n = 6

    def full(v):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    if op == "allreduce":
        t = full(rank + 1)
        g.allreduce([t]).wait()
        ok = bool((t == 3).all())
    elif op == "allgather":
        outs = [torch.empty(n, dtype=dt, device=dev) for _ in range(2)]
        g.allgather([outs], [full(rank)]).wait()
        ok = all(bool((o == i).all()) for i, o in enumerate(outs))
    elif op == "reduce_scatter":
        out = torch.empty(n, dtype=dt, device=dev)
        g.reduce_scatter([out], [[full(rank + j) for j in range(2)]],
                         dist.ReduceScatterOptions()).wait()
        ok = bool((out == 1 + 2 * rank).all())
    elif op == "broadcast":
        t = full(7 if rank == 0 else 0)
        g.broadcast([t], dist.BroadcastOptions()).wait()
        ok = bool((t == 7).all())
    elif op == "alltoall_base":
        x = torch.arange(2 * n, device=dev).to(dt) + 100 * rank
        y = torch.empty_like(x)
        g.alltoall_base(y, x, [], [], dist.AllToAllOptions()).wait()
        want = torch.cat([torch.arange(rank * n, rank * n + n, device=dev)
                          .to(dt) + 100 * s for s in range(2)])
        ok = bool((y == want).all())
    elif op == "alltoall":
        xs = [full(10 * rank + j) for j in range(2)]
        ys = [torch.empty(n, dtype=dt, device=dev) for _ in range(2)]
        g.alltoall(ys, xs, dist.AllToAllOptions()).wait()
        ok = all(bool((y == 10 * s + rank).all()) for s, y in enumerate(ys))
    else:
        t = full(5)
        got = torch.zeros(n, dtype=dt, device=dev)
        if rank == 0:
            g.send([t], 1, 0).wait()
            ok = True
        else:
            g.recv([got], 0, 0).wait()
            ok = bool((got == 5).all())
    torch.cuda.synchronize()
    return ok


def run_pair(ops, dtype, tmp):
    """{op: result} of ``ops`` run in turn by a fresh pair of processes;
    an op that neither rank reported is "crashed" with their codes."""
    tag = f"{ops.replace(',', '_')}_{dtype}"
    store = os.path.join(tmp, f"store_{tag}")
    outs = [os.path.join(tmp, f"{tag}_{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", ops, dtype,
         str(r), store, outs[r]], stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for r in range(2)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=300))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append("timeout")
    got = []
    for path in outs:
        try:
            with open(path) as f:
                got.append(json.load(f))
        except (OSError, ValueError):
            got.append({})
    result = {}
    for op in ops.split(","):
        seen = [g[op] for g in got if op in g]
        if len(seen) < 2:
            result[op] = f"crashed rc {rcs}"
        else:
            bad = [x for x in seen if x != "ok"]
            result[op] = bad[0] if bad else "ok"
    return result


def main():
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    result = {}
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        for dtype in DTYPES:
            for ops in (",".join(OPS[:-1]), OPS[-1]):
                for op, r in run_pair(ops, dtype, tmp).items():
                    result[f"{op}/{dtype}"] = r
                    print(f"  {op} {dtype}: {r}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        ops, dtype, rank, store, out = sys.argv[2:7]
        sys.exit(rank_main(ops, dtype, int(rank), store, out))
    sys.exit(main())
