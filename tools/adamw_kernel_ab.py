#!/usr/bin/env python3
"""A/B of builds of kernel D (``paddle_tpu_torch/csrc/adamw.cu``, AdamW
with the global-norm clip, its pretrain and eager forms) on one card: the
outputs bit for bit, then device time at the flagship's size.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/adamw_kernel_ab.py --variant DIR [--out PATH]

``DIR`` holds another ``adamw.cu`` with the same C entry points and
argument lists (an older commit's ``csrc`` unpacked with ``git archive``,
or a copy edited for an experiment). It is built with ``ops/_build.py``'s
nvcc flags into a temporary directory, and the wrappers
(``ops.adamw.adamw_step``, ``ops.adamw.adamw_eager``) are run once through
each build on the same inputs: ``ops._launch.entry`` is pointed at the
variant's library for its calls.

Equality cases: tensor lists of edge sizes (0, 1, 3, 5, 4 and 7 elements,
one chunk, one chunk and one, 200001, 131079) and of 300 tensors (two
launches of each kind); f32 grads or f32 / bf16 / f16 by turns; aligned,
or every third tensor one element off its 16-byte boundary. The pretrain
form with the clip off, active and saturated, with and without the
telemetry, one device and the mesh form (every fourth tensor not owned,
the sum all_reduced by an identity); the eager form with f32, or f32 /
bf16 / f16 parameters, no clip / active / saturated, AdamW and Adam, one
device and the mesh form, with and without bf16 copies written. Every
output (gnorm, the scale's effect on p, m, v, the copies, the telemetry
vector or its raw sums) must be equal bit for bit.

Timing: both forms at the flagship's 147 tensors (``pretrain
.flagship_config()``, 373.9M parameters; the pretrain form with f32 grads,
the eager form as the O2 step holds them: bf16 matrices with f32 masters,
the clip active), device time (``chip_smoke.device_time_ms``) in turns
variant, tree, tree, variant. Prints the card's name and power limit, the
counts and times, then one JSON object (also written to ``--out``).
Exits 1 if any case differs.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops import _build, _launch as L  # noqa: E402
from paddle_tpu_torch.ops import adamw as A  # noqa: E402

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
TREE_ENTRY = L.entry


def build(directory, tmp):
    """The variant's library: its C entry points with their prototypes."""
    out = os.path.join(tmp, "adamw_variant.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(directory, "adamw.cu")], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    lib = ctypes.CDLL(out)
    fns = {}
    for name, types in L.PROTOTYPES["adamw"].items():
        f = getattr(lib, name)
        f.argtypes = types
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def use(fns):
    """Route the wrappers' kernel D calls to ``fns`` (None: the tree's)."""
    if fns is None:
        L.entry = TREE_ENTRY
    else:
        L.entry = lambda src, name: (fns[name] if src == "adamw"
                                     else TREE_ENTRY(src, name))


def tensors(seed, sizes, gdts, misalign):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        off = 1 if misalign and i % 3 == 1 else 0

        def make(dt, scale):
            buf = torch.randn(n + off, generator=gen, device="cuda") * scale
            return buf.to(dt)[off:]
        out.append((make(F32, 1.0), make(gdts[i % len(gdts)], 0.01),
                    make(F32, 1e-3), make(F32, 1e-6).abs()))
    return out


def mesh_kw(n):
    return {"owned": [i % 4 != 3 for i in range(n)],
            "reduce": lambda t: t}


def pretrain_case(fns, sizes, gdts, misalign, clip, tel, mesh):
    ps, gs, ms, vs = (list(c) for c in zip(*tensors(7, sizes, gdts,
                                                    misalign)))
    kw = mesh_kw(len(ps)) if mesh else {}
    if tel:
        kw.update(groups=[i % 3 for i in range(len(ps))],
                  loss=torch.tensor(2.5, device="cuda"))
    use(fns)
    try:
        r = A.adamw_step(ps, gs, ms, vs, [i % 2 == 0 for i in range(len(ps))],
                         3e-4, 0.9, 0.95, 1e-8, 0.1, clip, 3, **kw)
        torch.cuda.synchronize()
    finally:
        use(None)
    return list(r if isinstance(r, tuple) else (r,)) + ps + ms + vs


def eager_case(fns, sizes, pdts, gdts, misalign, clip, mode, mesh, copies):
    ts = tensors(9, sizes, gdts, misalign)
    ps = [t[0].to(pdts[i % len(pdts)]) for i, t in enumerate(ts)]
    gs, ms, vs = ([t[k] for t in ts] for k in (1, 2, 3))
    outs = [p.to(BF16) if copies and p.dtype == F32 else None for p in ps]
    n = len(ps)
    use(fns)
    try:
        r = A.adamw_eager(ps, gs, ms, vs,
                          [3e-4 * (1 + i % 2) for i in range(n)],
                          [i % 2 == 0 for i in range(n)], 0.9, 0.95, 1e-8,
                          0.1, 3, mode=mode, clip=clip,
                          clip_flags=[i % 5 != 4 for i in range(n)],
                          outs=outs if copies else None,
                          **(mesh_kw(n) if mesh else {}))
        torch.cuda.synchronize()
    finally:
        use(None)
    return [r] + ps + ms + vs + [o for o in outs if o is not None]


def bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def equality(fns):
    edges = [0, 1, 3, 5, 65536, 65537, 200001, 131079, 4, 7]
    many = [int(x) for x in torch.randint(
        1, 3000, (300,), generator=torch.Generator().manual_seed(1))]
    cases, differ = 0, []
    for label, sizes in (("edges", edges), ("300 tensors", many)):
        for gdts in ([F32], [BF16, F16, F32]):
            for mis in (False, True):
                for clip in (0.0, 1.0, 1e-4):
                    for tel in (False, True):
                        for mesh in (False, True):
                            key = ("pretrain", label, str(gdts), mis, clip,
                                   tel, mesh)
                            cases += 1
                            if not same(
                                    pretrain_case(fns, sizes, gdts, mis,
                                                  clip, tel, mesh),
                                    pretrain_case(None, sizes, gdts, mis,
                                                  clip, tel, mesh)):
                                differ.append(key)
                for pdts in ([F32], [F32, BF16, F16]):
                    for clip in (None, 1.0, 1e-4):
                        for mode in ("adamw", "adam"):
                            for mesh in (False, True):
                                for copies in (False, True):
                                    key = ("eager", label, str(gdts),
                                           str(pdts), mis, clip, mode, mesh,
                                           copies)
                                    cases += 1
                                    args = (sizes, pdts, gdts, mis, clip,
                                            mode, mesh, copies)
                                    if not same(eager_case(fns, *args),
                                                eager_case(None, *args)):
                                        differ.append(key)
    return cases, differ


def flagship_lists():
    from paddle_tpu_torch.models import pretrain
    cfg, _, _ = pretrain.flagship_config()
    shapes = list(chip_smoke.llama_shapes(cfg).values())
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(shape, dt, scale):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    pre = [(rnd(s, F32, 0.02), rnd(s, F32, 1e-4), rnd(s, F32, 1e-5),
            rnd(s, F32, 1e-9).abs()) for s in shapes]
    eager = [(rnd(s, F32, 0.02), rnd(s, BF16 if len(s) >= 2 else F32, 1e-4),
              rnd(s, F32, 1e-5), rnd(s, F32, 1e-9).abs(),
              torch.empty(s, dtype=BF16, device="cuda") if len(s) >= 2
              else None) for s in shapes]
    return pre, eager


def timing(fns):
    pre, eager = flagship_lists()
    ps, gs, ms, vs = (list(c) for c in zip(*pre))
    decay = [p.dim() >= 2 for p in ps]
    eps_, egs, ems, evs, eouts = (list(c) for c in zip(*eager))
    n = len(eps_)

    def run_pre():
        A.adamw_step(ps, gs, ms, vs, decay, 3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0,
                     3)

    def run_eager():
        A.adamw_eager(eps_, egs, ems, evs, [3e-4] * n,
                      [p.dim() >= 2 for p in eps_], 0.9, 0.95, 1e-8, 0.1, 3,
                      clip=1.0, outs=eouts)
    times = {"variant": {"pretrain": [], "eager": []},
             "tree": {"pretrain": [], "eager": []}}
    for turn in ("variant", "tree", "tree", "variant"):
        use(fns if turn == "variant" else None)
        try:
            times[turn]["pretrain"].append(
                chip_smoke.device_time_ms(run_pre, iters=20))
            times[turn]["eager"].append(
                chip_smoke.device_time_ms(run_eager, iters=20))
        finally:
            use(None)
    params = sum(p.numel() for p in ps)
    return params, n, {k: {f: sum(v) / len(v) for f, v in d.items()}
                       for k, d in times.items()}, times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", required=True,
                    help="a directory holding another adamw.cu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="adamw_ab_") as tmp:
        t0 = time.perf_counter()
        fns = build(args.variant, tmp)
        TREE_ENTRY("adamw", "adamw_max_tensors")()
        print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
        cases, differ = equality(fns)
        print(f"equality: {cases} cases, {len(differ)} differ", flush=True)
        for key in differ:
            print(f"  differs: {key}", flush=True)
        params, n, mean, turns = timing(fns)
    for form in ("pretrain", "eager"):
        print(f"{form} form, {n} tensors, {params} parameters: device ms "
              f"variant {mean['variant'][form]:.4f} tree "
              f"{mean['tree'][form]:.4f}", flush=True)
    res = {"card": card, "cases": cases, "differ": [list(map(str, k))
                                                   for k in differ],
           "tensors": n, "params": params, "device_ms": mean,
           "turns": turns}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
