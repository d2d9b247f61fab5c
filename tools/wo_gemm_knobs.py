#!/usr/bin/env python3
"""Settings of the weight-only GEMM's two plan knobs, timed on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/wo_gemm_knobs.py [--set WAVES,BN]... [--variant NAME=DIR]...
                                   [--iters N] [--out PATH]

``csrc/weight_only_matmul.cu`` plans its tensor-core body from two knobs:
the column tile (``bn``: 64, 128, or ``auto``, the rule: 64 when
128-wide tiles leave SMs idle) and the number of waves of the card's SMs
a K split aims to cover (``waves``; ``auto`` is the rule's 2; a grid of
a wave or more does not split). Both are launch arguments (0: the rule),
so each ``--set`` is the tree's one build called with those knobs; the
tree's rule is ``tree``. A ``--variant NAME=DIR`` is another build of
the kernel (a directory holding a ``weight_only_matmul.cu`` and the
headers it includes, e.g. the parent commit's ``csrc`` unpacked under
``_archive/``), called with the rule; a source without
``weight_only_matmul_abi`` takes the argument list before the knobs.
Every build uses ``ops/_build.py``'s nvcc flags and compiles in parallel.

For each of the 12 serving shapes of ``chip_smoke.py`` (M = 8, 128, 512
against the four projections of the E=1024, F=2816 flagship), in int8
and int4 with bf16 activations, every setting is timed in turns (A, B,
..., B, A; the mean of its two turns). A turn is
``chip_smoke.device_time_ms`` of ``--iters`` calls (device time only); a
call is what the wrapper launches (the counter memset where the plan
splits K, then the kernel). Each output is checked against the plain
version with ``chip_smoke.bf16_agreement``, and each variant's output
against the tree's rule bit for bit (``bit_equal``). Prints one line per
shape, then one JSON object with every number, each setting's plan, each
build's ptxas lines, and the card's name and power limit (also written
to ``--out`` when given). Exits 1 when a gate fails.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")


def build(name, src_dir, tmp):
    """Compile ``src_dir``/weight_only_matmul.cu; (library, ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"weight_only_matmul-{name}.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", src_dir,
                        "-o", out, os.path.join(src_dir,
                                                "weight_only_matmul.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return out, regs


def bind(path):
    """(the library with its prototypes bound, its ABI: 2 takes knobs)."""
    lib = ctypes.CDLL(path)
    abi = lib.weight_only_matmul_abi() \
        if hasattr(lib, "weight_only_matmul_abi") else 1
    knobs = [ctypes.c_int] * 2 if abi >= 2 else []
    for q in ("int4", "int8"):
        fn = getattr(lib, f"weight_only_{q}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_int] + knobs + [ctypes.c_void_p]
    lib.weight_only_plan.restype = ctypes.c_int
    lib.weight_only_plan.argtypes = [ctypes.c_int] * 5 + knobs \
        + [ctypes.POINTER(ctypes.c_longlong)]
    return lib, abi


def caller(torch, lib, abi, quant, x, w, s, block_n, bn, waves):
    """The wrapper's launch for these tensors through ``lib`` with the
    knobs (0: the rule); (call, plan)."""
    m, k = x.shape
    n = s.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    knobs = (bn, waves) if abi >= 2 else ()
    plan = (ctypes.c_longlong * 5)()
    if lib.weight_only_plan(m, k, n, 1, sms, *knobs, plan) != 5:
        raise RuntimeError(f"no plan for M={m} K={k} N={n} knobs {knobs}")
    plan = list(plan)
    ws = torch.empty(max(plan[4], 1), dtype=torch.uint8, device="cuda")
    out = torch.empty((m, n), dtype=x.dtype, device="cuda")
    fn = getattr(lib, f"weight_only_{quant}_launch")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(1, x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                m, k, n, block_n, ws.data_ptr(), plan[4], sms, *knobs, stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return call, plan


def knob(v):
    return 0 if v == "auto" else int(v)


def settings_of(sets, variants):
    """{setting: (build, bn, waves)}: the tree at the rule, each ``--set
    WAVES,BN`` on the tree's build, each ``--variant`` build at the rule
    (knobs 0)."""
    out = {"tree": ("tree", 0, 0)}
    for spec in sets:
        waves, bn = spec.split(",")
        out[f"w{waves}_bn{bn}"] = ("tree", knob(bn), knob(waves))
    for name in variants:
        out[name] = (name, 0, 0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[],
                    help="WAVES,BN with WAVES an int or auto and BN 64, 128 "
                    "or auto: the tree's build with these knobs")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR: another build of the kernel, at the rule")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("wo_gemm_knobs: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import quant_matmul as qm
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dirs = {"tree": SRC}
    for spec in args.variant:
        name, d = spec.split("=", 1)
        dirs[name] = os.path.abspath(d)
    tmp = tempfile.mkdtemp(prefix="wo_knobs_")
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        futs = {n: ex.submit(build, n, d, tmp) for n, d in dirs.items()}
        built = {n: f.result() for n, f in futs.items()}
    libs = {n: bind(p) for n, (p, _) in built.items()}
    settings = settings_of(args.set, [n for n in dirs if n != "tree"])
    names = list(settings)
    order = names + names[::-1]
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows, failed = [], []
    for quant in ("int8", "int4"):
        for m in (8, 128, 512):
            for k, n in ((cs.E, (cs.H + 2 * cs.KVH) * cs.D),
                         (cs.H * cs.D, cs.E), (cs.E, 2 * cs.F), (cs.F, cs.E)):
                w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
                block_n = qm.kernel_block_n(n) if quant == "int4" \
                    else qm.pick_block_n(n, "int8")
                if quant == "int4":
                    pk, sc = qm.pack_int4_blocked(w, block_n)
                else:
                    sc = (np.abs(w).max(0) / 127.0).astype(np.float32)
                    pk = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
                wt = torch.as_tensor(pk).cuda()
                st = torch.as_tensor(sc).cuda()
                x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
                ref = qm.weight_only_matmul_plain(x, wt, st, quant, block_n)
                calls, plans, gates, outs = {}, {}, {}, {}
                for nm in names:
                    b, bn, waves = settings[nm]
                    lib, abi = libs[b]
                    calls[nm], plans[nm] = caller(torch, lib, abi, quant, x,
                                                  wt, st, block_n, bn, waves)
                    outs[nm] = calls[nm]().clone()
                    torch.cuda.synchronize()
                    gates[nm] = cs.bf16_agreement(outs[nm], ref,
                                                  cs.INT8_ATOL)[1]
                    for _ in range(3):
                        calls[nm]()
                bit_equal = {nm: bool(torch.equal(outs[nm], outs["tree"]))
                             for nm in names if settings[nm][0] != "tree"}
                turns = {nm: [] for nm in names}
                for nm in order:
                    turns[nm].append(cs.device_time_ms(calls[nm], args.iters))
                ms = {nm: float(np.mean(v)) for nm, v in turns.items()}
                case = f"{quant}_M{m}_K{k}_N{n}"
                rows.append(dict(case=case, ms=ms, gate=gates,
                                 bit_equal=bit_equal,
                                 plan={nm: plans[nm][:4] for nm in names}))
                failed += [f"{case}:{nm}" for nm in names if gates[nm] > 1.0]
                failed += [f"{case}:{nm} not bit-equal"
                           for nm, ok in bit_equal.items() if not ok]
                print(f"  {case}: " + "; ".join(
                    f"{nm} {ms[nm]:.4f} ms (BM,BN,S,blocks "
                    f"{tuple(plans[nm][:4])}, gate {gates[nm]:.3f}"
                    + (f", bit-equal {bit_equal[nm]}" if nm in bit_equal
                       else "") + ")" for nm in names), flush=True)
    if failed:
        print(f"  gates failed: {failed}", flush=True)
    result = {"card": card, "iters": args.iters, "settings": settings,
              "rows": rows, "ptxas": {nm: built[nm][1] for nm in built}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
