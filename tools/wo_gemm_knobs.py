#!/usr/bin/env python3
"""Settings of the weight-only GEMM's two plan knobs, timed on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/wo_gemm_knobs.py [--set WAVES,BN]... [--iters N]
                                   [--out PATH]

``csrc/weight_only_matmul.cu`` chooses its plan from two knobs: the
column tile of the tensor-core body (``pick_bn``: 64, 128, or ``auto``,
the source's rule: 64 when 128-wide tiles leave SMs idle) and the number
of waves of the card's SMs a K split aims to cover (``TC_WAVES``; a grid
of a wave or more does not split). Each ``--set`` builds a copy of the
tree's source with those two lines rewritten (the tree's own build is
``tree``), all with ``ops/_build.py``'s nvcc flags, in parallel. For
each of the 12 serving shapes of ``chip_smoke.py`` (M = 8, 128, 512
against the four projections of the E=1024, F=2816 flagship), in int8
and int4 with bf16 activations, every build is timed in turns (A, B,
..., B, A; the mean of its two turns). A turn is
``chip_smoke.device_time_ms`` of ``--iters`` calls (device time only); a
call is what the wrapper launches (the counter memset where the plan
splits K, then the kernel). Each build's outputs are checked against the
plain version with ``chip_smoke.bf16_agreement``. Prints one line per
shape, then one JSON object with every number, each build's plans and
ptxas lines, and the card's name and power limit (also written to
``--out`` when given).
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
WAVES_LINE = re.compile(r"constexpr int TC_WAVES = \d+;")
BN_LINE = re.compile(
    r"  return cdiv\(M, bm\) \* \(N / 128\) < sms \? 64 : 128;")


def variant_source(waves, bn):
    """The tree's source with the two knob lines rewritten."""
    with open(os.path.join(SRC, "weight_only_matmul.cu")) as f:
        text = f.read()
    for pat in (WAVES_LINE, BN_LINE):
        if len(pat.findall(text)) != 1:
            raise RuntimeError(f"knob line {pat.pattern!r} not found once")
    text = WAVES_LINE.sub(f"constexpr int TC_WAVES = {int(waves)};", text)
    if bn != "auto":
        text = BN_LINE.sub(f"  return {int(bn)};", text)
    return text


def build(name, text, tmp):
    """Compile one source (headers from the tree); (library, ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    src = os.path.join(tmp, f"weight_only_matmul-{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    out = src[:-3] + ".so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", SRC,
                        "-o", out, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return out, regs


def bind(path):
    lib = ctypes.CDLL(path)
    for q in ("int4", "int8"):
        fn = getattr(lib, f"weight_only_{q}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.weight_only_plan.restype = ctypes.c_int
    lib.weight_only_plan.argtypes = [ctypes.c_int] * 5 \
        + [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def caller(torch, lib, quant, x, w, s, bn):
    """The wrapper's launch for these tensors through ``lib``; (call,
    plan)."""
    m, k = x.shape
    n = s.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (ctypes.c_longlong * 5)()
    lib.weight_only_plan(m, k, n, 1, sms, plan)
    plan = list(plan)
    ws = torch.empty(max(plan[4], 1), dtype=torch.uint8, device="cuda")
    out = torch.empty((m, n), dtype=x.dtype, device="cuda")
    fn = getattr(lib, f"weight_only_{quant}_launch")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(1, x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                m, k, n, bn, ws.data_ptr(), plan[4], sms, stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return call, plan


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[],
                    help="WAVES,BN with BN 64, 128 or auto")
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
    with open(os.path.join(SRC, "weight_only_matmul.cu")) as f:
        texts = {"tree": f.read()}
    for spec in args.set:
        waves, bn = spec.split(",")
        texts[f"w{waves}_bn{bn}"] = variant_source(waves, bn)
    tmp = tempfile.mkdtemp(prefix="wo_knobs_")
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
        futs = {n: ex.submit(build, n, t, tmp) for n, t in texts.items()}
        built = {n: f.result() for n, f in futs.items()}
    libs = {n: bind(p) for n, (p, _) in built.items()}
    names = list(libs)
    order = names + names[::-1]
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows = []
    for quant in ("int8", "int4"):
        for m in (8, 128, 512):
            for k, n in ((cs.E, (cs.H + 2 * cs.KVH) * cs.D),
                         (cs.H * cs.D, cs.E), (cs.E, 2 * cs.F), (cs.F, cs.E)):
                w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
                bn = qm.kernel_block_n(n) if quant == "int4" \
                    else qm.pick_block_n(n, "int8")
                if quant == "int4":
                    pk, sc = qm.pack_int4_blocked(w, bn)
                else:
                    sc = (np.abs(w).max(0) / 127.0).astype(np.float32)
                    pk = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
                wt = torch.as_tensor(pk).cuda()
                st = torch.as_tensor(sc).cuda()
                x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
                ref = qm.weight_only_matmul_plain(x, wt, st, quant, bn)
                calls, plans, gates = {}, {}, {}
                for nm in names:
                    calls[nm], plans[nm] = caller(torch, libs[nm], quant, x,
                                                  wt, st, bn)
                    out = calls[nm]().clone()
                    torch.cuda.synchronize()
                    gates[nm] = cs.bf16_agreement(out, ref, cs.INT8_ATOL)[1]
                    for _ in range(3):
                        calls[nm]()
                turns = {nm: [] for nm in names}
                for nm in order:
                    turns[nm].append(cs.device_time_ms(calls[nm], args.iters))
                ms = {nm: float(np.mean(v)) for nm, v in turns.items()}
                case = f"{quant}_M{m}_K{k}_N{n}"
                rows.append(dict(case=case, ms=ms, gate=gates,
                                 plan={nm: plans[nm][:4] for nm in names}))
                print(f"  {case}: " + "; ".join(
                    f"{nm} {ms[nm]:.4f} ms (BM,BN,S,blocks "
                    f"{tuple(plans[nm][:4])}, gate {gates[nm]:.3f})"
                    for nm in names), flush=True)
    for nm in names:
        bad = [r["case"] for r in rows if r["gate"][nm] > 1.0]
        if bad:
            print(f"  {nm}: gate failed at {bad}", flush=True)
    result = {"card": card, "iters": args.iters, "rows": rows,
              "ptxas": {nm: built[nm][1] for nm in names}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
