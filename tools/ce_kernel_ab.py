#!/usr/bin/env python3
"""A/B timing of builds of the port's blockwise cross-entropy backward
kernels (dh and dw) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/ce_kernel_ab.py [--variant NAME=DIR]... [--gates]
                                  [--seed N] [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another ``blockwise_ce.cu`` with
the headers it includes: an older commit's ``csrc`` unpacked with ``git
archive``, or a copy edited for an experiment. Every variant is built with
``ops/_build.py``'s nvcc flags into a temporary directory and launched
through its C entry points ``blockwise_ce_dh_launch`` and
``blockwise_ce_dw_launch`` (one prototype for all builds). Each call gets
the f32 workspaces the workspace bodies need, allocated before timing; a
build that runs the cluster kernel does not read them.

For each case of ``chip_smoke.py``'s phase 9 (``--seed``: other random
inputs of the same shapes), dh and dw of every variant are timed with
``chip_smoke.time_ms`` in turns (A, B, ..., B, A; each variant's time is
the mean of its two turns), beside the unfused ``torch.matmul`` +
``cross_entropy`` forward and its dh and dw shares on the same tensors.
``--gates`` also holds each variant's dh and dw to phase 9's per-element
gate (``chip_smoke.bf16_agreement`` with ``CE_GRAD_ATOL``) and prints
the worst element over its allowance. Prints one line per case, then one
JSON object with every number, the compiler's register and spill counts
and the card's name and power limit (also written to ``--out``).
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(name, src_dir, tmp):
    """Compile ``src_dir``/blockwise_ce.cu; (library, ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"blockwise_ce-{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, "blockwise_ce.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    lib = ctypes.CDLL(out)
    lib.blockwise_ce_dh_launch.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.blockwise_ce_dw_launch.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.blockwise_ce_splits.argtypes = [ctypes.c_int] * 3
    for fn in (lib.blockwise_ce_dh_launch, lib.blockwise_ce_dw_launch,
               lib.blockwise_ce_splits):
        fn.restype = ctypes.c_int
    return lib, regs


def launcher(torch, lib, t, hid, vocab):
    """(dh, dw) calling ``lib``'s entry points as ``ops/blockwise_ce`` does
    for bf16 inputs of these sizes, with both workspaces allocated."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nsplit = lib.blockwise_ce_splits(t, vocab, sms)
    ws_dh = torch.empty((nsplit, t, hid), dtype=torch.float32, device="cuda")
    ws_dw = torch.empty((hid, vocab), dtype=torch.float32, device="cuda")

    def dh(h, w, lab, g, lse):
        out = torch.empty_like(h)
        rc = lib.blockwise_ce_dh_launch(
            1, h.data_ptr(), w.data_ptr(), lab.data_ptr(), g.data_ptr(),
            lse.data_ptr(), ws_dh.data_ptr(), out.data_ptr(), t, hid, vocab,
            nsplit, -100, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dh launch failed: CUDA error {rc}")
        return out

    def dw(h, w, lab, g, lse):
        out = torch.empty_like(w)
        rc = lib.blockwise_ce_dw_launch(
            1, h.data_ptr(), w.data_ptr(), lab.data_ptr(), g.data_ptr(),
            lse.data_ptr(), ws_dw.data_ptr(), out.data_ptr(), t, hid, vocab,
            -100, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dw launch failed: CUDA error {rc}")
        return out

    return dh, dw


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        print("ce_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from paddle_tpu_torch.ops import blockwise_ce as bc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="ce_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    libs, ptxas = {}, {}
    for name, src in specs:
        libs[name], ptxas[name] = build(name, src, tmp)
        for ln in ptxas[name]:
            print(f"  [{name}] {ln}", flush=True)

    order = list(libs) + list(libs)[::-1]
    time_ms = chip_smoke.time_ms
    results = []
    cases = chip_smoke.ce_cases(torch) if args.seed is None \
        else chip_smoke.ce_cases(torch, seed=args.seed)
    for name, h, w, lab, g in cases:
        t, hid = h.shape
        vocab = w.shape[1]
        _, lse = bc.ce_fwd_plain(h, w, lab, -100)
        runs = {n: launcher(torch, lib, t, hid, vocab)
                for n, lib in libs.items()}
        it = 5 if t >= 8192 else 10
        dh_t = {n: [] for n in runs}
        dw_t = {n: [] for n in runs}
        for n in order:
            dh, dw = runs[n]
            dh_t[n].append(time_ms(lambda: dh(h, w, lab, g, lse), iters=it,
                                   warmup=1))
            dw_t[n].append(time_ms(lambda: dw(h, w, lab, g, lse), iters=it,
                                   warmup=1))
        hl, wl = (x.detach().clone().requires_grad_(True) for x in (h, w))

        def lib_call(wrt=None):
            out = Fn.cross_entropy(torch.matmul(hl, wl), lab,
                                   reduction="none", ignore_index=-100)
            if wrt is not None:
                torch.autograd.grad(out, [wrt], g)

        with torch.no_grad():
            lib_f = time_ms(lib_call, iters=it, warmup=1)
        lib_dh = time_ms(lambda: lib_call(hl), iters=it, warmup=1) - lib_f
        lib_dw = time_ms(lambda: lib_call(wl), iters=it, warmup=1) - lib_f
        del hl, wl
        t_live = t - int((lab == -100).sum())
        bound_flops = 4 * t_live * hid * vocab
        exec_flops = 8 * t_live * hid * vocab
        row = {"case": name, "library_dh_share_ms": lib_dh,
               "library_dw_share_ms": lib_dw, "variants": {}}
        line = [f"{name}:"]
        for n in runs:
            a, b = sum(dh_t[n]) / 2, sum(dw_t[n]) / 2
            row["variants"][n] = {
                "dh_ms": a, "dw_ms": b, "dh_turns": dh_t[n],
                "dw_turns": dw_t[n],
                "dh_tflops_bound_work": bound_flops / a / 1e9,
                "dw_tflops_bound_work": bound_flops / b / 1e9,
                "dh_tflops_executed": exec_flops / a / 1e9,
                "dw_tflops_executed": exec_flops / b / 1e9,
                "dh_over_library": a / lib_dh, "dw_over_library": b / lib_dw}
            line.append(f"{n} dh {a:.4f} ms ({exec_flops / a / 1e9:.1f} "
                        f"TFLOP/s executed) dw {b:.4f} ms "
                        f"({exec_flops / b / 1e9:.1f});")
        line.append(f"matmul+cross_entropy dh share {lib_dh:.4f} dw share "
                    f"{lib_dw:.4f} ms")
        print(" ".join(line), flush=True)
        if args.gates:
            rdh = bc.ce_bwd_dh_plain(h, w, lab, g, lse, -100)
            rdw = bc.ce_bwd_dw_plain(h, w, lab, g, lse, -100)
            gates = {}
            for n, (dh, dw) in runs.items():
                o_dh, o_dw = dh(h, w, lab, g, lse), dw(h, w, lab, g, lse)
                torch.cuda.synchronize()
                gates[n] = [round(chip_smoke.bf16_agreement(
                    o, r, chip_smoke.CE_GRAD_ATOL)[1], 3)
                    for o, r in ((o_dh, rdh), (o_dw, rdw))]
                del o_dh, o_dw
            row["gates"] = gates
            print("  gates (worst element over its allowance, dh dw): "
                  + "; ".join(f"{n} {v}" for n, v in gates.items()),
                  flush=True)
            del rdh, rdw
        results.append(row)
        del h, w, lab, g, lse, runs
        torch.cuda.empty_cache()
    summary = {"card": card, "seed": args.seed, "ptxas": ptxas,
               "cases": results}
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
