#!/usr/bin/env python3
"""A/B timing of builds of the port's blockwise cross-entropy kernels (the
forward, dh and dw) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/ce_kernel_ab.py [--variant NAME=DIR]... [--gates]
                                  [--only fwd|bwd] [--seed N] [--out PATH]

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
the worst element over its allowance.

The forward (``blockwise_ce_fwd_launch``; ``--only fwd`` alone) is held
to phase 9's gate (loss and lse within ``CE_LOSS_ATOL`` of the plain
version) before it is timed, by device time
(``chip_smoke.device_time_ms``) in the same turns, beside the unfused
``torch.matmul`` + ``cross_entropy`` forward's device time and, where
H or V is not a multiple of 8, the device time of the row-padding copies
the ``wgmma-pitched`` route makes (its ``cudaMemcpy2DAsync`` calls alone). Each build
sizes its split count and scratch by its own exported rule:
``blockwise_ce_fwd_plan`` where the source has it (and its route),
else ``blockwise_ce_splits`` with [3, splits, T] of scratch. Prints one line per case, then one
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
    lib.blockwise_ce_fwd_launch.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    lib.blockwise_ce_splits.argtypes = [ctypes.c_int] * 3
    for fn in (lib.blockwise_ce_dh_launch, lib.blockwise_ce_dw_launch,
               lib.blockwise_ce_fwd_launch, lib.blockwise_ce_splits):
        fn.restype = ctypes.c_int
    if hasattr(lib, "blockwise_ce_fwd_plan"):
        lib.blockwise_ce_fwd_plan.argtypes = [ctypes.c_int] * 5 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        lib.blockwise_ce_fwd_plan.restype = ctypes.c_int
    return lib, regs


def fwd_launcher(torch, lib, t, hid, vocab):
    """(route, splits, forward) calling ``lib``'s forward entry point for
    bf16 inputs of these sizes, the splits and scratch sized by the
    build's own rule."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(lib, "blockwise_ce_fwd_plan"):
        out = (ctypes.c_longlong * 10)()
        if lib.blockwise_ce_fwd_plan(1, t, hid, vocab, sms, out) != 10:
            raise RuntimeError("no forward plan")
        route, nsplit, floats = bc.FWD_ROUTES[out[0]], out[1], out[7]
    else:
        nsplit = lib.blockwise_ce_splits(t, vocab, sms)
        route, floats = "mma.sync (no plan)", 3 * nsplit * t
    part = torch.empty(floats, dtype=torch.float32, device="cuda")
    loss = torch.empty(t, dtype=torch.float32, device="cuda")
    lse = torch.empty(t, dtype=torch.float32, device="cuda")

    def fwd(h, w, lab):
        rc = lib.blockwise_ce_fwd_launch(
            1, h.data_ptr(), w.data_ptr(), lab.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), part.data_ptr(), t, hid, vocab, nsplit, -100,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fwd launch failed: CUDA error {rc}")
        return loss, lse

    return route, nsplit, fwd


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


def cudart():
    """The CUDA runtime library, as ctypes sees it: the one the process
    has loaded, else the toolkit's."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for name in ("libcudart.so.12", "libcudart.so",
                 os.path.join(home, "lib64", "libcudart.so")):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("no CUDA runtime library to time the copies with")


def pitched_copy_ms(torch, cs, h, w, iters):
    """Device ms of the copies the ``wgmma-pitched`` route makes before its
    kernel (h where H % 8 != 0, w where V % 8 != 0): the same
    ``cudaMemcpy2DAsync`` calls into rows padded to 8 elements; None where
    the shapes need none."""
    t, hid = h.shape
    vocab = w.shape[1]
    copies = [(x, rows, cols) for x, rows, cols in ((h, t, hid),
                                                    (w, hid, vocab))
              if cols % 8]
    if not copies:
        return None
    rt = cudart()
    fn = rt.cudaMemcpy2DAsync
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pitch = [-(-cols // 8) * 8 for _, _, cols in copies]
    bufs = [torch.empty(rows * p, dtype=x.dtype, device="cuda")
            for (x, rows, _), p in zip(copies, pitch)]

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for (x, rows, cols), p, dst in zip(copies, pitch, bufs):
            rc = fn(dst.data_ptr(), 2 * p, x.data_ptr(), 2 * cols, 2 * cols,
                    rows, 3, stream)            # 3: device to device
            if rc:
                raise RuntimeError(f"cudaMemcpy2DAsync: CUDA error {rc}")

    return cs.device_time_ms(run, iters=iters)


def fwd_case(torch, Fn, cs, libs, order, h, w, lab, rloss, rlse, name):
    """The forward of every build at one case: held to phase 9's gate,
    then timed by device time in turns beside matmul + cross_entropy's
    forward. Returns the case's record and prints a line."""
    t, hid = h.shape
    vocab = w.shape[1]
    fwds, rec = {}, {"variants": {}}
    for n, lib in libs.items():
        route, nsplit, fwd = fwd_launcher(torch, lib, t, hid, vocab)
        loss, lse = fwd(h, w, lab)
        torch.cuda.synchronize()
        err = max(float((loss - rloss).abs().max()),
                  float((lse - rlse).abs().max()))
        cs.check(err <= cs.CE_LOSS_ATOL, f"{n} {name} fwd: loss / lse err "
                 f"{err} over {cs.CE_LOSS_ATOL}")
        fwds[n] = fwd
        rec["variants"][n] = {"route": route, "splits": nsplit,
                              "max_abs_err": err, "fwd_turns": []}
    for n in order:
        rec["variants"][n]["fwd_turns"].append(cs.device_time_ms(
            lambda: fwds[n](h, w, lab), iters=10 if t >= 8192 else 30))
    with torch.no_grad():
        rec["library_fwd_device_ms"] = cs.device_time_ms(
            lambda: Fn.cross_entropy(torch.matmul(h, w), lab,
                                     reduction="none", ignore_index=-100),
            iters=10 if t >= 8192 else 30)
    rec["pitched_copy_device_ms"] = pitched_copy_ms(
        torch, cs, h, w, iters=10 if t >= 8192 else 30)
    flops = 2 * t * hid * vocab
    line = [f"{name} fwd:"]
    for n, rv in rec["variants"].items():
        rv["fwd_ms"] = sum(rv["fwd_turns"]) / 2
        rv["fwd_tflops"] = flops / rv["fwd_ms"] / 1e9
        line.append(f"{n} [{rv['route']}, {rv['splits']} splits] "
                    f"{rv['fwd_ms']:.4f} ms ({rv['fwd_tflops']:.1f} TFLOP/s; "
                    f"err {rv['max_abs_err']:.2e});")
    line.append(f"matmul+cross_entropy fwd {rec['library_fwd_device_ms']:.4f}"
                " ms")
    if rec["pitched_copy_device_ms"] is not None:
        line.append(f"(the pitched route's copies alone "
                    f"{rec['pitched_copy_device_ms']:.4f} ms)")
    print(" ".join(line), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None)
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
        rloss, lse = bc.ce_fwd_plain(h, w, lab, -100)
        it = 5 if t >= 8192 else 10
        row = {"case": name, "variants": {}}
        if args.only != "bwd":
            row["fwd"] = fwd_case(torch, Fn, chip_smoke, libs, order, h, w,
                                  lab, rloss, lse, name)
        if args.only == "fwd":
            results.append(row)
            del h, w, lab, g, lse, rloss
            torch.cuda.empty_cache()
            continue
        del rloss
        runs = {n: launcher(torch, lib, t, hid, vocab)
                for n, lib in libs.items()}
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
        row.update({"library_dh_share_ms": lib_dh,
                    "library_dw_share_ms": lib_dw})
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
