#!/usr/bin/env python3
"""A/B timing of builds of the port's flash-attention kernels on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/flash_kernel_ab.py [--variant NAME=DIR]... [--gates]
                                     [--seed N] [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another ``flash_attention.cu``
with the headers it includes: an older commit's ``csrc`` unpacked with
``git archive``, or a copy edited for an experiment (a design change, or a
planted fault that the gates must catch). Every variant is built with
``ops/_build.py``'s nvcc flags into a temporary directory and launched
through its C entry points, ``flash_attention_fwd_launch`` and
``flash_attention_bwd_launch``, in this process.

For each case of ``chip_smoke.py``'s phases 5 and 10 (``--seed``: other
random inputs of the same shapes), the forward and the backward of every
variant are timed with ``chip_smoke.time_ms`` in turns (A, B, ..., B, A;
each variant's time is the mean of its two turns), beside SDPA's forward
and forward + backward on the same tensors. ``--gates`` also holds each
variant's gradients (given the plain version's o and lse) to
``chip_smoke.py``'s per-element gate, without and with its term for the
rounding of p and ds (``chip_smoke.flash_grad_rounding``), and prints
the worst element over its allowance for each. Prints one line per case,
then one JSON object with every number and the card's name and power
limit (also written to ``--out``).
"""
import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(name, src_dir, tmp):
    """Compile ``src_dir``/flash_attention.cu; (library, ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"flash_attention-{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, "flash_attention.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    lib = ctypes.CDLL(out)
    lib.flash_attention_fwd_launch.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd_launch.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib, regs


def launcher(torch, lib):
    """(fwd, bwd) calling ``lib``'s entry points as ``ops/flash_attention``
    does, on inputs its wrappers accept."""
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

    def ptr(t):
        return None if t is None else t.data_ptr()

    def fwd(q, k, v, scale, causal, cos=None, sin=None):
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        rc = lib.flash_attention_fwd_launch(
            code[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), ptr(cos), ptr(sin), bh, sq,
            k.shape[1], d, float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"forward launch failed: CUDA error {rc}")
        return o, lse

    def bwd(q, k, v, o, lse, do, scale, causal, cos=None, sin=None):
        bh, sq, d = q.shape
        dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        rc = lib.flash_attention_bwd_launch(
            code[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), ptr(cos),
            ptr(sin), bh, sq, k.shape[1], d, float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"backward launch failed: CUDA error {rc}")
        return dq.to(q.dtype), dk, dv

    return fwd, bwd


def gate_ratios(torch, cs, fa, runs, q, k, v, o, lse, do, scale, causal,
                cos, sin):
    """{variant: {"without": [dq, dk, dv], "with": [...]}}: each variant's
    worst gradient element over chip_smoke's allowance."""
    refs = fa.flash_bwd_plain(q, k, v, o, lse, do, scale, causal, cos, sin)
    extras = cs.flash_grad_rounding(torch, fa, q, k, v, o, lse, do, scale,
                                    causal, cos, sin)
    out = {}
    for n, (_, bwd) in runs.items():
        grads = bwd(q, k, v, o, lse, do, scale, causal, cos, sin)
        torch.cuda.synchronize()
        out[n] = {key: [round(cs.bf16_agreement(
            g, r, cs.FLASH_GRAD_ATOL, x if key == "with" else None)[1], 3)
            for g, r, x in zip(grads, refs, extras)]
            for key in ("without", "with")}
        del grads
    return out


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
        print("flash_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="flash_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    runs, ptxas = {}, {}
    for name, src in specs:
        lib, ptxas[name] = build(name, src, tmp)
        runs[name] = launcher(torch, lib)
        for ln in ptxas[name]:
            print(f"  [{name}] {ln}", flush=True)

    seeds = {} if args.seed is None else {"seed": args.seed}
    cases = [c + (None, None) for c in chip_smoke.flash_cases(torch, **seeds)]
    cases += list(chip_smoke.rope_flash_cases(torch, **seeds))
    order = list(runs) + list(runs)[::-1]
    time_ms = chip_smoke.time_ms
    results = []
    for name, q, k, v, do, causal, cos, sin in cases:
        bh, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_plain(q, k, v, scale, causal, cos, sin)
        it = 10 if bh * s >= 65536 else 25
        fwd_t = {n: [] for n in runs}
        bwd_t = {n: [] for n in runs}
        for n in order:
            fwd, bwd = runs[n]
            fwd_t[n].append(time_ms(
                lambda: fwd(q, k, v, scale, causal, cos, sin), iters=it))
            bwd_t[n].append(time_ms(
                lambda: bwd(q, k, v, o, lse, do, scale, causal, cos, sin),
                iters=it))
        q4, k4, v4, do4 = (x[:, None] for x in (q, k, v, do))
        sdpa_f = time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters=it)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4)]

        def sdpa_fb():
            out = Fn.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                  scale=scale)
            torch.autograd.grad(out, leaves, do4)

        sdpa_fb_ms = time_ms(sdpa_fb, iters=it)
        _, ff, _, bf = chip_smoke.flash_work(bh, s, s, d, causal)
        row = {"case": name, "sdpa_fwd_ms": sdpa_f,
               "sdpa_bwd_share_ms": sdpa_fb_ms - sdpa_f, "variants": {}}
        line = [f"{name}:"]
        for n in runs:
            f_ms, b_ms = sum(fwd_t[n]) / 2, sum(bwd_t[n]) / 2
            row["variants"][n] = {
                "fwd_ms": f_ms, "bwd_ms": b_ms, "fwd_turns": fwd_t[n],
                "bwd_turns": bwd_t[n], "fwd_tflops": ff / f_ms / 1e9,
                "bwd_tflops": bf / b_ms / 1e9,
                "fwd_over_sdpa": f_ms / sdpa_f,
                "bwd_over_sdpa": b_ms / (sdpa_fb_ms - sdpa_f)}
            line.append(f"{n} fwd {f_ms:.4f} ms ({ff / f_ms / 1e9:.1f} "
                        f"TFLOP/s) bwd {b_ms:.4f} ms ({bf / b_ms / 1e9:.1f} "
                        "TFLOP/s);")
        line.append(f"sdpa fwd {sdpa_f:.4f} bwd share "
                    f"{sdpa_fb_ms - sdpa_f:.4f} ms")
        print(" ".join(line), flush=True)
        if args.gates:
            row["gates"] = gate_ratios(torch, chip_smoke, fa, runs, q, k, v,
                                       o, lse, do, scale, causal, cos, sin)
            print("  gates (worst element over its allowance, dq dk dv; "
                  "without / with the rounding term): " + "; ".join(
                      f"{n} {g['without']} / {g['with']}"
                      for n, g in row["gates"].items()), flush=True)
        results.append(row)
        del q, k, v, do, o, lse, leaves
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
