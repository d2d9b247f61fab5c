#!/usr/bin/env python3
"""A/B timing of builds of the port's FlashMask kernels (the forward, dq
and dk / dv of ``csrc/flashmask.cu``) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/flashmask_kernel_ab.py [--variant NAME=DIR]...
                                         [--only fwd|bwd] [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another ``flashmask.cu`` with the
headers it includes: an older commit's ``csrc`` unpacked with ``git
archive``, or a copy edited for an experiment. Every variant is built
with ``ops/_build.py``'s nvcc flags into a temporary directory (all
builds at once) and launched through its C entry points in this process
(``flashmask_fwd_launch``, ``flashmask_bwd_prep_launch``,
``flashmask_bwd_dq_launch``, ``flashmask_bwd_dkv_launch``, whose argument
lists every variant shares). A source that exports
``flashmask_fwd_parts`` / ``flashmask_bwd_parts`` reports its route; one
without it ran the CUDA-core body.

The forward (``--only fwd`` alone): at phase 13's seven cases each
variant's o and lse are held to the plain version with the smoke's gates
(``FM_O_ATOL`` plus two bf16 ulps of |ref| per element, lse within
``LSE_ATOL``, rows that see nothing exactly 0 and -1e30), then timed by
device time in turns A, B, ..., B, A beside masked SDPA's forward (device
time). Its TFLOP/s count the products each build runs on the visible
pairs: q k^T and one product of p v per part of p.

Cases: ``chip_smoke.py``'s phase 13 (the seven FlashMask masks, bf16,
D=64, inputs from the same seeds) and phase 15's two-pass backward (B=8,
S=2048, H=16, D=64, causal). Each variant's dq / dk / dv is held to the
plain version with the smoke's gate (``FLASH_GRAD_ATOL`` plus two bf16
ulps of |ref| per element; the two-pass case also allows the one-ulp
flips of rounded p and ds, ``chip_smoke.flash_grad_rounding``, as phase
15 does, and prints its reading without them), then dq (with its
pre-pass) and dk / dv are
timed by device time (``chip_smoke.device_time_ms``) in turns A, B, ...,
B, A (each variant's time is the mean of its two turns), beside the
backward share of SDPA with the same mask (fwd + bwd less fwd, device
time) and, at phase 15's shape, the fused backward (K2). TFLOP/s count
the products each build runs on the visible pairs (q k^T, do v^T and one
product of ds k, p^T do, ds^T q per part). Prints one line per case, the
``ptxas`` registers and spills of each build, then one JSON object with
every number and the card's name and power limit (also written to
``--out``).
"""
import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def start_build(name, src_dir, tmp):
    """Start nvcc on ``src_dir``/flashmask.cu; (process, library path)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"flashmask-{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, "flashmask.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def ptxas_summary(log):
    """{kernel<dtype,D,flags>: "N registers, S/L bytes spill stores/loads"}
    of the backward kernels in an ``-Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '_Z\w*?(flashmask_(?:bwd|fwd)_\w*?"
                      r"kernel(?:_f32)?)I(\w+?)EEv", ln)
        if m:
            args = re.sub(r"^(13__nv_bfloat16|6__half|f)", lambda t: {
                "13__nv_bfloat16": "bf16", "6__half": "fp16",
                "f": "f32"}[t.group(1)], m.group(2))
            args = re.sub(r"L[ib](\d+)E?", r",\1", args).rstrip("E") \
                .lstrip(",")
            name = f"{m.group(1)}<{args}>"
            out[name] = ""
        elif name and "spill" in ln:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            out[name] = f"spill {s.group(1)}/{s.group(2)} bytes"
        elif name and "registers" in ln:
            r = re.search(r"Used (\d+) registers", ln)
            out[name] = f"{r.group(1)} registers, {out[name]}"
            name = None
    return out


def finish_build(name, proc, out):
    """(library, route function, ptxas summary) of a started build."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    regs = ptxas_summary(log)
    lib = ctypes.CDLL(out)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i] * 6 + [f, i, ptr]
    for fn, args in (("flashmask_bwd_prep_launch",
                      [i] + [ptr] * 6 + [i] * 6 + [ptr]),
                     ("flashmask_bwd_dq_launch", [i, i] + [ptr] * 10 + shape),
                     ("flashmask_bwd_dkv_launch",
                      [i, i] + [ptr] * 11 + shape)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.flashmask_fwd_launch.argtypes = [i] + [ptr] * 8 + shape
    lib.flashmask_fwd_launch.restype = ctypes.c_int
    lib.flashmask_block_k.restype = ctypes.c_int
    if hasattr(lib, "flashmask_fwd_parts"):
        lib.flashmask_fwd_parts.argtypes = [i]
        lib.flashmask_fwd_parts.restype = ctypes.c_int
    if hasattr(lib, "flashmask_bwd_parts"):
        lib.flashmask_bwd_parts.argtypes = [i, i]
        lib.flashmask_bwd_parts.restype = ctypes.c_int

        def parts(mode, code):
            return lib.flashmask_bwd_parts(mode, code)
    else:
        def parts(mode, code):
            return 0

    def fwd_parts(code):
        if hasattr(lib, "flashmask_fwd_parts"):
            return lib.flashmask_fwd_parts(code)
        return 0

    parts.fwd = fwd_parts
    return lib, parts, regs


class Runner:
    """The pre-pass, dq and dk / dv launches of one build, on the tensors
    the wrapper would pass (``ops.flashmask._bwd_prep`` / ``_bwd_launch``
    with another library)."""

    def __init__(self, torch, lib):
        self.torch, self.lib = torch, lib

    def prep(self, mode, q, k, o, do, sr, er):
        torch = self.torch
        from paddle_tpu_torch.ops import flashmask as fm
        bh, sq, d = q.shape
        if mode == fm.MODE_FLASHMASK:
            h, mh = fm._check_mask("ab", q, k, sr, er)
            nk = -(-k.shape[1] // self.lib.flashmask_block_k())
            ext = torch.empty(sr.shape[0] * sr.shape[1] * nk * 2,
                              dtype=torch.int32, device=q.device)
        else:
            h, mh, ext = 1, 1, None
        delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        rc = self.lib.flashmask_bwd_prep_launch(
            fm._DTYPE_CODE[q.dtype], o.data_ptr(), do.data_ptr(),
            *fm._ptrs(sr, er, ext), delta.data_ptr(), bh, h, mh, sq,
            k.shape[1], d, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"prep launch failed: CUDA error {rc}")
        return delta, ext, h, mh

    def launch(self, which, mode, q, k, v, lse, do, sr, er, prep, outs,
               scale, causal):
        torch = self.torch
        from paddle_tpu_torch.ops import flashmask as fm
        delta, ext, h, mh = prep
        bh, sq, d = q.shape
        fn = self.lib.flashmask_bwd_dq_launch if which == "dq" \
            else self.lib.flashmask_bwd_dkv_launch
        rc = fn(mode, fm._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
                *fm._ptrs(sr, er, ext), *fm._ptrs(*outs), bh, h, mh, sq,
                k.shape[1], d, float(scale), int(bool(causal)),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{which} launch failed: CUDA error {rc}")

    def fwd(self, q, k, v, sr, er, scale, causal, out=None):
        """(o, lse) of the forward launch (the tile-extremes pre-pass and
        the forward kernel), as ``ops.flashmask.flashmask_fwd`` launches
        it; ``out`` reuses (o, lse, ext)."""
        torch = self.torch
        from paddle_tpu_torch.ops import flashmask as fm
        bh, sq, d = q.shape
        h, mh = fm._check_mask("ab", q, k, sr, er)
        if out is None:
            nk = -(-k.shape[1] // self.lib.flashmask_block_k())
            out = (torch.empty_like(q),
                   torch.empty((bh, sq), dtype=torch.float32,
                               device=q.device),
                   torch.empty(sr.shape[0] * sr.shape[1] * nk * 2,
                               dtype=torch.int32, device=q.device))
        o, lse, ext = out
        rc = self.lib.flashmask_fwd_launch(
            fm._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), sr.data_ptr(), er.data_ptr(), ext.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, h, mh, sq, k.shape[1], d,
            float(scale), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fwd launch failed: CUDA error {rc}")
        return out

    def bwd(self, mode, q, k, v, o, lse, do, sr, er, scale, causal):
        prep = self.prep(mode, q, k, o, do, sr, er)
        dq, dk, dv = (self.torch.empty_like(x) for x in (q, k, v))
        self.launch("dq", mode, q, k, v, lse, do, sr, er, prep, (dq,),
                    scale, causal)
        self.launch("dkv", mode, q, k, v, lse, do, sr, er, prep, (dk, dv),
                    scale, causal)
        return dq, dk, dv


def cases(torch, cs):
    """(name, mode, (B, H, S, D), q, k, v, do, sr, er, causal, visible
    pairs) of phase 13 (same seeds and order) and phase 15."""
    from paddle_tpu_torch.ops import flashmask as fm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(51)
    rng = np.random.default_rng(51)
    d = 64
    for name, b, s, h, kvh, mh, causal, build in cs.flashmask_specs():
        sr_np, er_np = (np.minimum(x, 2 ** 31 - 1).astype(np.int32)
                        for x in build(rng, b, mh, s))
        sr = torch.as_tensor(sr_np).cuda()
        er = torch.as_tensor(er_np).cuda()
        q, k, v, do = cs.fm_inputs(torch, gen, b, s, h, kvh, d,
                                   torch.bfloat16)
        pairs = cs.flashmask_work(sr_np, er_np, h, s, causal, d)[0]
        yield (name, fm.MODE_FLASHMASK, (b, h, s, d), q, k, v, do, sr, er,
               causal, pairs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    b, s, h = 8, 2048, 16
    q, k, v, do = cs.fm_inputs(torch, gen, b, s, h, h, d, torch.bfloat16)
    yield ("twopass_b8_s2048_h16_d64", fm.MODE_TWOPASS, (b, h, s, d), q, k,
           v, do, None, None, True, b * h * s * (s + 1) // 2)


def sdpa_bwd_ms(torch, Fn, dev_ms, shape, q, k, v, do, sr, er, causal,
                iters):
    """Device ms of SDPA's backward share (fwd + bwd less fwd) with the
    case's mask materialized (FlashMask) or ``is_causal`` (two-pass)."""
    b, h, s, d = shape
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    kw = {"is_causal": causal}
    if sr is not None:
        rowi = torch.arange(s, device="cuda")[:, None]
        keep = ~((rowi >= sr[:, :, None, :]) & (rowi < er[:, :, None, :]))
        if causal:
            keep &= rowi >= torch.arange(s, device="cuda")[None, :]
        if sr.shape[1] not in (1, h):
            keep = keep.repeat_interleave(h // sr.shape[1], dim=1)
        kw = {"attn_mask": keep}
    scale = 1.0 / math.sqrt(d)
    fwd = dev_ms(lambda: Fn.scaled_dot_product_attention(
        q4, k4, v4, scale=scale, **kw), iters=iters)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]

    def fb():
        out = Fn.scaled_dot_product_attention(*leaves, scale=scale, **kw)
        torch.autograd.grad(out, leaves, do4)

    return dev_ms(fb, iters=iters) - fwd


def fwd_row(torch, Fn, cs, fm, runs, parts_of, order, name, shape, q, k, v,
            sr, er, causal, pairs, iters):
    """The forward of every variant at one case: held to the plain version
    with the smoke's gates, then timed by device time in turns beside
    masked SDPA's forward. Returns the case's record and prints a line."""
    b, h, s, d = shape
    scale = 1.0 / math.sqrt(d)
    ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
    row = {"case": name, "mode": "flashmask_fwd", "visible_pairs": pairs,
           "variants": {}}
    for n, run in runs.items():
        o, lse, _ = run.fwd(q, k, v, sr, er, scale, causal)
        torch.cuda.synchronize()
        err, ratio = cs.bf16_agreement(o, ro, cs.FM_O_ATOL)
        lse_err = float((lse - rlse).abs().max())
        cs.check(ratio <= 1.0 and lse_err <= cs.LSE_ATOL,
                 f"{n} {name} fwd: o max abs err {err} ({ratio:.2f}x its "
                 f"allowance), lse err {lse_err}")
        if name.startswith("dead_rows"):
            cs.check(not bool(o[:, :64].any()) and
                     bool((lse[:, :64] == cs.NEG_INF_F).all()),
                     f"{n} {name} fwd: a row that sees nothing is not 0 / "
                     "-1e30")
        p = parts_of[n].fwd(1)
        row["variants"][n] = {
            "route": "tensor-core" if p else "cuda-core", "parts": p,
            "max_abs_err": err, "worst_err_over_allowed": ratio,
            "lse_err": lse_err, "fwd_turns": []}
        del o, lse
    for n in order:
        out = runs[n].fwd(q, k, v, sr, er, scale, causal)
        row["variants"][n]["fwd_turns"].append(cs.device_time_ms(
            lambda: runs[n].fwd(q, k, v, sr, er, scale, causal, out),
            iters))
        del out
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    rowi = torch.arange(s, device="cuda")[:, None]
    keep = ~((rowi >= sr[:, :, None, :]) & (rowi < er[:, :, None, :]))
    if causal:
        keep &= rowi >= torch.arange(s, device="cuda")[None, :]
    if sr.shape[1] not in (1, h):
        keep = keep.repeat_interleave(h // sr.shape[1], dim=1)
    row["sdpa_fwd_device_ms"] = cs.device_time_ms(
        lambda: Fn.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep,
                                                scale=scale), iters)
    line = [f"{name} fwd:"]
    for n, rv in row["variants"].items():
        rv["fwd_ms"] = sum(rv["fwd_turns"]) / 2
        rv["fwd_tflops"] = (1 + max(rv["parts"], 1)) * 2 * d * pairs \
            / rv["fwd_ms"] / 1e9
        line.append(f"{n} [{rv['route']}, {rv['parts']} parts] "
                    f"{rv['fwd_ms']:.4f} ms ({rv['fwd_tflops']:.1f} TFLOP/s "
                    f"executed; worst {rv['worst_err_over_allowed']:.3f});")
    line.append(f"masked sdpa fwd {row['sdpa_fwd_device_ms']:.4f} ms")
    print(" ".join(line), flush=True)
    del ro, rlse, keep
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        print("flashmask_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="flashmask_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    started = [(n, *start_build(n, src, tmp)) for n, src in specs]
    runs, parts_of, ptxas = {}, {}, {}
    for name, proc, out in started:
        lib, parts_of[name], ptxas[name] = finish_build(name, proc, out)
        runs[name] = Runner(torch, lib)
        for kern, text in ptxas[name].items():
            print(f"  [{name}] {kern}: {text}", flush=True)

    order = list(runs) + list(runs)[::-1]
    dev_ms = cs.device_time_ms
    results = []
    for (name, mode, shape, q, k, v, do, sr, er, causal,
         pairs) in cases(torch, cs):
        b, h, s, d = shape
        scale = 1.0 / math.sqrt(d)
        if mode == fm.MODE_FLASHMASK:
            ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
            refs = fm.flashmask_bwd_plain(q, k, v, ro, rlse, do, sr, er,
                                          scale, causal)
            extras = (None,) * 3
        else:                   # phase 15's gate: the flips of p and ds
            ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal)
            refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal)
            extras = cs.flash_grad_rounding(torch, fa, q, k, v, ro, rlse, do,
                                            scale, causal)
        iters = 5 if s > 4096 else 20
        if mode == fm.MODE_FLASHMASK and args.only != "bwd":
            results.append(fwd_row(torch, Fn, cs, fm, runs, parts_of, order,
                                   name, shape, q, k, v, sr, er, causal,
                                   pairs, iters))
        if args.only == "fwd":
            del q, k, v, do
            torch.cuda.empty_cache()
            continue
        row = {"case": name, "mode": "flashmask" if mode == 0 else "twopass",
               "visible_pairs": pairs, "variants": {}}
        for n, run in runs.items():
            grads = run.bwd(mode, q, k, v, ro, rlse, do, sr, er, scale,
                            causal)
            torch.cuda.synchronize()
            worst, err, where, bare = 0.0, 0.0, "dq", 0.0
            for gname, g, r, x in zip(("dq", "dk", "dv"), grads, refs,
                                      extras):
                e, ratio = cs.bf16_agreement(g, r, cs.FLASH_GRAD_ATOL, x)
                bare = max(bare, cs.bf16_agreement(g, r,
                                                   cs.FLASH_GRAD_ATOL)[1])
                if ratio >= worst:
                    where = gname
                worst, err = max(worst, ratio), max(err, e)
            cs.check(worst <= 1.0, f"{n} {name}: {where} max abs err {err},"
                     f" an element off by {worst:.2f}x its allowance")
            p = parts_of[n](mode, 1)
            row["variants"][n] = {
                "route": "tensor-core" if p else "cuda-core", "parts": p,
                "max_abs_err": err, "worst_err_over_allowed": worst,
                "worst_without_flips": bare, "dq_turns": [],
                "dkv_turns": []}
            del grads
        for n in order:
            run = runs[n]
            prep = run.prep(mode, q, k, ro, do, sr, er)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

            def dq_call():
                run.prep(mode, q, k, ro, do, sr, er)
                run.launch("dq", mode, q, k, v, rlse, do, sr, er, prep,
                           (dq,), scale, causal)

            def dkv_call():
                run.launch("dkv", mode, q, k, v, rlse, do, sr, er, prep,
                           (dk, dv), scale, causal)

            row["variants"][n]["dq_turns"].append(dev_ms(dq_call, iters))
            row["variants"][n]["dkv_turns"].append(dev_ms(dkv_call, iters))
            del prep, dq, dk, dv
        row["sdpa_bwd_device_ms"] = sdpa_bwd_ms(
            torch, Fn, dev_ms, shape, q, k, v, do, sr, er, causal, iters)
        if mode == fm.MODE_TWOPASS:
            row["fused_k2_device_ms"] = dev_ms(lambda: fa.flash_bwd(
                q, k, v, ro, rlse, do, scale, causal), iters)
        line = [f"{name}:"]
        for n, rv in row["variants"].items():
            rv["dq_ms"] = sum(rv["dq_turns"]) / 2
            rv["dkv_ms"] = sum(rv["dkv_turns"]) / 2
            rv["bwd_ms"] = rv["dq_ms"] + rv["dkv_ms"]
            pp = max(rv["parts"], 1)
            rv["dq_tflops"] = (2 + pp) * 2 * d * pairs / rv["dq_ms"] / 1e9
            rv["dkv_tflops"] = (2 + 2 * pp) * 2 * d * pairs / rv["dkv_ms"] \
                / 1e9
            line.append(
                f"{n} [{rv['route']}, {rv['parts']} parts] dq "
                f"{rv['dq_ms']:.4f} + dk/dv {rv['dkv_ms']:.4f} = "
                f"{rv['bwd_ms']:.4f} ms ({rv['dq_tflops']:.1f} / "
                f"{rv['dkv_tflops']:.1f} TFLOP/s executed; worst "
                f"{rv['worst_err_over_allowed']:.3f}"
                + (f", {rv['worst_without_flips']:.3f} without flips"
                   if mode == fm.MODE_TWOPASS else "") + ");")
        line.append(f"sdpa bwd share {row['sdpa_bwd_device_ms']:.4f} ms")
        if "fused_k2_device_ms" in row:
            line.append(f"fused K2 {row['fused_k2_device_ms']:.4f} ms")
        print(" ".join(line), flush=True)
        results.append(row)
        del q, k, v, do, ro, rlse, refs, extras
        torch.cuda.empty_cache()
    summary = {"card": card, "ptxas": ptxas, "cases": results}
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
