#!/usr/bin/env python3
"""A/B timing of builds of the port's ragged paged-attention kernel on one
card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/ragged_kernel_ab.py [--variant NAME=DIR]... [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another
``ragged_paged_attention.cu`` with the headers it includes: an older
commit's ``csrc`` unpacked with ``git archive``, or a copy edited for an
experiment. Every variant is built with ``ops/_build.py``'s nvcc flags
into a temporary directory and launched through its C entry point in this
process: a source that exports ``ragged_paged_attention_abi`` (2) takes
the split plan of ``ops.paged_attention.ragged_plan``, a workspace and
zeroed counters; one without it takes the first argument list (no plan).

Cases: ``chip_smoke.py``'s phase 1 (decode, the mixed C=64 step, the
bucketed step) and phase 16's caches (B=8, the serving cache, case (b)'s
tables, the lengths after 64 decode steps). Each variant is held to the
plain version with phase 1's gate (``ATTN_ATOL`` plus two bf16 ulps of
|ref| per element), then timed by device time
(``chip_smoke.device_time_ms``) in turns A, B, ..., B, A (each variant's
time is the mean of its two turns), beside SDPA over the gathered
context and, on phase 16's caches, the legacy decode kernel (K7). Prints
one line per case, then one JSON object with every number and the card's
name and power limit (also written to ``--out``).
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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(name, src_dir, tmp):
    """Compile ``src_dir``/ragged_paged_attention.cu; (library, ABI,
    ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"ragged_paged_attention-{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, "ragged_paged_attention.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    lib = ctypes.CDLL(out)
    abi = lib.ragged_paged_attention_abi() \
        if hasattr(lib, "ragged_paged_attention_abi") else 1
    fn = lib.ragged_paged_attention_launch
    fn.restype = ctypes.c_int
    if abi == 1:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    return fn, abi, regs


def launcher(torch, pa, fn, abi):
    """A call of ``fn`` as ``ops.paged_attention`` makes it, on tensors its
    wrapper accepts (q [B, H, D] or [B, C, H, D], int32 tables and
    lengths on the card)."""
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def run(q, kc, vc, tables, lens, qls):
        q4 = q[:, None] if q.dim() == 3 else q
        b, c, h, d = q4.shape
        kvh, nb, bs, _ = kc.shape
        out = torch.empty_like(q4)
        stream = torch.cuda.current_stream().cuda_stream
        qptr = None if qls is None else qls.data_ptr()
        scale = 1.0 / math.sqrt(d)
        if abi == 1:
            rc = fn(code[q.dtype], q4.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), tables.data_ptr(), lens.data_ptr(), qptr,
                    out.data_ptr(), b, c, h, kvh, nb, bs, tables.shape[1], d,
                    scale, stream)
        else:
            plan = pa.ragged_plan(b, c, h, kvh, tables.shape[1], bs, d,
                                  q.dtype)
            ws = torch.empty(max(plan["workspace_bytes"] // 4, 1),
                             dtype=torch.float32, device="cuda")
            rc = fn(code[q.dtype], q4.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), tables.data_ptr(), lens.data_ptr(), qptr,
                    out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, c,
                    h, kvh, nb, bs, tables.shape[1], d, plan["splits"],
                    plan["pages_per_split"], scale, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out[:, 0] if q.dim() == 3 else out

    return run


def sdpa_inputs(torch, q, kc, vc, tables, lens, qls):
    """SDPA's operands over the same KV gathered contiguously, with the
    kernel's mask (clamped ids, the first min(ceil(len/BS), MAXNB) pages,
    the causal horizon)."""
    q4 = q[:, None] if q.dim() == 3 else q
    b, c, h, d = q4.shape
    kvh, nb, bs, _ = kc.shape
    tl = tables.long().clamp(0, nb - 1)
    s_len = tables.shape[1] * bs
    kg = kc[:, tl].reshape(kvh, b, s_len, d).transpose(0, 1)
    vg = vc[:, tl].reshape(kvh, b, s_len, d).transpose(0, 1)
    kg = kg.repeat_interleave(h // kvh, 1).contiguous()
    vg = vg.repeat_interleave(h // kvh, 1).contiguous()
    lens_np = lens.cpu().numpy().astype(np.int64)
    ql = np.ones(b, np.int64) if qls is None \
        else qls.cpu().numpy().astype(np.int64)
    qst = np.maximum(lens_np - ql, 0)
    nblk = np.minimum(-(-lens_np // bs), tables.shape[1])
    pos = np.arange(s_len)
    vis = ((pos[None, None, :] <= (qst[:, None] + np.arange(c))[:, :, None])
           & (pos[None, None, :] < (nblk * bs)[:, None, None]))
    mask = torch.as_tensor(vis[:, None]).cuda()
    return q4.transpose(1, 2).contiguous(), kg, vg, mask


def cases(torch, cs, pa):
    """(name, q, k cache, v cache, tables, lens, q_lens) on the card."""
    kc, vc, phase1 = cs.attention_cases(torch, pa)
    out = []
    for name, q, tables, lens, qls in phase1:
        out.append((name, q, kc, vc, torch.as_tensor(tables).cuda(),
                    torch.as_tensor(lens).cuda(),
                    None if qls is None else torch.as_tensor(qls).cuda()))
    out.append(("phase16_serving_cache", *cs.decode_step_caches(torch),
                None))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        print("ragged_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.set_grad_enabled(False)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="ragged_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    runs, ptxas, abis = {}, {}, {}
    for name, src in specs:
        fn, abis[name], ptxas[name] = build(name, src, tmp)
        runs[name] = launcher(torch, pa, fn, abis[name])
        for ln in ptxas[name]:
            print(f"  [{name}] {ln}", flush=True)

    order = list(runs) + list(runs)[::-1]
    dev_ms = cs.device_time_ms
    results = []
    for name, q, kc, vc, tables, lens, qls in cases(torch, cs, pa):
        ref = pa.ragged_paged_attention_plain(q, kc, vc, tables, lens,
                                              q_lens=qls)
        row = {"case": name, "variants": {}}
        for n, run in runs.items():
            out = run(q, kc, vc, tables, lens, qls)
            torch.cuda.synchronize()
            err, ratio = cs.bf16_agreement(out, ref, cs.ATTN_ATOL)
            cs.check(ratio <= 1.0, f"{n} {name}: max abs err {err}, an "
                     f"element off by {ratio:.2f}x its allowance")
            row["variants"][n] = {"max_abs_err": err,
                                  "worst_err_over_allowed": ratio,
                                  "turns": []}
        for n in order:
            run = runs[n]
            row["variants"][n]["turns"].append(dev_ms(
                lambda: run(q, kc, vc, tables, lens, qls), iters=100))
        qt, kg, vg, mask = sdpa_inputs(torch, q, kc, vc, tables, lens, qls)
        row["sdpa_device_ms"] = dev_ms(lambda: Fn.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask), iters=100)
        line = [f"{name}:"]
        for n, v in row["variants"].items():
            v["device_ms"] = sum(v["turns"]) / 2
            line.append(f"{n} {v['device_ms']:.4f} ms (turns "
                        f"{v['turns'][0]:.4f} / {v['turns'][1]:.4f}, worst "
                        f"{v['worst_err_over_allowed']:.3f});")
        line.append(f"sdpa {row['sdpa_device_ms']:.4f} ms")
        if name.startswith("phase16"):
            row["legacy_k7_device_ms"] = dev_ms(lambda: pa.paged_attention(
                q, kc, vc, tables, lens), iters=100)
            line.append(f"legacy K7 {row['legacy_k7_device_ms']:.4f} ms")
        print(" ".join(line), flush=True)
        results.append(row)
        del qt, kg, vg, mask
    summary = {"card": card, "abi": abis, "ptxas": ptxas, "cases": results}
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
