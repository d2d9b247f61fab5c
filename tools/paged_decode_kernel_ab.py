#!/usr/bin/env python3
"""A/B timing of builds of the port's legacy paged decode kernel on one
card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/paged_decode_kernel_ab.py [--variant NAME=DIR]... [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another
``paged_decode_attention.cu`` with the headers it includes: an older
commit's ``csrc`` unpacked with ``git archive``, or a copy edited for an
experiment. Every variant is built with ``ops/_build.py``'s nvcc flags
into a temporary directory and launched through its C entry point in this
process: a source that exports ``paged_decode_attention_abi`` (2) takes
the split plan of ``ops.paged_attention.decode_plan``, a workspace and
zeroed counters; one without it takes the first argument list (one block
per sequence and kv head, no plan).

Cases: ``chip_smoke.py``'s phase 16 kernel cases ((a) BS=64 in bf16 and
f32, (b) the serving cache, (c) MHA, (d) ctx 0 and past capacity, (e)
pages of 128 keys, (f) MQA) and phase 16's caches after 64 decode steps.
Each variant is held to the plain version with phase 16's gate
(``DECODE_ATOL`` plus one ulp of the output type per element), then
timed by device time (``chip_smoke.device_time_ms``) in turns A, B, ...,
B, A (each variant's time is the mean of its two turns), beside SDPA over
the gathered context and, where the block size allows it (BS <= 32), the
ragged kernel (K3) on the same caches. Then the decode op of phase 16
(``DECODE_STEPS`` steps x 24 layers of ``block_multihead_attention`` at
B=8) with each variant in the kernel's place, host ms per step (wall
clock ending in ``synchronize()``), in the same turns. Prints the card's
name and power limit, one line per case, then one JSON object with every
number (also written to ``--out``).
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
    """Compile ``src_dir``/paged_decode_attention.cu; (library entry point,
    ABI, ptxas lines)."""
    from paddle_tpu_torch.ops import _build
    out = os.path.join(tmp, f"paged_decode_attention-{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
           os.path.join(src_dir, "paged_decode_attention.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(out)
    abi = lib.paged_decode_attention_abi() \
        if hasattr(lib, "paged_decode_attention_abi") else 1
    fn = lib.paged_decode_attention_launch
    fn.restype = ctypes.c_int
    if abi == 1:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    return fn, abi, regs


def launcher(torch, pa, fn, abi):
    """A call of ``fn`` as ``ops.paged_attention.paged_attention`` makes
    it, on tensors its wrapper accepts (int32 tables and lengths on the
    card)."""
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def run(q, kc, vc, tables, lens):
        b, h, d = q.shape
        kvh, nb, bs, _ = kc.shape
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        scale = 1.0 / math.sqrt(d)
        if abi == 1:
            rc = fn(code[q.dtype], q.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), tables.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), b, h, kvh, nb, bs, tables.shape[1], d,
                    scale, stream)
        else:
            plan = pa.decode_plan(b, h, kvh, tables.shape[1], bs, d, q.dtype)
            ws = torch.empty(max(plan["workspace_bytes"] // 4, 1),
                             dtype=torch.float32, device="cuda")
            rc = fn(code[q.dtype], q.data_ptr(), kc.data_ptr(),
                    vc.data_ptr(), tables.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h,
                    kvh, nb, bs, tables.shape[1], d, plan["splits"],
                    plan["pages_per_split"], scale, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return run


def cases(torch, cs):
    """(name, q, k cache, v cache, tables, lens) on the card."""
    out = [(case[0], *tensors)
           for case, *tensors in cs.decode_case_tensors(torch)]
    out.append(("phase16_serving_cache", *cs.decode_step_caches(torch)))
    return out


def op_ms_per_step(torch, cs, pa, run, inputs):
    """Host ms per decode step of phase 16's decode op with ``run`` in
    the decode kernel's place (tables and lengths as the op passes them,
    cast to int32 on the card as the wrapper does)."""
    import time
    tables, lens0, caches, qkv = inputs
    saved = pa.paged_attention

    def kernel(q, kc, vc, block_tables, context_lens, scale=None):
        return run(q, kc, vc, pa._on_device(block_tables, q.device,
                                            torch.int32),
                   pa._on_device(context_lens, q.device,
                                 torch.int32).reshape(-1))

    pa.paged_attention = kernel
    try:
        cs.decode_op_steps(caches, qkv, tables, lens0, 2)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.decode_op_steps(caches, qkv, tables, lens0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / cs.DECODE_STEPS * 1e3
    finally:
        pa.paged_attention = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        print("paged_decode_kernel_ab: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.set_grad_enabled(False)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="decode_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    runs, ptxas, abis = {}, {}, {}
    for name, src in specs:
        fn, abis[name], ptxas[name] = build(name, src, tmp)
        runs[name] = launcher(torch, pa, fn, abis[name])
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in ptxas[name] if "Used " in ln})
        spills = sum("0 bytes spill stores" not in ln
                     for ln in ptxas[name] if "spill stores" in ln)
        print(f"  [{name}] ABI {abis[name]}; registers {regs}; kernels "
              f"with spills {spills}", flush=True)

    order = list(runs) + list(runs)[::-1]
    dev_ms = cs.device_time_ms
    results = []
    for name, q, kc, vc, tables, lens in cases(torch, cs):
        ref = pa.paged_attention_plain(q, kc, vc, tables, lens)
        b, h, d = q.shape
        kvh, _, bs, _ = kc.shape
        plan = pa.decode_plan(b, h, kvh, tables.shape[1], bs, d, q.dtype)
        row = {"case": name, "plan": plan, "variants": {}}
        for n, run in runs.items():
            out = run(q, kc, vc, tables, lens)
            torch.cuda.synchronize()
            err, ratio = cs.ulp_agreement(out, ref, cs.DECODE_ATOL)
            cs.check(ratio <= 1.0, f"{n} {name}: max abs err {err}, an "
                     f"element off by {ratio:.2f}x its allowance")
            row["variants"][n] = {"max_abs_err": err,
                                  "worst_err_over_allowed": ratio,
                                  "turns": []}
        for n in order:
            run = runs[n]
            row["variants"][n]["turns"].append(dev_ms(
                lambda: run(q, kc, vc, tables, lens), iters=50))
        q4, kg, vg, mask = cs.decode_sdpa_inputs(torch, q, kc, vc, tables,
                                                 lens)
        row["sdpa_device_ms"] = dev_ms(lambda: Fn.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask), iters=50)
        del q4, kg, vg, mask
        row["k3_device_ms"] = None
        if bs <= 32:
            row["k3_device_ms"] = dev_ms(lambda: pa.ragged_paged_attention(
                q, kc, vc, tables, lens), iters=50)
        line = [f"{name} ({cs.decode_plan_text(plan)}):"]
        for n, v in row["variants"].items():
            v["device_ms"] = sum(v["turns"]) / 2
            line.append(f"{n} {v['device_ms']:.4f} ms (turns "
                        f"{v['turns'][0]:.4f} / {v['turns'][1]:.4f}, worst "
                        f"{v['worst_err_over_allowed']:.3f});")
        line.append(f"sdpa {row['sdpa_device_ms']:.4f} ms")
        if row["k3_device_ms"] is not None:
            line.append(f"K3 {row['k3_device_ms']:.4f} ms")
        print(" ".join(line), flush=True)
        results.append(row)
    inputs = cs.decode_op_inputs(torch)
    op = {n: [] for n in runs}
    for n in order:
        op[n].append(op_ms_per_step(torch, cs, pa, runs[n], inputs))
    del inputs
    print("decode op, ms per step: " + "; ".join(
        f"{n} {sum(t) / 2:.3f} (turns {t[0]:.3f} / {t[1]:.3f})"
        for n, t in op.items()), flush=True)
    summary = {"card": card, "abi": abis, "ptxas": ptxas, "cases": results,
               "op_ms_per_step": op}
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
