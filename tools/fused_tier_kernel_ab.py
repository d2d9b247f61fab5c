#!/usr/bin/env python3
"""A/B timing of builds of the port's fused-tier kernels A (RMSNorm with
its residual) and C (the streamed token cross entropy) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/fused_tier_kernel_ab.py [--variant NAME=DIR]...
        [--only norm|ce] [--out PATH]

The tree's ``paddle_tpu_torch/csrc`` is variant ``tree``. Each
``--variant`` names a directory holding another ``fused_norm.cu`` and
``token_ce.cu`` with the headers they include: an older commit's ``csrc``
unpacked with ``git archive``, or a copy edited for an experiment. Every
variant is built with ``ops/_build.py``'s nvcc flags into a temporary
directory (all sources at once) and launched through its C entry points
in this process. A build of the first bodies (a ``fused_norm.cu`` with
``fused_norm_bwd_blocks``, a ``token_ce.cu`` without
``token_ce_fwd_row_kernel``) is called with their argument lists, its
routes "block" and "two-pass"; any other build is given the routes and
A's grid of ``ops.fused_norm.bwd_plan`` and ``ops.token_ce.fwd_plan``,
as the wrappers give them.

Cases: ``chip_smoke.py``'s phase 18 (``NORM_SPECS``, ``CE_SPECS``): A's
forward and backward, C's forward and backward. Each variant is held to
the plain versions with phase 18's gates (atol + 2 ulps per element, two
calls bit-equal), then timed by device time (``chip_smoke.device_time_ms``)
in turns A, B, ..., B, A (each variant's time is the mean of its two
turns), beside the library calls (``F.rms_norm`` after the add and its
backward share, ``F.cross_entropy`` and its backward share). Prints the
card's name and power limit, one line per case, then one JSON object
with every number (also written to ``--out``).
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

SOURCES = ("fused_norm", "token_ce")


def build(name, src_dir, tmp, sources):
    """Compile ``src_dir``'s sources in parallel; ({source: library},
    {source: ptxas lines})."""
    from paddle_tpu_torch.ops import _build
    procs = {}
    for src in sources:
        out = os.path.join(tmp, f"{src}-{name}.so")
        procs[src] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(src_dir, src + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for src, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{src}:\n{log}")
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "entry function" in ln]
        libs[src] = ctypes.CDLL(out)
    return libs, ptxas


def ptxas_summary(lines):
    """[(kernel, registers, spill store bytes)] from ``-Xptxas -v`` lines
    (a compiled form's name shortened to its template and arguments)."""
    out, name, spill = [], None, 0
    for ln in lines:
        if "entry function" in ln:
            name = ln.split("'")[1]
            for key in ("warp_kernel", "row_kernel", "bwd_kernel",
                        "fwd_kernel", "dw_kernel", "sum_kernel"):
                if key in name:
                    name = key + name.split(key, 1)[1][:24]
                    break
        elif "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used " in ln and name:
            out.append((name, int(ln.split("Used ")[1].split()[0]), spill))
            name = None
    return out


def variant_ops(torch, libs, src_dir):
    """A's and C's forward and backward through one build's C entry
    points, as the wrappers call them (same outputs, same checks left to
    the wrappers' tests), and each backward / forward's route."""
    from paddle_tpu_torch.ops import _launch as L
    from paddle_tpu_torch.ops import fused_norm as fn
    ops, routes = {}, {}
    if "fused_norm" in libs:
        lib = libs["fused_norm"]
        fwd = lib.fused_norm_fwd
        fwd.argtypes = L.PROTOTYPES["fused_norm"]["fused_norm_fwd"]
        bwd = lib.fused_norm_bwd
        blocks = getattr(lib, "fused_norm_bwd_blocks", None)
        if blocks is not None:      # the first body: G from the library
            blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
            bwd.argtypes = L.PROTOTYPES["fused_norm"]["fused_norm_bwd"][
                :15] + [ctypes.c_void_p]
        else:
            bwd.argtypes = L.PROTOTYPES["fused_norm"]["fused_norm_bwd"]
        fwd.restype = bwd.restype = ctypes.c_int
        sms = L.sms(torch.device("cuda"))

        def norm_fwd(x, w, eps, bias, res, od):
            r, hid = x.shape
            out = torch.empty((r, hid), dtype=od, device=x.device)
            h = x if bias is None and res is None else torch.empty_like(x)
            inv = torch.empty(r, dtype=torch.float32, device=x.device)
            tc = L.DTYPE_CODE[x.dtype]
            rc = fwd(tc, L.DTYPE_CODE[w.dtype], L.DTYPE_CODE[od],
                     int(fn._vec(hid, x, w, bias, res, out, h)),
                     x.data_ptr(), L.ptr(bias), L.ptr(res), w.data_ptr(),
                     out.data_ptr(), None if h is x else h.data_ptr(),
                     inv.data_ptr(), r, hid, float(eps), L.stream(x))
            L.raise_on("fused_norm_fwd", rc)
            return out, h, inv

        def norm_bwd(dout, dres, h, w, inv, od):
            r, hid = h.shape
            dh, dw = torch.empty_like(h), torch.empty_like(w)
            vec = fn._vec(hid, dout, dres, h, w, dh)
            plan = fn.bwd_plan(r, hid, h.dtype, sms, vec)
            g = plan["blocks"] if blocks is None else blocks(r, sms)
            route = () if blocks is not None else (
                plan["warps_per_row"], plan["warps_per_block"])
            part = torch.empty((g, hid), dtype=torch.float32,
                               device=h.device)
            rc = bwd(L.DTYPE_CODE[h.dtype], L.DTYPE_CODE[w.dtype],
                     L.DTYPE_CODE[od], int(vec),
                     dout.data_ptr(), L.ptr(dres), h.data_ptr(),
                     w.data_ptr(), inv.data_ptr(), dh.data_ptr(),
                     part.data_ptr(), dw.data_ptr(), r, hid, g, *route,
                     L.stream(h))
            L.raise_on("fused_norm_bwd", rc)
            return dh, dw

        def norm_route(dt, r, hid):
            if blocks is not None:
                return "block (first body)"
            plan = fn.bwd_plan(r, hid, dt, sms, hid % 8 == 0)
            return plan["route"] + (f" x{plan['warps_per_row']}"
                                    if plan["route"] == "warps" else "")
        ops.update(norm_fwd=norm_fwd, norm_bwd=norm_bwd)
        routes["norm"] = norm_route
    if "token_ce" in libs:
        lib = libs["token_ce"]
        cfwd, cbwd = lib.token_ce_fwd, lib.token_ce_bwd
        with open(os.path.join(src_dir, "token_ce.cu")) as f:
            first = "token_ce_fwd_row_kernel" not in f.read()
        cfwd.argtypes = L.PROTOTYPES["token_ce"]["token_ce_fwd"]
        if first:                   # the first body: no route arguments
            cfwd.argtypes = cfwd.argtypes[:13] + [ctypes.c_void_p]
        cbwd.argtypes = L.PROTOTYPES["token_ce"]["token_ce_bwd"]
        cfwd.restype = cbwd.restype = ctypes.c_int
        from paddle_tpu_torch.ops import token_ce as tcm

        def ce_fwd(x, lab, ignore, eps):
            n, vocab = x.shape
            f32 = dict(dtype=torch.float32, device=x.device)
            loss, stats = torch.empty(n, **f32), torch.empty((n, 2), **f32)
            totals = torch.empty(3, **f32)
            plan = tcm.fwd_plan(n, vocab, x.dtype)
            route = () if first else (plan["chunks"], plan["cluster"])
            rc = cfwd(L.DTYPE_CODE[x.dtype], int(tcm._vec(x)), x.data_ptr(),
                      lab.data_ptr(), loss.data_ptr(), stats.data_ptr(),
                      totals.data_ptr(), n, x.stride(0), vocab, int(ignore),
                      float(1 - eps), float(eps), *route, L.stream(x))
            L.raise_on("token_ce_fwd", rc)
            return loss, stats, totals

        def ce_bwd(x, lab, stats, g, totals, ignore, eps, reduction):
            n, vocab = x.shape
            dx = torch.empty_like(x)
            rc = cbwd(L.DTYPE_CODE[x.dtype], int(tcm._vec(x)), x.data_ptr(),
                      lab.data_ptr(), stats.data_ptr(), g.data_ptr(),
                      totals.data_ptr(), dx.data_ptr(), n, x.stride(0),
                      vocab, int(ignore), float(1 - eps), float(eps),
                      tcm._GMODE[reduction], L.stream(x))
            L.raise_on("token_ce_bwd", rc)
            return dx

        def ce_route(dt, n, vocab):
            if first:
                return "two-pass (first body)"
            plan = tcm.fwd_plan(n, vocab, dt)
            return {"two-pass": "two-pass",
                    "rows": f"rows x{plan['chunks']}"}.get(
                        plan["route"], f"cluster of {plan['cluster']}")
        ops.update(ce_fwd=ce_fwd, ce_bwd=ce_bwd)
        routes["ce"] = ce_route
    return ops, routes


def gate(cs, torch, name, outs, again, ref, atols):
    """Phase 18's gate: two calls bit-equal, each output within its atol
    + 2 ulps of the plain version. Returns (max abs err, worst share)."""
    cs.check(all(torch.equal(a, b) for a, b in zip(outs, again)),
             f"{name}: two calls differ")
    err = ratio = 0.0
    for o, r, atol in zip(outs, ref, atols):
        cs.check(bool(torch.isfinite(o).all()), f"{name}: non-finite")
        e, q = cs.two_ulp_agreement(o, r, atol(r) if callable(atol) else atol)
        err, ratio = max(err, e), max(ratio, q)
    cs.check(ratio <= 1.0, f"{name}: max abs err {err}, an element off by "
             f"{ratio:.2f}x its allowance")
    return err, ratio


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--only", choices=("norm", "ce"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("fused_tier_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import token_ce as tc
    torch.set_grad_enabled(False)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    sources = SOURCES if args.only is None else \
        {"norm": ("fused_norm",), "ce": ("token_ce",)}[args.only]
    tmp = tempfile.mkdtemp(prefix="tier_ab_")
    specs = [("tree", os.path.join(ROOT, "paddle_tpu_torch", "csrc"))]
    for v in args.variant:
        name, _, src = v.partition("=")
        specs.append((name, os.path.join(ROOT, src)))
    variants, routes, ptxas = {}, {}, {}
    for name, src in specs:
        libs, ptxas[name] = build(name, src, tmp, sources)
        variants[name], routes[name] = variant_ops(torch, libs, src)
        for s, lines in ptxas[name].items():
            for ln in lines:
                print(f"  [{name}/{s}] {ln}", flush=True)

    order = list(variants) + list(variants)[::-1]
    dev_ms = cs.device_time_ms
    gen = torch.Generator(device="cuda")
    results = []
    kinds = []
    if args.only in (None, "norm"):
        kinds += [("norm", spec, cs.norm_case) for spec in cs.NORM_SPECS]
    if args.only in (None, "ce"):
        kinds += [("ce", spec, cs.ce_case) for spec in cs.CE_SPECS]
    seeded = None
    for kind, spec, make in kinds:
        if kind != seeded:          # phase 18's seeds: the same inputs
            gen.manual_seed({"norm": 81, "ce": 83}[kind])
            seeded = kind
        c = make(torch, gen, spec)
        dt = c["bwd_args"][2].dtype if kind == "norm" else \
            c["fwd_args"][0].dtype
        shape = tuple(c["bwd_args"][2].shape if kind == "norm" else
                      c["fwd_args"][0].shape)
        plain = {"norm": (fn.rms_norm_fwd_plain, fn.rms_norm_bwd_plain),
                 "ce": (tc.token_ce_fwd_plain,
                        lambda *a: (tc.token_ce_bwd_plain(*a),))}[kind]
        for d, (args_, atols, nbytes, lib, lib_minus) in (
                ("fwd", (c["fwd_args"], c["fwd_atols"], c["fwd_bytes"],
                         c["lib_fwd"], None)),
                ("bwd", (c["bwd_args"], c["bwd_atols"], c["bwd_bytes"],
                         c["lib_grad"], c["lib_grad_minus"]))):
            ref = plain[d == "bwd"](*args_)
            row = {"kernel": f"{kind}_{d}", "case": c["name"],
                   "variants": {}}
            runs = {}
            for n, ops in variants.items():
                op = ops[f"{kind}_{d}"]
                run = (lambda op=op: (op(*args_),)) if (kind, d) == \
                    ("ce", "bwd") else (lambda op=op: op(*args_))
                runs[n] = run
                outs, again = run(), run()
                torch.cuda.synchronize()
                err, ratio = gate(cs, torch, f"{n} {kind}_{d}[{c['name']}]",
                                  outs, again, ref, atols)
                row["variants"][n] = {
                    "route": routes[n][kind](dt, *shape),
                    "max_abs_err": err, "worst_over_allowed": ratio,
                    "turns": []}
            for n in order:
                row["variants"][n]["turns"].append(dev_ms(runs[n]))
            lib_ms = dev_ms(lib) if lib_minus is None else \
                cs.library_share_ms(lib, lib_minus)
            row["library_ms"] = lib_ms
            row["bound_ms"] = cs.bound(nbytes, 0)[0]
            line = [f"{kind}_{d}[{c['name']}]:"]
            for n, v in row["variants"].items():
                v["device_ms"] = sum(v["turns"]) / 2
                line.append(f"{n} {v['device_ms']:.4f} ms (turns "
                            f"{v['turns'][0]:.4f} / {v['turns'][1]:.4f}, "
                            f"route {v['route']}, worst "
                            f"{v['worst_over_allowed']:.3f});")
            line.append(f"bound {row['bound_ms']:.4f}; library "
                        f"{lib_ms:.4f}")
            print(" ".join(line), flush=True)
            results.append((kind, row))
            del ref, runs
        del c
        torch.cuda.empty_cache()
    summary = {"card": card, "ptxas": ptxas,
               "cases": [r for _, r in results]}
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
