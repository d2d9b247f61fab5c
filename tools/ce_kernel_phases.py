#!/usr/bin/env python3
"""Where one step of the bf16 blockwise-CE backward's cluster kernel spends
its time, phase by phase, on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/ce_kernel_phases.py [T,H,V ...] [--out PATH]

The script copies ``paddle_tpu_torch/csrc/blockwise_ce.cu`` into a
temporary directory and instruments the copy: thread 0 of every block
reads ``clock64()`` at the boundaries of the phases of each step of
``blockwise_ce_bwd_cluster_kernel`` and adds the differences into a
device array. The copy is built with ``ops/_build.py``'s nvcc flags and
launched once for dh and once for dw per shape (default: phase 9's
flagship, T=16384, H=1024, V=32000, and T=1000, V=32001) after a warm-up
launch. It prints, per kernel and shape, the launch's time (CUDA events,
the instrumentation included), the SM clocks of one block and their share
per phase, then one JSON object with every number and the card's name and
power limit (also written to ``--out``). The phases, in the order a step
runs them:

  A wait        waiting at cluster barrier A (and the loop's top)
  reduce        summing this block's rows of the partials, dl, and the
                pushes of the three bf16 parts to every rank
  panel wait    the streamed panel's copy and the block barrier before
                the next step's logits
  logits        the next step's partial logits on the tensor cores
  B wait        waiting at cluster barrier B
  push partials the partials' pushes to the ranks that reduce them
  contraction   the three split products into the step's f32 sum
  accumulate    arrive at A, the f32 accumulate, the next copy issued

A marker whose anchor line is missing from the source stops the script:
the anchors follow the kernel's text and move with it.
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

PHASES = ("A wait", "reduce", "panel wait", "logits", "B wait",
          "push partials", "contraction", "accumulate")

# (phase index that ends at this point, anchor text, marker goes before or
# after the anchor)
MARKS = (
    (0, "    const int row0 = DW ? s * BM : trow0, col0 = DW ? tcol0 : s * BN;\n",
     "after"),
    (1, "    cluster_arrive();                            // B(s)", "before"),
    (2, "      __syncthreads();\n      product(lg, DW ? Sp : R, DW ? R : Sp);",
     "panel"),
    (3, "    if (s + 1 < nsteps) logits(s + 1, lg);\n", "after"),
    (4, "    if (s + 1 < nsteps) push_partials(lg);\n", "before"),
    (5, "    float cacc[DW ? 2 : 1][8][4] = {};", "before"),
    (6, "    const bool more = s + 1 < nsteps;", "before"),
    (7, "    if (more) cluster_wait();", "before"),
)


def instrument(src):
    """The source with the clock marks, a device array of per-phase sums
    and two C entry points to reset and read it."""
    def mark(k):
        return f"    PHASE_MARK({k})\n"

    s = src.replace("namespace {\n", "namespace {\n__device__ unsigned long "
                    "long g_phase[16];\n", 1)
    head = "  const bool pipe = npanel == 1;\n"
    if s.count(head) != 1:
        raise SystemExit(f"anchor not found once: {head!r}")
    s = s.replace(head, head + (
        "  unsigned long long pt[8] = {};\n"
        "  long long plast = clock64();\n"
        "#define PHASE_MARK(k) { const long long nw = clock64(); "
        "pt[k] += nw - plast; plast = nw; }\n"))
    for k, anchor, where in MARKS:
        if s.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        if where == "after":
            s = s.replace(anchor, anchor + mark(k))
        elif where == "before":
            s = s.replace(anchor, mark(k) + anchor)
        else:                       # inside logits, before the product
            first, _, rest = anchor.partition("\n")
            s = s.replace(anchor, first + "\n      if (s > 0) PHASE_MARK("
                          f"{k})\n" + rest)
    tail = "  cluster.sync();                                // a block exits"
    if s.count(tail) != 1:
        raise SystemExit(f"anchor not found once: {tail!r}")
    s = s.replace(tail, (
        "  if (threadIdx.x == 0) {\n"
        "    for (int k = 0; k < 8; ++k) atomicAdd(&g_phase[k], pt[k]);\n"
        "    atomicAdd(&g_phase[15], 1ull);\n"
        "  }\n") + tail)
    return s.replace('}  // extern "C"', (
        "int phase_read(unsigned long long* o) {\n"
        "  cudaDeviceSynchronize();\n"
        "  return (int)cudaMemcpyFromSymbol(o, g_phase, sizeof(g_phase));\n"
        "}\n"
        "int phase_reset() {\n"
        "  const unsigned long long z[16] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n"
        "}\n"
        '}  // extern "C"'))


def build(tmp):
    from paddle_tpu_torch.ops import _build
    with open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                           "blockwise_ce.cu")) as f:
        src = instrument(f.read())
    path = os.path.join(tmp, "blockwise_ce.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(tmp, "blockwise_ce_phases.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                        path], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(out)
    for name, n_int in (("blockwise_ce_dh_launch", 4),
                        ("blockwise_ce_dw_launch", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * n_int + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.phase_read.argtypes = [ctypes.c_void_p]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shapes", nargs="*", default=["16384,1024,32000",
                                                  "1000,1024,32001"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ce_kernel_phases: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import blockwise_ce as bc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="ce_phases_")
    lib = build(tmp)
    results = []
    for shape in args.shapes:
        t, hid, vocab = (int(x) for x in shape.split(","))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(31)
        h = torch.randn(t, hid, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(hid, vocab, device="cuda", generator=gen)
             * 0.02).bfloat16()
        lab = torch.randint(0, vocab, (t,), device="cuda", generator=gen)
        g = torch.ones(t, device="cuda")
        _, lse = bc.ce_fwd_plain(h, w, lab, -100)
        stream = torch.cuda.current_stream().cuda_stream
        for which in ("dh", "dw"):
            out = torch.empty_like(h if which == "dh" else w)
            ptrs = (h.data_ptr(), w.data_ptr(), lab.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), None, out.data_ptr())

            def launch():
                if which == "dh":
                    return lib.blockwise_ce_dh_launch(
                        1, *ptrs, t, hid, vocab, 1, -100, stream)
                return lib.blockwise_ce_dw_launch(1, *ptrs, t, hid, vocab,
                                                  -100, stream)

            if launch() != 0:
                raise RuntimeError(f"{which} launch failed")
            torch.cuda.synchronize()
            lib.phase_reset()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = launch()
            b.record()
            b.synchronize()
            if rc != 0:
                raise RuntimeError(f"{which} launch failed")
            buf = (ctypes.c_ulonglong * 16)()
            lib.phase_read(buf)
            blocks = max(int(buf[15]), 1)
            clocks = [buf[k] / blocks for k in range(8)]
            total = sum(clocks)
            steps = -(-vocab // 128) if which == "dh" else -(-t // 64)
            row = {"kernel": which, "T": t, "H": hid, "V": vocab,
                   "ms": a.elapsed_time(b), "blocks": blocks,
                   "clocks_per_block": total,
                   "clocks_per_step": total / steps,
                   "share": {p: c / total for p, c in zip(PHASES, clocks)}}
            results.append(row)
            print(f"{which} T={t} H={hid} V={vocab}: {row['ms']:.3f} ms, "
                  f"{total / steps:.0f} clocks a step; " + ", ".join(
                      f"{p} {100 * c / total:.1f}%"
                      for p, c in zip(PHASES, clocks)), flush=True)
            del out
        del h, w, lab, g, lse
        torch.cuda.empty_cache()
    text = json.dumps({"card": card, "results": results})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
