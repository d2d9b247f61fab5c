#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. device: require CUDA, print the card's name and power limit, build
     the CUDA kernels from ``paddle_tpu_torch/csrc`` (one nvcc each, in
     parallel) and print the build seconds;
  1. kernels against their plain PyTorch versions in bf16 at the serving
     widths (H=16, KVH=8, D=64, BS=16): ragged paged attention on a decode
     step, a mixed chunked step and a bucketed step; the int4 GEMM on the
     four projection shapes at M=8 and M=512. Each case prints its error
     and tolerance, and its kernel, plain, bound and library times;
  2. continuous-batching serving at full width in bf16 (V=32000, E=1024,
     H=16, KVH=8, D=64, L=24, F=2816, swiglu/rmsnorm, max_seq_len=512):
     12 seeded ragged requests through ContinuousBatchingEngine; every
     request must finish, the ragged kernel must launch 24 times per
     paged step, and every block must return to the free list;
  3. parity in float32 at full width and L=2: continuous-batching greedy
     tokens against the port's dense generate(), per request;
  4. int4 serving at full width in bf16: first-step logits against a
     float engine built from the dequantized int4 weights, then 4
     requests served with 96 int4-kernel launches per paged step;
  5. a ``{"kernels": [...]}`` line, then the result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Nothing here imports JAX or the JAX package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak

V, E, H, KVH, D, L, F = 32000, 1024, 16, 8, 64, 24, 2816
BS, NUM_BLOCKS, MAX_BATCH, CHUNK, SMAX = 16, 257, 8, 64, 512


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


ATTN_ATOL = 1e-5                 # f32 summation noise where |ref| ~ 0
INT4_ATOL = 1e-4


def bf16_agreement(out, ref, atol):
    """Per element, |out - ref| may be atol plus two bf16 ulps of |ref| at
    that element: the kernel and its plain version sum in f32 from the
    same bf16 inputs and differ by summation order, then each rounds to
    bf16. Returns (max abs error, largest error over its allowance); the
    outputs agree when the second is at most 1."""
    r = ref.float()
    err = (out.float() - r).abs()
    ulp = (r.abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()
    return float(err.max()), float((err / (atol + 2 * ulp)).max())


def time_ms(fn, iters=25, warmup=3):
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def llama_weights(seed, layers, scale=0.02):
    """Seeded random weights of the serving shape class (bench.py's
    serving leg), numpy float32."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)

    return dict(
        ln_scales=[np.ones(E, np.float32) for _ in range(layers)],
        qkv_weights=[mk(H + 2 * KVH, D, E) for _ in range(layers)],
        linear_weights=[mk(H * D, E) for _ in range(layers)],
        ffn_ln_scales=[np.ones(E, np.float32) for _ in range(layers)],
        ffn1_weights=[mk(E, 2 * F) for _ in range(layers)],
        ffn2_weights=[mk(F, E) for _ in range(layers)],
        embedding=mk(V, E), lm_head=mk(E, V))


def make_engine(weights, dtype, weight_quant=None):
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    return FusedMultiTransformerEngine(
        engine_weights_from_numpy(weights, "cuda", dtype), num_heads=H,
        head_dim=D, max_seq_len=SMAX, dtype=dtype, norm_type="rmsnorm",
        activation="swiglu", gqa_group_size=KVH, weight_quant=weight_quant,
        device="cuda")


def requests(seed, n, prompt=(16, 384), new=(16, 64)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append((rng.integers(1, V, p).astype(np.int32),
                    int(rng.integers(new[0], new[1] + 1))))
    return out


def serve(engine, reqs, **kw):
    """Serve (prompt, max_new) pairs through ContinuousBatchingEngine;
    returns (cb, GenerationRequest list, paged steps, wall seconds)."""
    import torch
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    cb = ContinuousBatchingEngine(engine, num_blocks=NUM_BLOCKS,
                                  block_size=BS, max_batch=MAX_BATCH,
                                  prefill_chunk=CHUNK, **kw)
    free0 = cb.allocator.num_free
    steps = [0]
    inner = engine._paged_step

    def counted(*a, **k):
        steps[0] += 1
        return inner(*a, **k)

    engine._paged_step = counted
    try:
        greqs = [GenerationRequest(p, n) for p, n in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in greqs:
            cb.submit(r)
        cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine._paged_step = inner
    for r in greqs:
        res = cb.finished[r.request_id]
        check(res.status == "finished" and len(res) == r.max_new_tokens,
              f"request {r.request_id} ended {res.status} with {len(res)} of "
              f"{r.max_new_tokens} tokens")
    check(cb.allocator.num_free == free0,
          f"blocks leaked: {cb.allocator.num_free} free of {free0}")
    return cb, greqs, steps[0], wall


# -- phase 1 -----------------------------------------------------------------

def attention_cases(torch, pa):
    """(name, q, tables, lens, q_lens) of the slice's attention shapes."""
    dev = "cuda"
    rng = np.random.default_rng(11)
    maxnb = SMAX // BS
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    kc = torch.randn(KVH, NUM_BLOCKS, BS, D, device=dev,
                     generator=gen).bfloat16()
    vc = torch.randn(KVH, NUM_BLOCKS, BS, D, device=dev,
                     generator=gen).bfloat16()
    # 8 sequences x 32 distinct blocks = the pool (block 0 is parking)
    perm = rng.permutation(np.arange(1, NUM_BLOCKS)).astype(np.int32)
    tables = perm[:MAX_BATCH * maxnb].reshape(MAX_BATCH, maxnb)
    cases = []
    lens = np.array([1, 512, 17, 100, 256, 333, 64, 480], np.int32)
    q = torch.randn(MAX_BATCH, H, D, device=dev, generator=gen).bfloat16()
    cases.append(("decode", q, tables, lens, None))
    # mixed chunked step: full chunks, partial chunks, decode rows, a
    # parked row (q_len 0) and a zero-length row
    lens = np.array([64, 130, 0, 200, 5, 512, 77, 300], np.int32)
    qls = np.array([64, 2, 0, 64, 5, 1, 0, 30], np.int32)
    q = torch.randn(MAX_BATCH, CHUNK, H, D, device=dev,
                    generator=gen).bfloat16()
    cases.append(("mixed_c64", q, tables, lens, qls))
    # bucketed step as the scheduler builds it: two idle slots parked on
    # block 0, and a host work list padded to the next power of two (the
    # kernel walks the tables; the padded length keys the bucket)
    tb = tables.copy()
    tb[[2, 6]] = 0
    lens = np.array([40, 300, 0, 97, 16, 1, 0, 200], np.int32)
    qls = np.array([8, 1, 0, 16, 16, 1, 0, 1], np.int32)
    wb = pa.RaggedWorkBuilder(MAX_BATCH, maxnb, BS,
                              pa.default_pack(MAX_BATCH, H // KVH))
    _, t_real, t_total, _ = wb.build(tb, lens, qls)
    check(t_total > t_real, f"bucketed case not padded ({t_real})")
    q = torch.randn(MAX_BATCH, 16, H, D, device=dev,
                    generator=gen).bfloat16()
    cases.append((f"bucketed_{t_real}to{t_total}", q, tb, lens, qls))
    return kc, vc, cases


def attention_work(q, tables, lens, qls):
    """Bytes and flops the case's data needs: each needed KV block read
    once per kv head, q read and out written once, 4*D flops per visible
    (query row, key) pair."""
    b = lens.shape[0]
    c = 1 if q.dim() == 3 else q.shape[1]
    maxnb = tables.shape[1]
    ql = np.ones(b, np.int64) if qls is None else qls.astype(np.int64)
    lens = lens.astype(np.int64)
    nblk = np.where((lens > 0) & (ql > 0),
                    np.minimum(-(-lens // BS), maxnb), 0)
    kv_bytes = int(nblk.sum()) * BS * D * 2 * 2 * KVH
    qo_bytes = 2 * b * c * H * D * 2
    meta = tables.nbytes + 2 * lens.size * 4
    flops = 0
    for i in range(b):
        qs = max(int(lens[i]) - int(ql[i]), 0)
        for j in range(int(ql[i])):
            flops += min(qs + j + 1, int(nblk[i]) * BS) * 4 * D * H
    return kv_bytes + qo_bytes + meta, flops


def phase_kernels(torch):
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    rows = {"attn": [], "int4": []}
    kc, vc, cases = attention_cases(torch, pa)
    for name, q, tables, lens, qls in cases:
        tab_d = torch.as_tensor(tables).cuda()
        lens_d = torch.as_tensor(lens).cuda()
        qls_d = None if qls is None else torch.as_tensor(qls).cuda()
        out = pa.ragged_paged_attention(q, kc, vc, tab_d, lens_d,
                                        q_lens=qls_d)
        ref = pa.ragged_paged_attention_plain(q, kc, vc, tab_d, lens_d,
                                              q_lens=qls_d)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"attention {name}: non-finite")
        err, ratio = bf16_agreement(out, ref, ATTN_ATOL)
        check(ratio <= 1.0, f"attention {name}: max abs err {err}, an "
              f"element off by {ratio:.2f}x its allowance")
        ms = time_ms(lambda: pa.ragged_paged_attention(
            q, kc, vc, tab_d, lens_d, q_lens=qls_d))
        plain_ms = time_ms(lambda: pa.ragged_paged_attention_plain(
            q, kc, vc, tab_d, lens_d, q_lens=qls_d), iters=20)
        nbytes, flops = attention_work(q, tables, lens, qls)
        b_ms, b_by = bound(nbytes, flops)
        # library yardstick: SDPA over the same KV gathered contiguously
        # with the same mask (timed only; the port never calls it)
        q4 = q[:, None] if q.dim() == 3 else q
        c = q4.shape[1]
        tl = torch.as_tensor(tables, dtype=torch.long).cuda()
        s_len = tables.shape[1] * BS
        kg = kc[:, tl].reshape(KVH, -1, s_len, D).transpose(0, 1)
        vg = vc[:, tl].reshape(KVH, -1, s_len, D).transpose(0, 1)
        kg = kg.repeat_interleave(H // KVH, 1).contiguous()
        vg = vg.repeat_interleave(H // KVH, 1).contiguous()
        ql_np = np.ones(len(lens), np.int64) if qls is None else qls
        qst = np.maximum(lens - ql_np, 0)
        pos = np.arange(s_len)
        vis = ((pos[None, None, :] <= (qst[:, None] + np.arange(c))[:, :,
                                                                     None])
               & (pos[None, None, :] < lens[:, None, None]))
        mask = torch.as_tensor(vis[:, None]).cuda()
        qt = q4.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: Fn.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask))
        rows["attn"].append(dict(case=name, max_abs_err=err, atol=ATTN_ATOL,
                                 worst_err_over_allowed=ratio, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms))
        print(f"  ragged_paged_attention[{name}]: err {err:.3e} (worst "
              f"{ratio:.3f} of atol {ATTN_ATOL:g} + 2 bf16 ulps of |ref|) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{b_ms:.4f} ms ({b_by}) sdpa {lib_ms:.4f} ms", flush=True)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for m in (8, 512):
        for k, n in ((E, (H + 2 * KVH) * D), (H * D, E), (E, 2 * F), (F, E)):
            w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
            bn = qm.kernel_block_n(n)
            pk, sc = qm.pack_int4_blocked(w, bn)
            pk = torch.as_tensor(pk).cuda()
            sc = torch.as_tensor(sc).cuda()
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            out = qm.weight_only_matmul(x, pk, sc, "int4", bn)
            ref = qm.weight_only_matmul_plain(x, pk, sc, "int4", bn)
            torch.cuda.synchronize()
            err, ratio = bf16_agreement(out, ref, INT4_ATOL)
            name = f"M{m}_K{k}_N{n}"
            check(ratio <= 1.0, f"int4 {name}: max abs err {err}, an "
                  f"element off by {ratio:.2f}x its allowance")
            ms = time_ms(lambda: qm.weight_only_matmul(x, pk, sc, "int4", bn))
            plain_ms = time_ms(lambda: qm.weight_only_matmul_plain(
                x, pk, sc, "int4", bn), iters=20)
            wdq = (qm.unpack_int4_blocked(pk, bn).float()
                   * sc[None, :]).bfloat16()
            lib_ms = time_ms(lambda: torch.matmul(x, wdq))
            b_ms, b_by = bound(m * k * 2 + k * n // 2 + n * 4 + m * n * 2,
                               2 * m * n * k)
            rows["int4"].append(dict(case=name, max_abs_err=err,
                                     atol=INT4_ATOL,
                                     worst_err_over_allowed=ratio, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms))
            print(f"  weight_only_int4[{name}]: err {err:.3e} (worst "
                  f"{ratio:.3f} of atol {INT4_ATOL:g} + 2 bf16 ulps of "
                  f"|ref|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}) matmul {lib_ms:.4f} ms",
                  flush=True)
    return rows


# -- phases 2-4 --------------------------------------------------------------

def reset_counts():
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    pa.ragged_paged_attention.launches = 0
    qm.weight_only_matmul.launches = 0


def read_counts():
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    return (pa.ragged_paged_attention.launches,
            qm.weight_only_matmul.launches)


def phase_serve(torch):
    t0 = time.perf_counter()
    eng = make_engine(llama_weights(0, L), "bfloat16")
    print(f"  engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    # warm-up outside the counted run (cuBLAS handles, allocator)
    serve(eng, requests(99, 2, prompt=(16, 80), new=(2, 4)))
    reqs = requests(1, 12)
    reset_counts()
    cb, greqs, steps, wall = serve(eng, reqs)
    attn, int4 = read_counts()
    check(attn == L * steps, f"ragged kernel launched {attn} times in "
          f"{steps} paged steps (want {L * steps})")
    check(int4 == 0, f"int4 kernel launched {int4} times in bf16 serving")
    toks = sum(len(cb.finished[r.request_id]) for r in greqs)
    ttft = [r.first_token_time - r.submit_time for r in greqs]
    hs = cb.host_stats()
    print(f"  served {len(greqs)} requests (prompts "
          f"{[len(p) for p, _ in reqs]}) -> {toks} tokens in {steps} paged "
          f"steps, {wall:.3f} s: {toks / wall:.1f} generated tokens/s, "
          f"{wall / steps * 1e3:.2f} ms/step, mean TTFT "
          f"{np.mean(ttft) * 1e3:.1f} ms", flush=True)
    print(f"  ragged kernel launches {attn} = {L} x {steps} steps; host "
          f"phases of the last step (s): {hs['phases']}; segments reused "
          f"{hs['segments_reused']} rebuilt {hs['segments_rebuilt']}",
          flush=True)
    profile = profile_serving(torch, eng, requests(7, 4, new=(16, 16)))
    del eng, cb
    torch.cuda.empty_cache()
    return {"steps": steps, "tokens": toks, "wall_s": wall,
            "tokens_per_s": toks / wall, "mean_ttft_s": float(np.mean(ttft)),
            "attn_launches": attn, "profile": profile}


def _kernel_class(name):
    n = name.lower()
    if "ragged_kernel" in n:
        return "ragged_attention"
    if "int4_kernel" in n:
        return "int4_gemm"
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "splitk")):
        return "library_gemm"
    return "other"


def profile_serving(torch, eng, reqs):
    """A separate traced serving run (torch.profiler, CPU + CUDA): device
    time by kernel class and the device's busy share of the window's
    wall time. Run after the timed run, so the timed numbers carry no
    tracing cost."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, steps, _ = serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_name = {}, []
    for evt in prof.key_averages():
        dev = getattr(evt, "device_type", None)
        if dev is None or "CUDA" not in str(dev):
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0)
                   or getattr(evt, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        cls = _kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
        by_name.append((us, evt.count, evt.key))
    busy = sum(by_class.values()) / 1e6
    if not by_class:
        print("  profiled window: device time not measured (the profiler "
              "returned no CUDA events)", flush=True)
        return {"wall_s": wall, "steps": steps, "device_busy_s": None}
    print(f"  profiled window: {steps} paged steps, wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({busy / wall:.1%}), idle "
          f"{1 - busy / wall:.1%}", flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {cls}: {us / 1e3:.2f} ms ({us / 1e6 / busy:.1%} of busy, "
              f"{us / 1e3 / steps:.3f} ms/step)", flush=True)
    for us, cnt, key in sorted(by_name, reverse=True)[:8]:
        print(f"    top: {us / 1e3:.2f} ms x{cnt} {key[:90]}", flush=True)
    return {"wall_s": wall, "steps": steps, "device_busy_s": busy,
            "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()}}


def phase_parity(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = make_engine(llama_weights(3, 2), "float32")
    reqs = requests(4, 8)
    cb, greqs, steps, _ = serve(eng, reqs)
    worst = 0.0
    for (p, n), r in zip(reqs, greqs):
        got = list(cb.finished[r.request_id])
        ref = eng.generate(p[None, :], max_new_tokens=n)[0].tolist()
        if got == ref:
            continue
        t = next(i for i in range(n) if got[i] != ref[i])
        ids = np.concatenate([p, np.asarray(ref[:t], np.int32)])[None, :]
        with torch.no_grad():
            lg = eng._prefill_logits(ids)[0].float()
        top = torch.topk(lg, 2).values
        gap = float(top[0] - top[1])
        worst = max(worst, gap)
        print(f"  request {r.request_id}: first differing token at step {t}"
              f" (cb {got[t]} vs dense {ref[t]}), top-2 logit gap "
              f"{gap:.3e}", flush=True)
        check(gap <= 1e-3, f"request {r.request_id} diverges at step {t} "
              f"with a top-2 logit gap {gap} > 1e-3")
    print(f"  f32 parity: {len(greqs)} requests, {steps} paged steps, CB "
          f"greedy vs dense generate(): largest tie gap at a divergence "
          f"{worst:.3e}", flush=True)
    del eng, cb
    torch.cuda.empty_cache()


def dequantized_weights(eng_q, weights):
    """Float weights equal to the int4 engine's dequantized matrices."""
    from paddle_tpu_torch.inference import _PROJECTIONS
    from paddle_tpu_torch.ops.quant_matmul import unpack_int4_blocked
    mm = eng_q._kw["_mm"]
    out = dict(weights)
    for kind, key in _PROJECTIONS:
        mats = []
        for li, pk in enumerate(eng_q._w[key]):
            deq = (unpack_int4_blocked(pk, mm.blocks[kind]).float()
                   * mm.scales[kind][li][None, :]).cpu().numpy()
            mats.append(deq.T.reshape(weights[key][li].shape)
                        if kind == "qkv" else deq)
        out[key] = mats
    return out


def phase_int4(torch):
    w = llama_weights(5, L)
    eng_q = make_engine(w, "bfloat16", weight_quant="int4")
    check("_mm" in eng_q._kw, "int4 engine did not take the kernel path")
    eng_f = make_engine(dequantized_weights(eng_q, w), "bfloat16")
    reqs = requests(6, 4)
    width = max(len(p) for p, _ in reqs)
    ids = np.zeros((len(reqs), width), np.int32)
    for i, (p, _) in enumerate(reqs):
        ids[i, :len(p)] = p
    lens = torch.as_tensor([len(p) for p, _ in reqs]).cuda()
    with torch.no_grad():
        lq = eng_q._prefill_logits(ids, lens=lens).float()
        lf = eng_f._prefill_logits(ids, lens=lens).float()
    err = float((lq - lf).abs().max())
    scale = float(lf.abs().max())
    # bf16 activations are rounded at different points (the kernel scales
    # in its f32 epilogue; the float engine multiplies bf16-rounded
    # dequantized weights), over 24 layers: allow 5% of the logit range
    tol = 0.05 * scale
    agree = float((lq.argmax(-1) == lf.argmax(-1)).float().mean())
    print(f"  int4 vs dequantized-float first-step logits: max abs diff "
          f"{err:.4e} (tol {tol:.4e}, logit max {scale:.4e}), argmax "
          f"agreement {agree:.2f}", flush=True)
    check(bool(torch.isfinite(lq).all()), "int4 logits non-finite")
    check(err <= tol, f"int4 logits differ by {err} > {tol}")
    del eng_f
    torch.cuda.empty_cache()
    reset_counts()
    cb, greqs, steps, wall = serve(eng_q, reqs)
    attn, int4 = read_counts()
    check(int4 == 4 * L * steps, f"int4 kernel launched {int4} times in "
          f"{steps} paged steps (want {4 * L * steps})")
    check(attn == L * steps, f"ragged kernel launched {attn} times in "
          f"{steps} paged steps (want {L * steps})")
    toks = sum(len(cb.finished[r.request_id]) for r in greqs)
    print(f"  int4 serving: {len(greqs)} requests -> {toks} tokens in "
          f"{steps} paged steps, {wall:.3f} s ({toks / wall:.1f} tokens/s); "
          f"int4 kernel launches {int4} = 4 x {L} x {steps}", flush=True)
    return {"steps": steps, "int4_launches": int4, "tokens_per_s":
            toks / wall}


def kernel_entry(name, source, replaces, launches, rows, main_case):
    main = next(r for r in rows if r["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "main_case": main_case,
            "cases": rows}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import _build

    print("phase 0: device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    secs = _build.build_all()
    print(f"  kernels built in {secs:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}", flush=True)

    with torch.no_grad():
        print("phase 1: kernels against their plain versions (bf16)",
              flush=True)
        rows = phase_kernels(torch)
        print("phase 2: continuous-batching serving, full width, bf16",
              flush=True)
        serve_stats = phase_serve(torch)
        print("phase 3: f32 parity, full width, L=2", flush=True)
        phase_parity(torch)
        print("phase 4: int4 serving, full width, bf16", flush=True)
        int4_stats = phase_int4(torch)

    kernels = [
        kernel_entry("ragged_paged_attention",
                     "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:484",
                     serve_stats["attn_launches"], rows["attn"], "decode"),
        kernel_entry("weight_only_int4",
                     "paddle_tpu_torch/csrc/weight_only_matmul.cu",
                     "paddle_tpu/ops/pallas/quant_matmul.py:77",
                     int4_stats["int4_launches"], rows["int4"],
                     f"M8_K{E}_N{2 * F}"),
    ]
    print(f"card: {card}; serve: {json.dumps(serve_stats)}; int4 serve: "
          f"{json.dumps(int4_stats)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
