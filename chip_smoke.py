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
     four projection shapes at M=8, 128 and 512. Each case prints its
     error and tolerance, its kernel, plain, bound and library times,
     its plan (attention: route, page splits, row tiles, blocks,
     workspace, and the route the call took; GEMM: tile, K splits,
     blocks) and the device-only times of the kernel, plain and library
     calls;
  2. continuous-batching serving at full width in bf16 (V=32000, E=1024,
     H=16, KVH=8, D=64, L=24, F=2816, swiglu/rmsnorm, max_seq_len=512):
     12 seeded ragged requests through ContinuousBatchingEngine; every
     request must finish, the ragged kernel must launch 24 times per
     paged step, and every block must return to the free list; a
     profiled window prints the ragged kernel's device ms per step;
  3. parity in float32 at full width and L=2: continuous-batching greedy
     tokens against the port's dense generate(), per request;
  4. int4 serving at full width in bf16: first-step logits against a
     float engine built from the dequantized int4 weights, then 4
     requests served with 96 int4-kernel launches per paged step;
  5. the flash-attention forward and backward kernels against their plain
     versions in bf16: the flagship training shape (B=8, S=2048, H=16,
     D=64, causal), the forward entry's shape (B=4, S=128, H=8, KVH=4,
     D=32), a length off the tile and a non-causal case; each prints its
     worst element against its tolerance (the gradients' includes the
     one-ulp flips that f32 summation order can cause where p and ds are
     rounded to bf16, as o's includes p's rounding) and the kernel,
     plain, bound and SDPA times;
  6. the Llama forward at the forward entry's shape (bf16, 4 layers):
     logits through the kernels against the plain attention path;
  7. flagship pretraining (V=32000, E=1024, F=2816, L=24, 16 heads, bf16
     AMP-O2, B=8, S=2048): 2 warm-up and 3 timed steps on fresh seeded
     batches, tokens/s, ms/step, MFU, loss and grad norm, 24 forward and
     24 backward flash launches per step, the fused tier's launches, then
     a profiled step (device busy share and time by kernel class) and a
     step's "other" kernels by source operation;
  8. f32 training parity at full width, L=2: 3 steps through the kernels
     against the plain attention path (loss and grad norm), then the loss
     falls over 10 steps on one repeated batch;
  9. the blockwise LM-head cross-entropy kernels (forward, dh, dw) against
     their plain versions in bf16: the flagship (T = 8 x 2048, H=1024,
     V=32000), a case off every tile (T=1000, V=32001) with ignored rows,
     and a quarter of the rows ignored; each prints the backward's
     cluster plan (route, blocks per cluster, slice, tile, clusters
     resident, SMs busy), the forward's route and plan (wgmma, or wgmma
     over rows padded to 16 bytes; splits, tile, stages, blocks, bytes
     copied) with its device time beside its event time, its worst
     element against its allowance and the kernel, plain, bound and
     unfused matmul + cross_entropy times, with dh / dw in TFLOP/s of the
     bound's work (4 T' H V) and of the work executed (8 T' H V: the exact
     split of dl costs three products);
 10. the flash kernels with the rope operands against their plain
     versions in bf16: the flagship training shape, a GQA case and a
     length off the tile;
 11. flagship pretraining as phase 7 with the fused LM-head loss and rope
     inside the flash kernels (``fused_lm_loss``, ``fuse_rope_in_attention``):
     tokens/s, ms/step, MFU and peak memory beside phase 7's, exactly one
     launch of each CE kernel and 24 + 24 rope-fused flash launches per
     step, no logits, peak memory below phase 7's, then a profiled step;
 12. f32 training parity at full width, L=2, with both options: 3 steps
     through the kernels against the plain attention and plain CE paths;
 13. the FlashMask kernels (forward, dq, dk / dv) against their plain
     versions in bf16 at the flagship's attention widths (H=16, D=64):
     packed causal documents (B=8, S=2048), seeded 2-column bands, GQA
     16/4, S off the tile, non-causal, rows that see nothing (o, dq and
     their dk / dv exactly 0) and a long context (S=16384); each prints its
     worst element against its allowance, the live share of the 64 x 64
     tiles and the kernel (the forward's device time too), plain, bound
     and masked-SDPA times, and the forward's and the backward's routes
     (tensor cores and the parts of p, and of p and ds, or CUDA cores)
     with the TFLOP/s each executes on the visible pairs. Then one
     24-layer step's attention over packed documents through
     ``incubate.nn.functional.flashmask_attention`` with autograd: exactly
     24 launches of each kernel, timed beside 24 causal flash calls;
 14. the same entry in f32 (B=2): kernels against the plain versions;
 15. the two-pass flash backward (the FlashMask backward kernels without
     the interval) against ``flash_bwd_plain`` at the flagship shape (the
     one-ulp flips of rounded p and ds allowed, as in phase 5), 24 calls
     counted, timed beside the fused backward and SDPA's, with its route
     and executed TFLOP/s;
 16. the legacy paged decode kernel against its plain version and its
     split arithmetic at the plan's splits (bf16, and f32 for one case):
     serve_bench's ragged-leg shape (B=8, BS=64, lens 1-448), the
     serving cache (BS=16, 257 blocks), MHA 16/16, rows at ctx 0 and
     past the table's capacity with -1 ids past the last used block,
     pages of 128 keys and MQA 16/1; each with its plan, two bit-equal
     calls and device times beside SDPA's; then 64 decode steps x 24
     layers of ``incubate.nn.functional.block_multihead_attention`` at
     B=8 over the serving cache (exactly 24 launches per step, the last
     step's outputs and the caches against a plain-route run, the
     kernel's device ms per step), timed beside
     ``ragged_paged_attention`` on the same caches (serve_bench's legacy
     A/B tolerance, 2e-2);
 17. the int8 weight-only GEMM against its plain version at the serving
     projections (M = 8, 128, 512), each with its plan; int8 serving at
     full width in bf16 (first-step logits against a bf16 engine built from
     the dequantized int8 weights, 6 requests with 4 x 24 int8 launches per
     paged step, a profiled window); dense ``generate()`` at bench.py's
     int8 leg (B=8, 16-token prompts, 64 new tokens) beside bf16 and int4
     on the same weights; f32 int8 tokens at L=2 against the plain route;
     int8 and int4 engines at ``LlamaConfig.tiny``'s widths (E=64), whose
     64-wide projections send the whole engine to the dequant route,
     launching no GEMM kernel;
18. the training step's fused tier against its plain versions: kernel A
     (RMSNorm with its residual, forward and backward) at the flagship
     (R = 16384, H = 1024, bf16, with and without a residual), in f32, at
     H = 1000 on 16383 rows, with fused_rms_norm's f32 output, at phase
     26 (a)'s rank (R = 8192, with and without a residual), at
     Llama-7B's H = 4096, on one row of H = 8 and at H = 8200; kernel B
     (SwiGLU) on the flagship's fused [R, 2 x 2816] projection read in
     place, the two-tensor form, phase 26 (a)'s rank ([8192, 2 x 1408] in
     place) and im = 1000; kernel C (token cross entropy) on the
     flagship's bf16 logits, in f32, at phase 26 (a)'s rank (N = 8192),
     at V = 32001, GPT-2's
     50257 and Llama-3's 128256 with ignored rows and label smoothing 0.1,
     and with labels outside [0, V) (NaN rows); kernel D (AdamW with the
     clip) over the flagship's 373.9M parameters. Each case: every element
     within atol + 2 ulps (AdamW's p, m, v and gnorm within 2 f32 ulps),
     two calls bit-equal, and the device ms of the kernel, its plain
     version, its bound and one PyTorch call of the same function where
     there is one (F.rms_norm after the add and its backward share,
     F.cross_entropy and its backward share, AdamW(fused) after
     clip_grad_norm_; none for SwiGLU). A's backward and C's forward print
     the route each case took, which must be the one their plans name,
     and together the cases must take every route ("warp", "warps",
     "block"; "rows", "cluster", "two-pass"). Phases 7 and 11 assert the
     tier's launches a step (norm 49 + 49, SwiGLU 24 + 24, token CE 1 + 1
     in phase 7 and none in phase 11, AdamW 2) and print a step's "other"
     kernels by source operation; phases 8 and 12 hold the kernels against
     a reference that also runs the tier's plain versions;
 19. (run after phase 4, under no_grad) the serving front door at full
     width in bf16: ``paddle_tpu_torch.serving``'s HTTP/SSE gateway on
     127.0.0.1 and its stepper thread in front of phase 2's engine (prefix
     cache on, an SLO monitor), an asyncio client over TCP. The 12
     requests of phase 2, opened as SSE streams under ``stepper.hold()``
     so that they land on one admission pass, must stream the tokens of
     the same batch run through a fresh ContinuousBatchingEngine with no
     HTTP in the path; a cancel after 2 token events ends with a typed
     ``end`` and an exact prefix of its solo run; ``deadline_steps=1``
     answers 504 and a ``spec_k`` wider than the engine 422; /metrics,
     /slo and /healthz parse; the blocks return; the ragged kernel
     launches 24 times a paged step; the stepper records no error and the
     peak memory stays that of the direct run. Prints tokens/s, ms per
     paged step and mean TTFT through the gateway and direct, and a
     profiled window behind the gateway (idle share, K3's device ms);
 20. (after 19) two flagship replicas on the card, each with its own
     stepper, behind ``EngineRouter``: 4 prompt families x 3 nested
     resumes (a 128-token prefix shared within a family) under round
     robin, least loaded and prefix affinity, the pool's tokens/s each;
     every request finishes, 24 ragged launches a paged step over both
     replicas, prefix affinity maps strictly more cached-prefix tokens
     and prefills strictly fewer than round robin; a step() fault on
     replica 0 fails its streamed request (``engine_error``), resubmits
     its queued one to replica 1, where it finishes, and routes the next
     submit there; then the same workload over two f32 engines at L=2
     (TF32 off): every policy's tokens equal one engine's dense
     generate() under phase 3's rule;
 21. flagship pretraining as phase 7 (its seed and batches, 2 warm-up and
     3 timed steps) with ``recompute=True``, then
     ``recompute="dots_saveable"``: the step-0 loss bit-equal to phase
     7's, the flash forward launched 48 times a step and its backward 24
     (a flash call is not a dot, so both modes run it again), the fused
     tier's forward-side kernels of the layers launched twice, grad norms
     within 1e-2 relative of phase 7's at the same step, each of the 147
     tensors' step-0 gradient within 4 times its spread over two repeats
     of phase 7's step 0 (read from the first moment, clip scale taken
     out), peak memory below phase 7's; tokens/s, ms/step, MFU (phase 7's flops per token, the
     recomputed forward not counted) and peak memory beside phase 7's;
 22. the flagship with ``telemetry=True`` and a ``TrainHealthMonitor``
     (tools/train_health.json's monitor block, the healthy run's 30 s
     stall threshold) fed through ``io.DataLoader(num_workers=2,
     instrument=True)`` on phase 7's batches: no breach over 6 steps, the
     seven group labels of the spec with finite norms, the step-0 loss
     bit-equal to phase 7's, kernel D launched 2 times a step, ms/step
     beside phase 7's; then a NaN'd batch at step 1 of 3 from a fresh
     model (``non_finite`` fires once, the next step runs, no CUDA
     error); ``tools/torch_train_monitor.py --device cuda --check
     tools/train_health.json`` (the JAX baseline's fire matrices); kernel
     D over the flagship's 147 tensors with and without the telemetry
     (p, m, v and gnorm bit-equal, the vector within 1e-5 of
     ``pack_telemetry_plain``, device ms beside its bound);
 23. (after 22, under no_grad) ``fused_multi_transformer``'s serving
     options at the serving flagship's width (L=24, GQA 16/8, swiglu,
     rmsnorm), f32 and bf16: a 128-token ``pre_caches`` prefix + 384
     tokens, B=8, against one prefill over the 512 (suffix rows and
     caches within 1e-4 x max(1, |ref|) in f32, 5e-2 x max |ref| in
     bf16); a zero ``attn_mask`` bit-equal to none and -1e30 over columns
     [len, S) bit-equal to ``seq_lens``; training dropout p=0.1 on a
     layer whose output is its dropped out-projection (kept share within
     6 sigma of 0.9, kept values exactly x / 0.9), ``training=False``
     bit-equal to p=0; ``FusedMultiTransformer`` with weights and biases
     from numpy bit-equal to the functional op; bf16 ms per prefill;
 24. (a, under no_grad) phase 2's serving twice, plain and with
     ``MemoryMonitor(interval_s=0)``, ``shed_on_pressure`` and the cost
     catalog on: tokens equal, the monitor reading the allocator (no
     census), ``paged_step``'s counted flops, bytes, intensity, peak, MFU
     and roofline share (each in (0, 1]), K3's 24 counted launches, the
     mean tick; (b) a budget 1.05 x the reserved bytes: ``hbm_pressure``
     fires, 4 queued priority-2 requests are shed with that reason and
     the 4 admitted ones keep their unpressured tokens; (c) phase 7's
     step with the catalog: ``pretrain_step`` counted once (flops a token
     beside bench.py's 6N + 12 L E S), three steps timed by CUDA events
     (the catalog's MFU and roofline share in (0, 1], beside phase 7's
     MFU), and the flash, SwiGLU, token-CE and AdamW kernels' own counts
     a launch equal to ``ops.work``'s bound within 1%;
 25. (after 20, under no_grad) kv-head-sharded tensor-parallel serving
     over gloo, the ranks processes on the one card (``--tp-follower``
     runs one): the ragged kernel at a rank's heads (8 / 4 and 4 / 2) on
     phase 1's cases and the int8 / int4 GEMM at a rank's projection
     shapes (K x N 1024 x 1024, 512 x 1024, 1024 x 2816, 1408 x 1024, 704
     x 1024) against their plain versions; then tp=2 at the serving
     flagship's width on phase 2's 12 requests, each leg beside a tp=1
     engine: f32, bf16, int8 and int4 in f32 and in bf16, and tp=4 at
     L=2 in f32. Gates: f32 tokens equal to tp=1's (a part only at a
     near tie, phase 3's rule), bf16 step-0 logits within 5% of the
     logit range, on every rank 24 ragged launches, 48 all_reduces (and
     96 GEMM launches when quantized) a step and cache bytes 1/tp, the
     collective bytes equal to the steps' analytic payload, /healthz's
     mesh block with two device rows; prints ms/step, tokens/s, rank 0's
     idle share and K3's device ms a step beside tp=1. Followers are
     joined with a timeout; one that fails or hangs fails the phase;
 26. (last, with autograd) the sharded pretrain mesh over gloo, every
     rank a process on the one card (``--mesh-rank`` runs one; the test
     bed, not a deployment): (a) the pretrain flagship (L=24, B=8,
     S=2048, bf16 AMP-O2) on fsdp 2 x mp 2, phase 7's seeded weights and
     batches, one warm step and 3 timed ones: the step-0 loss within
     ``MESH_LOSS_RTOL`` and the step-0 grad norm within
     ``MESH_GNORM_RTOL`` of phase 7's, each rank's bytes at rest equal to
     the analytic figure from ``spec_for_param``, its collective calls
     and bytes equal to ``sharded.step_comm``, exactly 24 + 24 flash
     launches, 49 + 49 norm, 24 + 24 SwiGLU, 1 + 1 token CE and 2 AdamW
     a step on every rank, finite losses; prints ms/step, global
     tokens/s, MFU against one card, each rank's peak memory and bytes
     at rest, rank 0's idle share and collectives by op and axis. (b)
     f32 at full width and L=2 on dp 2 x fsdp 2 x mp 2 (eight ranks),
     phase 8's seeded weights and batches: the losses and grad norms of
     3 steps within ``TRAIN_RTOL`` of the one-card f32 step on the card
     and the gathered masters within ``MESH_MASTER_ATOL`` (below one lr
     step), at least 99.9% of every tensor's elements and every element
     of a 1-D tensor within ``MESH_MASTER_BULK``. Ranks are joined with a
     timeout; one that fails or hangs fails the phase;
  then a ``{"kernels": [...]}`` line and the result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Nothing here imports JAX or the JAX package.
"""
import asyncio
import contextlib
import json
import math
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


def bf16_agreement(out, ref, atol, extra=None):
    """Per element, |out - ref| may be atol plus two bf16 ulps of |ref| at
    that element (plus ``extra`` there, where the two round inputs of the
    sum differently): the kernel and its plain version sum in f32 from
    the same bf16 inputs and differ by summation order, then each rounds
    to bf16. Returns (max abs error, largest error over its allowance);
    the outputs agree when the second is at most 1."""
    r = ref.float()
    err = (out.float() - r).abs()
    ulp = (r.abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()
    allowed = atol + 2 * ulp
    if extra is not None:
        allowed = allowed + extra
    return float(err.max()), float((err / allowed).max())


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


def device_time_ms(fn, iters=50, sleep=10_000_000):
    """Device time of one call without the host's: ``iters`` calls queued
    behind a sleep kernel of ``sleep`` cycles, so that the card never
    waits for the host, between two CUDA events, over the count."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def library_share_ms(full, minus):
    """Device ms of the share of ``full()`` (a PyTorch forward and
    backward through autograd) that ``minus()`` (its forward) leaves: 20
    calls of each behind a sleep long enough (about 0.1 s) that autograd's
    host work never leaves the card waiting."""
    return device_time_ms(full, iters=20, sleep=200_000_000) - \
        device_time_ms(minus, iters=20, sleep=200_000_000)


def bound(nbytes, flops):
    """(ms, "bytes" or "operations") by ``ops.work.bound_ms``, the one
    owner of the kernels' work formulas and the card's peaks."""
    from paddle_tpu_torch.ops import work
    return work.bound_ms(nbytes, flops, HBM_BYTES_PER_S, BF16_FLOPS_PER_S)


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


def make_engine(weights, dtype, weight_quant=None, tp=1, group=None):
    """The serving flagship's engine on the card; at tp > 1 one rank's
    (the full weights stay on the host until the engine cuts its
    shard)."""
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    return FusedMultiTransformerEngine(
        engine_weights_from_numpy(weights, "cuda" if tp == 1 else "cpu",
                                  dtype), num_heads=H,
        head_dim=D, max_seq_len=SMAX, dtype=dtype, norm_type="rmsnorm",
        activation="swiglu", gqa_group_size=KVH, weight_quant=weight_quant,
        tp=tp, group=group, device="cuda")


def requests(seed, n, prompt=(16, 384), new=(16, 64)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(prompt[0], prompt[1] + 1))
        out.append((rng.integers(1, V, p).astype(np.int32),
                    int(rng.integers(new[0], new[1] + 1))))
    return out


@contextlib.contextmanager
def counted_steps(engine):
    """Count ``engine``'s paged steps while the block runs: yields a
    one-element list holding the count (each engine is stepped by one
    thread, so the count needs no lock)."""
    steps = [0]
    inner = engine._paged_step

    def counted(*a, **k):
        steps[0] += 1
        return inner(*a, **k)

    engine._paged_step = counted
    try:
        yield steps
    finally:
        engine._paged_step = inner


def check_pool(cb):
    """Every block back: none in use, no references, free + pooled (the
    prefix cache's reusable blocks) the whole pool."""
    from tools.torch_serve_gates import alloc_baseline
    a = cb.allocator
    check(alloc_baseline(cb), f"blocks leaked: {a.num_used} in use, "
          f"{a.num_free} free + {a.num_pooled} pooled of "
          f"{a.num_blocks - a.reserved}")


def serve(engine, reqs, **kw):
    """Serve (prompt, max_new) pairs through ContinuousBatchingEngine;
    returns (cb, GenerationRequest list, paged steps, wall seconds)."""
    import torch
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    cb = ContinuousBatchingEngine(engine, num_blocks=NUM_BLOCKS,
                                  block_size=BS, max_batch=MAX_BATCH,
                                  prefill_chunk=CHUNK, **kw)
    with counted_steps(engine) as steps:
        greqs = [GenerationRequest(p, n) for p, n in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in greqs:
            cb.submit(r)
        cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in greqs:
        res = cb.finished[r.request_id]
        check(res.status == "finished" and len(res) == r.max_new_tokens,
              f"request {r.request_id} ended {res.status} with {len(res)} of "
              f"{r.max_new_tokens} tokens")
    check_pool(cb)
    return cb, greqs, steps[0], wall


# -- phase 1 -----------------------------------------------------------------

def attention_cases(torch, pa, h=H, kvh=KVH):
    """(name, q, tables, lens, q_lens) of the slice's attention shapes, at
    `h` query and `kvh` kv heads (one rank's shard under tensor-parallel
    serving: H / tp and KVH / tp)."""
    H, KVH = h, kvh
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


def attention_work(q, tables, lens, qls, kvh=KVH):
    """Bytes and flops the case's data needs (``ops.work.ragged_attention``):
    each needed KV block read once per kv head, q read and out written
    once, 4*D flops per visible (query row, key) pair."""
    from paddle_tpu_torch.ops import work
    c = 1 if q.dim() == 3 else q.shape[1]
    return work.ragged_attention(lens, qls, c, tables.shape[1], BS,
                                 q.shape[-2], kvh, D, 2, tables.nbytes)


def ragged_plan_text(plan):
    """A ragged attention plan (``paged_attention.ragged_plan``) as one
    short field."""
    return (f"plan {plan['route']} S {plan['splits']} x "
            f"{plan['pages_per_split']} pages, {plan['tiles']} row tiles, "
            f"blocks {plan['blocks']}, workspace {plan['workspace_bytes']} B")


def plan_text(plan):
    """A weight-only GEMM plan (``quant_matmul.plan``) as one short field."""
    return (f"plan BM {plan['bm']} BN {plan['bn']} S {plan['splits']} "
            f"blocks {plan['blocks']}")


def device_times(kernel, plain, library):
    """A kernel row's device times (``device_time_ms``) of the kernel, its
    plain version and the library yardstick: at decode sizes the per-call
    event times carry the host's time per call."""
    return {"device_ms": device_time_ms(kernel),
            "plain_device_ms": device_time_ms(plain, iters=20),
            "library_device_ms": device_time_ms(library)}


def device_text(dev):
    return (f"device ms: kernel {dev['device_ms']:.4f} plain "
            f"{dev['plain_device_ms']:.4f} library "
            f"{dev['library_device_ms']:.4f}")


def sdpa_yardstick(torch, q, kc, vc, tables, lens, qls, h=H, kvh=KVH):
    """The library yardstick of a ragged attention case: SDPA over the
    same KV gathered contiguously with the same mask (timed only; the
    port never calls it). Returns the call."""
    import torch.nn.functional as Fn
    q4 = q[:, None] if q.dim() == 3 else q
    c = q4.shape[1]
    tl = torch.as_tensor(tables, dtype=torch.long).cuda()
    s_len = tables.shape[1] * BS
    kg = kc[:, tl].reshape(kvh, -1, s_len, D).transpose(0, 1)
    vg = vc[:, tl].reshape(kvh, -1, s_len, D).transpose(0, 1)
    kg = kg.repeat_interleave(h // kvh, 1).contiguous()
    vg = vg.repeat_interleave(h // kvh, 1).contiguous()
    ql_np = np.ones(len(lens), np.int64) if qls is None else qls
    qst = np.maximum(lens - ql_np, 0)
    pos = np.arange(s_len)
    vis = ((pos[None, None, :] <= (qst[:, None] + np.arange(c))[:, :, None])
           & (pos[None, None, :] < lens[:, None, None]))
    mask = torch.as_tensor(vis[:, None]).cuda()
    qt = q4.transpose(1, 2).contiguous()
    return lambda: Fn.scaled_dot_product_attention(qt, kg, vg,
                                                   attn_mask=mask)


def phase_kernels(torch):
    from paddle_tpu_torch.ops import work
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
        sdpa = sdpa_yardstick(torch, q, kc, vc, tables, lens, qls)
        lib_ms = time_ms(sdpa)
        c = 1 if q.dim() == 3 else q.shape[1]
        plan = pa.ragged_plan(MAX_BATCH, c, H, KVH, tables.shape[1], BS, D,
                              q.dtype)
        dev = device_times(
            lambda: pa.ragged_paged_attention(q, kc, vc, tab_d, lens_d,
                                              q_lens=qls_d),
            lambda: pa.ragged_paged_attention_plain(q, kc, vc, tab_d, lens_d,
                                                    q_lens=qls_d),
            sdpa)
        check(pa.ragged_paged_attention.route == plan["route"],
              f"attention {name}: route {pa.ragged_paged_attention.route} "
              f"against the plan's {plan['route']}")
        rows["attn"].append(dict(case=name, max_abs_err=err, atol=ATTN_ATOL,
                                 worst_err_over_allowed=ratio, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms,
                                 plan=plan, **dev))
        print(f"  ragged_paged_attention[{name}]: err {err:.3e} (worst "
              f"{ratio:.3f} of atol {ATTN_ATOL:g} + 2 bf16 ulps of |ref|) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{b_ms:.4f} ms ({b_by}) sdpa {lib_ms:.4f} ms; "
              f"{ragged_plan_text(plan)}; {device_text(dev)}", flush=True)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for m in (8, 128, 512):
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
            b_ms, b_by = bound(*work.weight_only_matmul(m, k, n, 4))
            plan = qm.plan(m, k, n, x.dtype)
            dev = device_times(
                lambda: qm.weight_only_matmul(x, pk, sc, "int4", bn),
                lambda: qm.weight_only_matmul_plain(x, pk, sc, "int4", bn),
                lambda: torch.matmul(x, wdq))
            rows["int4"].append(dict(case=name, max_abs_err=err,
                                     atol=INT4_ATOL,
                                     worst_err_over_allowed=ratio, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms,
                                     plan=plan, **dev))
            print(f"  weight_only_int4[{name}]: err {err:.3e} (worst "
                  f"{ratio:.3f} of atol {INT4_ATOL:g} + 2 bf16 ulps of "
                  f"|ref|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}) matmul {lib_ms:.4f} ms; "
                  f"{plan_text(plan)}; {device_text(dev)}", flush=True)
    return rows


# -- phases 2-4 --------------------------------------------------------------

def reset_counts():
    from paddle_tpu_torch.ops import blockwise_ce as bc
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    pa.ragged_paged_attention.launches = 0
    pa.paged_attention.launches = 0
    qm.weight_only_matmul.launches = 0
    qm.weight_only_matmul.int8_launches = 0
    fa.flash_fwd.launches = fa.flash_fwd.rope_launches = 0
    fa.flash_bwd.launches = fa.flash_bwd.rope_launches = 0
    fa.flash_bwd_twopass.dq_launches = fa.flash_bwd_twopass.dkv_launches = 0
    bc.ce_fwd.launches = bc.ce_bwd_dh.launches = bc.ce_bwd_dw.launches = 0
    fm.flashmask_fwd.launches = 0
    fm.flashmask_bwd.dq_launches = fm.flashmask_bwd.dkv_launches = 0
    from paddle_tpu_torch.ops import adamw, fused_norm, swiglu, token_ce
    for fn in (fused_norm.rms_norm_fwd, fused_norm.rms_norm_bwd,
               swiglu.swiglu_fwd, swiglu.swiglu_bwd, token_ce.token_ce_fwd,
               token_ce.token_ce_bwd, adamw.adamw_step):
        fn.launches = 0
    adamw.adamw_step.telemetry_launches = 0


def read_tier_counts():
    """(norm fwd, norm bwd, swiglu fwd, swiglu bwd, token CE fwd, token CE
    bwd, AdamW kernel launches) of the fused tier."""
    from paddle_tpu_torch.ops import adamw, fused_norm, swiglu, token_ce
    return (fused_norm.rms_norm_fwd.launches,
            fused_norm.rms_norm_bwd.launches, swiglu.swiglu_fwd.launches,
            swiglu.swiglu_bwd.launches, token_ce.token_ce_fwd.launches,
            token_ce.token_ce_bwd.launches, adamw.adamw_step.launches)


def tier_counts_per_step(cfg, fused_loss):
    """The fused tier's launches a training step of ``cfg``: two norms a
    layer and the final one, forward and backward; one SwiGLU a layer,
    forward and backward; the token CE once each way unless the LM-head
    loss is fused; kernel D's two launches."""
    n_norm = 2 * cfg.num_hidden_layers + 1
    n_ce = 0 if fused_loss else 1
    return (n_norm, n_norm, cfg.num_hidden_layers, cfg.num_hidden_layers,
            n_ce, n_ce, 2)


def read_counts():
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    return (pa.ragged_paged_attention.launches,
            qm.weight_only_matmul.launches)


def read_decode_counts():
    """(legacy paged decode, int8 GEMM) launches."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    return pa.paged_attention.launches, qm.weight_only_matmul.int8_launches


def read_flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    return fa.flash_fwd.launches, fa.flash_bwd.launches


def read_flashmask_counts():
    """(FlashMask fwd, dq, dk / dv, two-pass dq, two-pass dk / dv)
    launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    return (fm.flashmask_fwd.launches, fm.flashmask_bwd.dq_launches,
            fm.flashmask_bwd.dkv_launches, fa.flash_bwd_twopass.dq_launches,
            fa.flash_bwd_twopass.dkv_launches)


def read_fused_counts():
    """(ce_fwd, ce_bwd_dh, ce_bwd_dw, flash fwd with rope, flash bwd with
    rope) launches."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    from paddle_tpu_torch.ops import flash_attention as fa
    return (bc.ce_fwd.launches, bc.ce_bwd_dh.launches, bc.ce_bwd_dw.launches,
            fa.flash_fwd.rope_launches, fa.flash_bwd.rope_launches)


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
    reqs = requests(7, 4, new=(16, 16))
    profile = profile_window(torch, lambda: serve(eng, reqs)[2],
                             "paged steps")
    k3_ms = None
    if profile.get("device_ms_by_class"):
        k3_ms = profile["device_ms_by_class"].get(
            "ragged_attention", 0.0) / profile["steps"]
        print(f"  ragged kernel device time: {k3_ms:.4f} ms per paged step "
              f"({L} launches)", flush=True)
    del eng, cb
    torch.cuda.empty_cache()
    return {"steps": steps, "tokens": toks, "wall_s": wall,
            "tokens_per_s": toks / wall, "mean_ttft_s": float(np.mean(ttft)),
            "attn_launches": attn, "profile": profile,
            "ragged_device_ms_per_step": k3_ms}


def _kernel_class(name):
    n = name.lower()
    if "rms_norm_" in n:
        return "fused_norm"
    if "swiglu_" in n:
        return "swiglu"
    if "token_ce_" in n:
        return "token_ce"
    if "adamw_" in n and "multi_tensor" not in n:
        return "adamw"
    if "blockwise_ce" in n:
        return "blockwise_ce"
    if "flashmask" in n:
        return "flashmask"
    if "ragged_kernel" in n:
        return "ragged_attention"
    if "paged_decode_kernel" in n:
        return "paged_decode_attention"
    if "int4_kernel" in n:
        return "int4_gemm"
    if "int8_kernel" in n:
        return "int8_gemm"
    if "flash_fwd_kernel" in n:
        return "flash_fwd"
    if "flash_bwd" in n:
        return "flash_bwd"
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "splitk", "nvjet")):
        return "library_gemm"
    return "other"


def profile_window(torch, work, unit):
    """A separate traced run of ``work()``, which returns its step count
    (torch.profiler, CPU + CUDA): device time by kernel class and the
    device's busy share of the window's wall time. Run after the timed
    run, so the timed numbers carry no tracing cost."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = work()
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
    print(f"  profiled window: {steps} {unit}, wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({busy / wall:.1%}), idle "
          f"{1 - busy / wall:.1%}", flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {cls}: {us / 1e3:.2f} ms ({us / 1e6 / busy:.1%} of busy, "
              f"{us / 1e3 / steps:.3f} ms/step)", flush=True)
    for us, cnt, key in sorted(by_name, reverse=True)[:8]:
        print(f"    top: {us / 1e3:.2f} ms x{cnt} {key[:90]}", flush=True)
    return {"wall_s": wall, "steps": steps, "device_busy_s": busy,
            "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()}}


OTHER_HEADS = ("norm", "residual add", "SwiGLU", "CE", "AdamW and clip",
               "AMP casts", "qkv slices and BSHD<->BHSD copies", "rope",
               "embedding", "the rest")
_QKV = "qkv slices and BSHD<->BHSD copies"
# autograd Functions of the port whose forward leaves no op to match a
# backward node to: the node's name decides
_FUNCTION_HEADS = (("FlashAttention", _QKV), ("RmsNorm", "norm"),
                   ("SwiGLU", "SwiGLU"), ("TokenCrossEntropy", "CE"),
                   ("BlockwiseCE", "CE"))


@contextlib.contextmanager
def head_annotations(torch):
    """Wrap the port's modules and functions that own a head of
    ``OTHER_HEADS`` in ``record_function("head:<head>")`` ranges for the
    traced run of ``attribute_other``; restores them after."""
    from paddle_tpu_torch.models import llama, pretrain
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layers import common, norm
    targets = ((llama.LlamaAttention, "forward", _QKV),
               (llama.LlamaMLP, "forward", "SwiGLU"),
               (llama.LlamaDecoderLayer, "forward", "residual add"),
               (llama.LlamaModel, "forward", "AMP casts"),
               (llama.LlamaLMHead, "forward", "AMP casts"),
               (llama.LlamaPretrainingCriterion, "forward", "CE"),
               (llama, "fused_lm_head_loss", "CE"),
               (norm.RMSNorm, "forward", "norm"),
               (common.Embedding, "forward", "embedding"),
               (F, "fused_rotary_position_embedding", "rope"),
               (pretrain, "_adamw", "AdamW and clip"))
    saved = []
    for owner, attr, head in targets:
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _head=head, **k):
            with torch.profiler.record_function("head:" + _head):
                return _fn(*a, **k)

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def attribute_other(torch, work):
    """A traced run of ``work()`` that sums the device time of the "other"
    kernel class by the source operation that launched each kernel
    (``OTHER_HEADS``): the innermost ``head_annotations`` range around the
    launching op decides; a kernel of the backward pass is charged to the
    forward op that made its autograd node (matched by sequence number);
    an unannotated cast (and its backward) is an AMP cast. Returns {head:
    ms}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with head_annotations(torch), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    return other_by_head(prof.events())


def other_by_head(events):
    """{head: ms} of the "other" kernels attached to profiler ``events``
    (see ``attribute_other``); prints the table."""
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            forward.setdefault((e.thread, e.sequence_nr), e)

    def head_of(e):
        cast = False
        while e is not None:
            if e.name.startswith("head:"):
                return e.name[5:]
            if e.name.startswith("autograd::engine::evaluate_function: "):
                fwd = forward.get((e.fwd_thread, e.sequence_nr))
                if fwd is None:
                    return next((h for k, h in _FUNCTION_HEADS
                                 if k in e.name), "the rest")
                cast = cast or fwd.name in ("aten::to", "aten::_to_copy")
                e = fwd
                continue
            cast = cast or e.name in ("aten::to", "aten::_to_copy")
            e = e.cpu_parent
        return "AMP casts" if cast else "the rest"

    # a kernel is attached to every op event of its correlation id: take
    # each id's innermost (shortest) event once
    launcher = {}
    for e in events:
        if getattr(e, "kernels", None):
            best = launcher.get(e.id)
            if best is None or e.cpu_time_total < best.cpu_time_total:
                launcher[e.id] = e
    ms = {h: 0.0 for h in OTHER_HEADS}
    top = {h: {} for h in OTHER_HEADS}
    for e in launcher.values():
        for k in e.kernels:
            if _kernel_class(k.name) != "other":
                continue
            head = head_of(e)
            ms[head] += k.duration / 1e3
            key = k.name[:60]
            top[head][key] = top[head].get(key, 0.0) + k.duration / 1e3
    total = sum(ms.values())
    print(f"  'other' by source operation (a traced step with head "
          f"ranges): {total:.2f} ms", flush=True)
    for h in OTHER_HEADS:
        best = sorted(top[h].items(), key=lambda kv: -kv[1])[:3]
        print(f"    {h}: {ms[h]:.2f} ms; "
              + "; ".join(f"{n} {t:.2f}" for n, t in best), flush=True)
    return ms


def tie_gap(torch, eng, prompt, got, n, label):
    """Phase 3's rule: greedy tokens ``got`` must equal ``eng``'s dense
    generate() of ``prompt``, except that they may part at a near tie.
    Returns the top-2 logit gap at the first differing token (0.0 when
    none differs) and fails past 1e-3."""
    prompt = np.asarray(prompt, np.int32)
    ref = eng.generate(prompt[None, :], max_new_tokens=n)[0].tolist()
    if got == ref:
        return 0.0
    check(len(got) == n, f"{label}: {len(got)} of {n} tokens")
    t = next(i for i in range(n) if got[i] != ref[i])
    ids = np.concatenate([prompt, np.asarray(ref[:t], np.int32)])[None, :]
    with torch.no_grad():
        lg = eng._prefill_logits(ids)[0].float()
    top = torch.topk(lg, 2).values
    gap = float(top[0] - top[1])
    print(f"  {label}: first differing token at step {t} (got {got[t]} vs "
          f"dense {ref[t]}), top-2 logit gap {gap:.3e}", flush=True)
    check(gap <= 1e-3, f"{label} diverges at step {t} with a top-2 logit "
          f"gap {gap} > 1e-3")
    return gap


def phase_parity(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = make_engine(llama_weights(3, 2), "float32")
    reqs = requests(4, 8)
    cb, greqs, steps, _ = serve(eng, reqs)
    worst = 0.0
    for (p, n), r in zip(reqs, greqs):
        worst = max(worst, tie_gap(torch, eng, p, list(
            cb.finished[r.request_id]), n, f"request {r.request_id}"))
    print(f"  f32 parity: {len(greqs)} requests, {steps} paged steps, CB "
          f"greedy vs dense generate(): largest tie gap at a divergence "
          f"{worst:.3e}", flush=True)
    del eng, cb
    torch.cuda.empty_cache()


def dequantized_weights(eng_q, weights, quant="int4"):
    """Float weights equal to the int4 (or int8) engine's dequantized
    matrices."""
    from paddle_tpu_torch.inference import _PROJECTIONS
    from paddle_tpu_torch.ops.quant_matmul import unpack_int4_blocked
    mm = eng_q._kw["_mm"]
    out = dict(weights)
    for kind, key in _PROJECTIONS:
        mats = []
        for li, pk in enumerate(eng_q._w[key]):
            vals = unpack_int4_blocked(pk, mm.blocks[kind]) \
                if quant == "int4" else pk
            deq = (vals.float() * mm.scales[kind][li][None, :]).cpu().numpy()
            mats.append(deq.T.reshape(weights[key][li].shape)
                        if kind == "qkv" else deq)
        out[key] = mats
    return out


def phase_int4(torch):
    w = llama_weights(5, L)
    eng_q = make_engine(w, "bfloat16", weight_quant="int4")
    check(set(eng_q.quant_routes.values()) == {"kernel"},
          f"int4 engine routes {eng_q.quant_routes}: every flagship width "
          "fits a kernel block")
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


# -- phases 19-20: the serving front door ----------------------------------

GW_NEW = 16             # phase 20's new tokens a request
GRAD_SLACK_BYTES = 64 << 20   # phase 19: two cuBLAS workspaces


async def stream_batch(gates, port, bodies, stepper):
    """Open one SSE stream per body while ``stepper`` is held, so that
    every request lands on one admission pass, then release and read
    every stream to its ``end``. Returns the release time and, per
    stream, (events, the time of its first token frame)."""
    opened = []
    stepper.hold()
    try:
        for body in bodies:
            st, reader, writer = await gates.open_stream(port, body)
            check(st == 200, f"stream {body['request_id']}: HTTP {st}")
            first = await gates.next_sse(reader)
            check(first is not None and first[0] == "accepted",
                  f"stream {body['request_id']} opened with {first}")
            opened.append((reader, writer))
    finally:
        stepper.release()
    t0 = time.perf_counter()

    async def drain(reader, writer):
        events, first = [], None
        while True:
            ev = await gates.next_sse(reader)
            if ev is None:
                break
            if ev[0] == "token" and first is None:
                first = time.perf_counter()
            events.append(ev)
            if ev[0] == "end":
                break
        writer.close()
        return events, first

    return t0, await asyncio.gather(*(drain(r, w) for r, w in opened))


def phase_gateway(torch):
    """Phase 19: the HTTP/SSE gateway and its stepper thread in front of
    the serving flagship (bf16, prefix cache on, an SLO monitor), a real
    asyncio client over TCP on 127.0.0.1."""
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import SLOMonitor
    from paddle_tpu_torch import serving
    from tools import torch_serve_gates as gates
    eng = make_engine(llama_weights(0, L), "bfloat16")
    kw = dict(num_blocks=NUM_BLOCKS, block_size=BS, max_batch=MAX_BATCH,
              prefill_chunk=CHUNK)
    # build and load the kernels and warm cuBLAS on this thread, before
    # any stepper starts: the first request must not carry the build
    serve(eng, requests(99, 2, prompt=(16, 80), new=(2, 4)))
    reqs = requests(1, 12)
    cancel_p, cancel_n = requests(19, 1, prompt=(40, 40), new=(64, 64))[0]
    deadline_p = requests(23, 1, prompt=(200, 200))[0][0]

    # the direct engine: the same held batch, no HTTP in the path
    torch.cuda.reset_peak_memory_stats()
    cb, greqs, d_steps, d_wall = serve(eng, reqs, prefix_cache=True)
    direct_peak = torch.cuda.max_memory_allocated()
    direct = [list(cb.finished[r.request_id]) for r in greqs]
    d_toks = sum(len(t) for t in direct)
    d_ttft = float(np.mean([r.first_token_time - r.submit_time
                            for r in greqs]))
    cb, solo, _, _ = serve(eng, [(cancel_p, cancel_n)], prefix_cache=True)
    cancel_ref = list(cb.finished[solo[0].request_id])
    del cb
    torch.cuda.empty_cache()

    monitor = SLOMonitor.from_config({
        "cadence_s": 1.0,
        "objectives": [{"name": "ttft_p99", "kind": "quantile",
                        "metric": "serve_ttft_seconds", "q": 0.99,
                        "max": 60.0}]})
    cb = ContinuousBatchingEngine(eng, prefix_cache=True, monitor=monitor,
                                  **kw)
    stepper = serving.EngineStepper(cb).start()
    gw = serving.ServingGateway(stepper, monitor=monitor)
    server = gates.GatewayThread(gw).start()
    port = gw.port
    out = {}

    async def traffic():
        # one request through the stepper thread before the counted run
        # (its own cuBLAS handle and workspace)
        code, _ = await gates.request(port, "POST", "/v1/generate", {
            "prompt": [int(t) for t in reqs[0][0][:24]],
            "max_new_tokens": 4, "request_id": "warm", "stream": False})
        check(code == 200, f"warm-up request: HTTP {code}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with counted_steps(eng) as steps:
            bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": n,
                       "request_id": f"gw{j}"}
                      for j, (p, n) in enumerate(reqs)]
            t0, got = await stream_batch(gates, port, bodies, stepper)
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
            out["steps"] = steps[0]
            out["streams"] = got
            out["t0"] = t0
            st, events, del_code = await gates.run_stream(
                port, {"prompt": [int(t) for t in cancel_p],
                       "max_new_tokens": cancel_n, "request_id": "cancel"},
                cancel_after=2)
            out["cancel"] = (st, events, del_code)
            code, body = await gates.request(port, "POST", "/v1/generate", {
                "prompt": [int(t) for t in deadline_p], "max_new_tokens": 8,
                "request_id": "deadline", "deadline_steps": 1,
                "stream": False})
            out["deadline"] = (code, json.loads(body))
            code, body = await gates.request(port, "POST", "/v1/generate", {
                "prompt": [1, 2, 3], "max_new_tokens": 2,
                "request_id": "reject", "spec_k": 4})
            out["reject"] = (code, json.loads(body))
            out["all_steps"] = steps[0]
        out["control"] = await gates.check_control_plane(port)

    try:
        asyncio.run(traffic())
        gw_peak = torch.cuda.max_memory_allocated()
        launches, _ = read_counts()
        baseline = stepper.call(gates.alloc_baseline).result(60)
        grad_recorded = stepper.call(lambda c: any(
            t.requires_grad for t in c.caches)).result(60)
        grad_on = stepper.call(lambda c: torch.is_grad_enabled()).result(60)
        reqs_p = requests(7, 4, new=(16, 16))

        def profiled():
            bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": n,
                       "request_id": f"prof{j}"}
                      for j, (p, n) in enumerate(reqs_p)]
            with counted_steps(eng) as steps:
                asyncio.run(stream_batch(gates, port, bodies, stepper))
            return steps[0]

        profile = profile_window(torch, profiled, "paged steps behind the "
                                 "gateway")
    finally:
        server.close()
        stepper.stop()
    check(stepper.error is None, f"the stepper failed: {stepper.error!r}")

    for j, ((events, _), ref) in enumerate(zip(out["streams"], direct)):
        end = gates.end_event(events)
        check(end is not None and end["status"] == "finished",
              f"stream gw{j} ended {end}")
        check(gates.stream_tokens(events) == ref and end["tokens"] == ref,
              f"stream gw{j}: streamed tokens differ from the direct "
              f"engine's at the same schedule")
    st, events, del_code = out["cancel"]
    end, toks = gates.end_event(events), gates.stream_tokens(events)
    check(st == 200 and del_code == 200 and end is not None
          and end["status"] == "cancelled" and len(toks) >= 2
          and toks == cancel_ref[:len(toks)] and end["tokens"] == toks,
          f"cancel: HTTP {st}, DELETE {del_code}, end {end}, {len(toks)} "
          f"tokens, prefix of the solo run {toks == cancel_ref[:len(toks)]}")
    code, body = out["deadline"]
    check(code == 504 and body["status"] == "deadline_exceeded"
          and body["tokens"] == [], f"deadline: HTTP {code} {body}")
    code, body = out["reject"]
    check(code == 422 and body["reason"] == "spec_k_exceeds_engine",
          f"spec_k wider than the engine: HTTP {code} {body}")
    check(all(out["control"].values()),
          f"control plane: {out['control']}")
    check(baseline, "the KV / refcount gauges are not back at baseline")
    check(launches == L * out["all_steps"],
          f"ragged kernel launched {launches} times behind the gateway in "
          f"{out['all_steps']} paged steps (want {L * out['all_steps']})")
    check(not grad_recorded, "the stepper thread's caches require grad")
    # grad mode is on in the stepper thread (it is thread-local); graphs
    # recorded there would hold every step's activations. What may differ
    # is the thread's own cuBLAS workspace (32 MiB on this card).
    check(gw_peak <= direct_peak + GRAD_SLACK_BYTES,
          f"peak memory behind the gateway {gw_peak} B against "
          f"{direct_peak} B direct")
    toks = sum(len(gates.stream_tokens(e)) for e, _ in out["streams"])
    ttft = float(np.mean([f - out["t0"] for _, f in out["streams"]]))
    stats = {
        "gateway": {"tokens": toks, "steps": out["steps"],
                    "tokens_per_s": toks / out["wall"],
                    "ms_per_step": out["wall"] / out["steps"] * 1e3,
                    "mean_ttft_s": ttft},
        "direct": {"tokens": d_toks, "steps": d_steps,
                   "tokens_per_s": d_toks / d_wall,
                   "ms_per_step": d_wall / d_steps * 1e3,
                   "mean_ttft_s": d_ttft},
        "attn_launches": launches, "counted_steps": out["all_steps"],
        "cancel_tokens": len(gates.stream_tokens(out["cancel"][1])),
        "peak_memory_gb": gw_peak / 1e9,
        "direct_peak_memory_gb": direct_peak / 1e9,
        "stepper_grad_enabled": grad_on, "profile": profile,
    }
    g, d = stats["gateway"], stats["direct"]
    print(f"  12 held streams through the gateway: {g['tokens']} tokens in "
          f"{g['steps']} paged steps, {g['tokens_per_s']:.1f} tokens/s, "
          f"{g['ms_per_step']:.2f} ms/step, mean TTFT "
          f"{g['mean_ttft_s'] * 1e3:.1f} ms", flush=True)
    print(f"  the same batch, direct engine: {d['tokens']} tokens in "
          f"{d['steps']} paged steps, {d['tokens_per_s']:.1f} tokens/s, "
          f"{d['ms_per_step']:.2f} ms/step, mean TTFT "
          f"{d['mean_ttft_s'] * 1e3:.1f} ms", flush=True)
    print(f"  streamed tokens equal the direct engine's; cancel after 2 "
          f"events: {stats['cancel_tokens']} tokens, a prefix of the solo "
          f"run; deadline 504; spec_k 4 -> 422; ragged kernel launches "
          f"{launches} = {L} x {out['all_steps']} steps; peak memory "
          f"{stats['peak_memory_gb']:.3f} GB vs "
          f"{stats['direct_peak_memory_gb']:.3f} GB direct (stepper grad "
          f"mode {grad_on}, no cache requires grad)", flush=True)
    if profile.get("device_ms_by_class"):
        stats["ragged_device_ms_per_step"] = profile["device_ms_by_class"].get(
            "ragged_attention", 0.0) / profile["steps"]
        print(f"  ragged kernel device time behind the gateway: "
              f"{stats['ragged_device_ms_per_step']:.4f} ms per paged step",
              flush=True)
    del eng, cb
    torch.cuda.empty_cache()
    return stats


def router_families():
    """Phase 20's workload: 4 prompt families x 3 nested resumes, each
    family's resumes sharing its first 128 tokens (resume r is 128 + 64 r
    + 5 tokens long), and each later round's families in a seeded order
    (arrivals interleave; in pool order, round robin over 2 replicas
    would meet each family's replica by accident)."""
    from tools.torch_serve_gates import family_prompts
    prompts = family_prompts(np.random.default_rng(20), V, 4, 3, 128, 64, 5)
    rng = np.random.default_rng(21)
    orders = {r: [int(m) for m in rng.permutation(4)] for r in (1, 2)}
    return prompts, orders


def run_pool(torch, engines, policy, prompts, orders, tag):
    """One fresh pool (a ContinuousBatchingEngine and a stepper per
    engine, prefix cache on) behind EngineRouter, one wave of the
    workload. Returns (the Subs, paged steps per replica, wall seconds,
    the cache stats per replica)."""
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch import serving
    from tools import torch_serve_gates as gates
    steppers = [serving.EngineStepper(ContinuousBatchingEngine(
        e, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=MAX_BATCH,
        prefill_chunk=CHUNK, prefix_cache=True), name=f"replica-{i}")
        for i, e in enumerate(engines)]
    router = serving.EngineRouter(steppers, policy=policy).start()
    try:
        with contextlib.ExitStack() as stack:
            counts = [stack.enter_context(counted_steps(e))
                      for e in engines]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            subs = gates.run_wave(router, prompts, 4, 3, GW_NEW,
                                  lambda m, r: f"{tag}.{policy}.f{m}r{r}",
                                  order=orders.get)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for key, sub in subs.items():
            check(sub.end is not None and sub.end["status"] == "finished"
                  and len(sub.tokens) == GW_NEW,
                  f"{policy} {key}: ended {sub.end}")
        stats = [s.call(lambda c: dict(c.cache_stats)).result(60)
                 for s in steppers]
        for i, s in enumerate(steppers):
            check(s.call(gates.alloc_baseline).result(60),
                  f"{policy}: replica {i}'s blocks are not back")
        check(router.error is None and all(s.error is None
                                           for s in steppers),
              f"{policy}: a stepper failed")
    finally:
        router.stop()
    return subs, [c[0] for c in counts], wall, stats


def phase_router(torch):
    """Phase 20: two flagship replicas on the card behind EngineRouter,
    each with its own stepper, under every policy; a replica crash; the
    f32 pool's tokens under phase 3's rule."""
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch import serving
    from tools import torch_serve_gates as gates
    w = llama_weights(0, L)
    engines = [make_engine(w, "bfloat16") for _ in range(2)]
    del w
    for e in engines:       # build and warm on this thread first
        serve(e, requests(99, 2, prompt=(16, 80), new=(2, 4)))
    prompts, orders = router_families()
    total_prompt = sum(len(p) for p in prompts.values())
    rows = {}
    for policy in ("round_robin", "least_loaded", "prefix_affinity"):
        reset_counts()
        subs, steps, wall, stats = run_pool(torch, engines, policy, prompts,
                                            orders, "bf16")
        launches, _ = read_counts()
        check(launches == L * sum(steps),
              f"{policy}: ragged kernel launched {launches} times in "
              f"{steps} paged steps (want {L * sum(steps)})")
        cached = sum(s["hit_blocks"] for s in stats) * BS
        toks = sum(len(s.tokens) for s in subs.values())
        rows[policy] = {"tokens_per_s": toks / wall, "wall_s": wall,
                        "steps": steps, "attn_launches": launches,
                        "cached_prefix_tokens": cached,
                        "prefill_sweep_tokens": total_prompt - cached}
        print(f"  {policy}: {toks} tokens in {wall:.3f} s, "
              f"{toks / wall:.1f} tokens/s for the pool, paged steps "
              f"{steps}, ragged launches {launches} = {L} x {sum(steps)}; "
              f"cached prefix {cached} tokens, prefill sweep "
              f"{total_prompt - cached}", flush=True)
    aff, rr = rows["prefix_affinity"], rows["round_robin"]
    check(aff["cached_prefix_tokens"] > rr["cached_prefix_tokens"]
          and aff["prefill_sweep_tokens"] < rr["prefill_sweep_tokens"],
          f"prefix affinity {aff} does not beat round robin {rr}")

    # a crash: replica 0's step() raises with a request queued on it
    steppers = [serving.EngineStepper(ContinuousBatchingEngine(
        e, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=MAX_BATCH,
        prefill_chunk=CHUNK), name=f"crash-replica-{i}")
        for i, e in enumerate(engines)]
    router = serving.EngineRouter(steppers, policy="round_robin").start()
    rng = np.random.default_rng(22)
    cprompts = {k: [int(t) for t in rng.integers(1, V, n)]
                for k, n in (("stream", 48), ("bystander", 96),
                             ("victim", 160), ("post", 64))}
    news = {"stream": 64, "bystander": 8, "victim": 8, "post": 8}
    try:
        subs, _, target, post = gates.crash_scenario(
            router, cprompts, news, tracing.get_tracer())
        live = router.live_replicas()
        masked = router.error is None and steppers[0].error is not None
    finally:
        router.stop()
    a, c, d = subs["stream"], subs["victim"], subs["post"]
    check(a.end["status"] == "failed" and a.end["reason"] == "engine_error"
          and len(a.tokens) >= 1, f"crashed stream ended {a.end}")
    check(c.end["status"] == "finished" and len(c.tokens) == 8
          and target == 1, f"victim ended {c.end} after a resubmit to "
          f"replica {target}")
    check(d.end["status"] == "finished" and post == 1 and live == [1],
          f"post-crash submit routed to {post}, live {live}")
    check(masked, "the pool's error is not masked by the survivor")
    print(f"  crash: replica 0's stream failed (engine_error) after "
          f"{len(a.tokens)} token(s), its queued request resubmitted to "
          f"replica {target} and finished, the next submit routed to "
          f"replica {post}; live {live}", flush=True)
    del engines, steppers, router
    torch.cuda.empty_cache()

    # f32 tokens under every policy against one engine's dense generate()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = llama_weights(3, 2)
    engines = [make_engine(w, "float32") for _ in range(2)]
    worst = 0.0
    for policy in ("round_robin", "least_loaded", "prefix_affinity"):
        subs, steps, _, _ = run_pool(torch, engines, policy, prompts,
                                     orders, "f32")
        for (m, r), sub in subs.items():
            worst = max(worst, tie_gap(torch, engines[0], prompts[(m, r)],
                                       sub.tokens, GW_NEW,
                                       f"f32 {policy} f{m}r{r}"))
    print(f"  f32 pools (L=2): every policy's tokens equal one engine's "
          f"dense generate(), largest tie gap at a divergence "
          f"{worst:.3e}", flush=True)
    del engines
    torch.cuda.empty_cache()
    return {"policies": rows, "crash": {
        "streamed_tokens": len(a.tokens), "resubmit_target": target,
        "post_route": post}, "f32_worst_tie_gap": worst}


# -- phases 5-8: flash attention and training ------------------------------

FLASH_O_ATOL = 1e-5     # o: f32 summation noise; on top of it each
                        # element may differ by 2**-8 * (p @ |v|) / l, the
                        # bound of rounding every p to bf16 at the running
                        # max of a 64-key tile (kernel) and at the row's
                        # final max (plain version), half an ulp each
FLASH_GRAD_ATOL = 1e-4  # dq/dk/dv: same p, dp and ds to f32 rounding,
                        # summed in another order (dq with atomics)
LSE_ATOL = 1e-4         # lse in f32: the same row sums in another order
TRAIN_RTOL = 1e-4       # f32 loss / grad norm, kernels vs plain attention


def flash_grad_rounding(torch, fa, q, k, v, o, lse, do, scale, causal,
                        cos=None, sin=None):
    """(dq, dk, dv) terms of the gradient allowance for the rounding of p
    and ds to the input dtype, which both the kernel and the plain version
    do, from f32 values that agree only to f32 rounding.

    The two reach p and ds by different routes. q k^T and do v^T sum D
    exact products of 16-bit values in another order: each side is within
    2 D u sum |q_d k_d| of the exact dot (u = 2**-24; the tensor cores
    truncate, so 2 D u; f32 summation in any order, D u), 4 D u together
    with a unit of slack. delta sums do o in f32 on either side (2 D u sum
    |do o|). Each side rounds s * scale - lse (or fuses it), exp (2 ulps),
    dp - delta and the two products of ds on its own. That bounds
    |p_kernel - p_plain| by w_p and |ds_kernel - ds_plain| by w_ds per
    element. Rounding is monotone, so two values within w of x round to
    values at most round(x + w) - round(x - w) apart: zero unless a
    rounding boundary lies within w of x, then one ulp (up to 2**-7 |x|).
    Each gradient may differ by those flips times its other operand:
    flip(ds) |k|, flip(ds)^T |q|, flip(p)^T |do|. With rope, over the
    rotated q and k; the f32 counter-rotation mixes the two halves of a
    row, so each half gets the sum of both. Computed over slices of BH
    that keep each [BH, Sq, Sk] f32 temporary near 256 MiB."""
    if cos is not None:
        q, k = fa._rope(q, cos, sin), fa._rope(k, cos, sin)
    bh, sq, d = q.shape
    sk = k.shape[1]
    u = 2.0 ** -24
    dot_err = 4 * d * u
    vis = fa._visible(sq, sk, causal, q.device)

    def flip(x, w):
        return (x + w).to(q.dtype).float() - (x - w).to(q.dtype).float()

    parts = ([], [], [])
    step = max(1, (1 << 26) // (sq * sk))
    for b in range(0, bh, step):
        qf, kf, vf, dof, of = (t[b:b + step].float()
                               for t in (q, k, v, do, o))
        lse_b = lse[b:b + step, :, None]
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        w_arg = torch.matmul(qf.abs(), kf.abs().transpose(1, 2)) \
            * (scale * dot_err) + 4 * u * (s.abs() + lse_b.abs())
        p = torch.exp(s - lse_b)
        del s
        if vis is not None:
            p = p * vis
        w_p = p * (torch.expm1(w_arg) + 8 * u)
        del w_arg
        dodo = dof * of
        x = torch.matmul(dof, vf.transpose(1, 2)) - dodo.sum(-1, keepdim=True)
        w_x = torch.matmul(dof.abs(), vf.abs().transpose(1, 2)) * dot_err \
            + dodo.abs().sum(-1, keepdim=True) * (2 * d * u) + 4 * u * x.abs()
        ds = p * x * scale
        w_ds = scale * (w_p * (x.abs() + w_x) + p * w_x) + 8 * u * ds.abs()
        del x, w_x, dodo
        flip_p = flip(p, w_p)
        del p, w_p
        flip_ds = flip(ds, w_ds)
        del ds, w_ds
        parts[0].append(torch.matmul(flip_ds, kf.abs()))
        parts[1].append(torch.matmul(flip_ds.transpose(1, 2), qf.abs()))
        parts[2].append(torch.matmul(flip_p.transpose(1, 2), dof.abs()))
        del flip_p, flip_ds
    dq, dk, dv = (torch.cat(t) for t in parts)
    if cos is not None:
        def both(x):
            half = x.shape[-1] // 2
            t = x[..., :half] + x[..., half:]
            return torch.cat([t, t], dim=-1)
        dq, dk = both(dq), both(dk)
    return dq, dk, dv


@contextlib.contextmanager
def plain_attention():
    """Route the flash autograd function through the plain versions on the
    card (the reference path of phases 6 and 8); restores the kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa
    saved = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = saved


@contextlib.contextmanager
def plain_ce():
    """Route the blockwise cross entropy through the plain versions on the
    card (the reference path of phase 12); restores the kernels."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    saved = bc.ce_fwd, bc.ce_bwd_dh, bc.ce_bwd_dw
    bc.ce_fwd, bc.ce_bwd_dh, bc.ce_bwd_dw = (
        bc.ce_fwd_plain, bc.ce_bwd_dh_plain, bc.ce_bwd_dw_plain)
    try:
        yield
    finally:
        bc.ce_fwd, bc.ce_bwd_dh, bc.ce_bwd_dw = saved


@contextlib.contextmanager
def plain_fused():
    """Route the fused tier (norm, SwiGLU, token cross entropy, AdamW)
    through its plain versions on the card (the reference path of phases 8
    and 12); restores the kernels."""
    from paddle_tpu_torch.ops import adamw, fused_norm, swiglu, token_ce
    swaps = ((fused_norm, "rms_norm_fwd"), (fused_norm, "rms_norm_bwd"),
             (swiglu, "swiglu_fwd"), (swiglu, "swiglu_bwd"),
             (token_ce, "token_ce_fwd"), (token_ce, "token_ce_bwd"),
             (adamw, "adamw_step"))
    saved = [(mod, name, getattr(mod, name)) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def flash_work(bh, sq, sk, d, causal):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) a bf16 case's data
    needs (``ops.work.flash_fwd`` / ``flash_bwd``): each input read once
    and each output written once; 4*D flops per visible (row, key) pair
    forward (two products), 10*D backward (five)."""
    from paddle_tpu_torch.ops import work
    return work.flash_fwd(bh, sq, sk, d, causal) + \
        work.flash_bwd(bh, sq, sk, d, causal)


def flash_cases(torch, seed=21):
    """(name, q, k, v, do, causal) at [BH, S, D] in bf16; the GQA case is
    folded as flash_attention_bshd folds it (kv heads repeated)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def bshd(b, s, h, d):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=gen).bfloat16()

    def fold(x, rep=1):
        b, s, h, d = x.shape
        x = torch.repeat_interleave(x, rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).reshape(b * h * rep, s, d).contiguous()

    cases = []
    for name, b, s, h, kvh, d, causal in (
            ("flagship_b8_s2048_h16_d64", 8, 2048, 16, 16, 64, True),
            # a rank's shard of phase 26 (a): B / (dp fsdp), H / mp
            ("rank_shard_b4_s2048_h8_d64", 4, 2048, 8, 8, 64, True),
            ("entry_b4_s128_h8_kvh4_d32", 4, 128, 8, 4, 32, True),
            ("off_tile_b2_s2000_h16_d64", 2, 2000, 16, 16, 64, True),
            ("full_b2_s1000_h8_d128", 2, 1000, 8, 8, 128, False)):
        rep = h // kvh
        q, k, v, do = bshd(b, s, h, d), bshd(b, s, kvh, d), \
            bshd(b, s, kvh, d), bshd(b, s, h, d)
        cases.append((name, fold(q), fold(k, rep), fold(v, rep), fold(do),
                      causal))
    return cases


def phase_flash(torch):
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import flash_attention as fa
    rows = {"fwd": [], "bwd": []}
    for name, q, k, v, do, causal in flash_cases(torch):
        bh, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal)
        grads = fa.flash_bwd(q, k, v, ro, rlse, do, scale, causal)
        refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse) + tuple(grads))
        p_abs_v = fa.flash_fwd_plain(q, k, v.abs(), scale, causal)[0]
        err_o, ratio_o = bf16_agreement(o, ro, FLASH_O_ATOL,
                                        2.0 ** -8 * p_abs_v.float())
        err_l = float((lse - rlse).abs().max())
        gerr, gratio, worst = 0.0, 0.0, "dq"
        extras = flash_grad_rounding(torch, fa, q, k, v, ro, rlse, do, scale,
                                     causal)
        for gname, g, r, x in zip(("dq", "dk", "dv"), grads, refs, extras):
            e, ratio = bf16_agreement(g, r, FLASH_GRAD_ATOL, x)
            if ratio >= gratio:
                worst = gname
            gerr, gratio = max(gerr, e), max(gratio, ratio)
        print(f"  flash[{name}]: fwd o err {err_o:.3e} (worst {ratio_o:.3f} "
              f"of its allowance: atol {FLASH_O_ATOL:g} + 2**-8 (p @ |v|) / l "
              f"+ 2 bf16 ulps), lse err {err_l:.2e}; bwd err {gerr:.3e} "
              f"(worst {gratio:.3f}, in {worst}, of atol {FLASH_GRAD_ATOL:g} "
              f"+ flips of p, ds + 2 bf16 ulps)", flush=True)
        check(finite, f"flash {name}: non-finite output")
        check(ratio_o <= 1.0, f"flash fwd {name}: o max abs err {err_o}, an "
              f"element off by {ratio_o:.2f}x its allowance")
        check(err_l <= LSE_ATOL, f"flash fwd {name}: lse err {err_l}")
        check(gratio <= 1.0, f"flash bwd {name}: {worst} max abs err {gerr},"
              f" an element off by {gratio:.2f}x its allowance")
        del p_abs_v, extras
        big = bh * s >= 65536
        it = 10 if big else 25
        ms_f = time_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), iters=it)
        ms_b = time_ms(lambda: fa.flash_bwd(q, k, v, ro, rlse, do, scale,
                                            causal), iters=it)
        pl_f = time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale, causal),
                       iters=5 if big else 20)
        pl_b = time_ms(lambda: fa.flash_bwd_plain(q, k, v, ro, rlse, do,
                                                  scale, causal),
                       iters=5 if big else 20)
        # library yardstick (timed only; the port never calls it): SDPA on
        # the same [B*H, 1, S, D] data, forward and forward + backward
        q4, k4, v4, do4 = (x[:, None] for x in (q, k, v, do))
        lib_f = time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters=it)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4)]

        def sdpa_fb():
            out = Fn.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                  scale=scale)
            torch.autograd.grad(out, leaves, do4)

        lib_fb = time_ms(sdpa_fb, iters=it)
        fb, ff, bb, bf = flash_work(bh, s, s, d, causal)
        bf_ms, bf_by = bound(fb, ff)
        bb_ms, bb_by = bound(bb, bf)
        rows["fwd"].append(dict(
            case=name, max_abs_err=err_o, lse_err=err_l, atol=FLASH_O_ATOL,
            worst_err_over_allowed=ratio_o, ms=ms_f, plain_ms=pl_f,
            bound_ms=bf_ms, bound_by=bf_by, library_ms=lib_f,
            tflops=ff / ms_f / 1e9))
        rows["bwd"].append(dict(
            case=name, max_abs_err=gerr, atol=FLASH_GRAD_ATOL,
            worst_err_over_allowed=gratio, ms=ms_b, plain_ms=pl_b,
            bound_ms=bb_ms, bound_by=bb_by, library_ms=lib_fb - lib_f,
            sdpa_fwd_bwd_ms=lib_fb, tflops=bf / ms_b / 1e9))
        print(f"    fwd kernel {ms_f:.4f} ms ({ff / ms_f / 1e9:.2f} TFLOP/s) "
              f"plain {pl_f:.4f} ms bound {bf_ms:.4f} ms ({bf_by}) sdpa "
              f"{lib_f:.4f} ms; bwd kernel {ms_b:.4f} ms "
              f"({bf / ms_b / 1e9:.2f} TFLOP/s) plain {pl_b:.4f} ms bound "
              f"{bb_ms:.4f} ms ({bb_by}) sdpa fwd+bwd {lib_fb:.4f} ms",
              flush=True)
        del q, k, v, do, o, lse, ro, rlse, grads, refs, leaves
        torch.cuda.empty_cache()
    return rows


CE_LOSS_ATOL = 1e-4     # loss / lse in f32: the same H-deep logits and the
                        # V-term softmax sum taken in another order
CE_GRAD_ATOL = 1e-5     # dh / dw: f32 sums of the same products in another
                        # order, then each side rounds to bf16 once (the
                        # two bf16 ulps of bf16_agreement)


def ce_cases(torch, seed=31):
    """(name, h, w, labels, g) in bf16 at the LM head's shapes: h of unit
    RMS as the final norm gives it, w as the model initialises it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = []
    for name, t, hid, vocab, ignored in (
            ("flagship_t16384_h1024_v32000", 16384, 1024, 32000, 0.0),
            ("off_tile_t1000_h1024_v32001", 1000, 1024, 32001, 0.1),
            ("quarter_ignored_t2048_h1024_v32000", 2048, 1024, 32000, 0.25)):
        h = torch.randn(t, hid, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(hid, vocab, device="cuda", generator=gen)
             * 0.02).bfloat16()
        lab = torch.randint(0, vocab, (t,), device="cuda", generator=gen)
        drop = torch.rand(t, device="cuda", generator=gen) < ignored
        lab = torch.where(drop, torch.full_like(lab, -100), lab)
        g = torch.ones(t, device="cuda")
        cases.append((name, h, w, lab, g))
    return cases


def ce_work(t, t_live, hid, vocab):
    """(fwd bytes, fwd flops, dh bytes, backward flops, dw bytes) a bf16
    case needs (``ops.work.blockwise_ce``): inputs read once, outputs
    written once; the forward's 2 T H V flops (every row's lse is an
    output), each backward kernel's 4 H V flops per row that is not
    ignored (an ignored row's gradient is zero)."""
    from paddle_tpu_torch.ops import work
    w = work.blockwise_ce(t, t_live, hid, vocab)
    return w["fwd"] + w["dh"][:1] + w["dh"][1:] + w["dw"][:1]


def phase_ce(torch):
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import blockwise_ce as bc
    rows = {"fwd": [], "dh": [], "dw": []}
    for name, h, w, lab, g in ce_cases(torch):
        t, hid = h.shape
        vocab = w.shape[1]
        loss, lse = bc.ce_fwd(h, w, lab, -100)
        rloss, rlse = bc.ce_fwd_plain(h, w, lab, -100)
        dh = bc.ce_bwd_dh(h, w, lab, g, rlse, -100)
        rdh = bc.ce_bwd_dh_plain(h, w, lab, g, rlse, -100)
        dw = bc.ce_bwd_dw(h, w, lab, g, rlse, -100)
        rdw = bc.ce_bwd_dw_plain(h, w, lab, g, rlse, -100)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(x).all())
                     for x in (loss, lse, dh, dw))
        err_f = max(float((loss - rloss).abs().max()),
                    float((lse - rlse).abs().max()))
        ratio_f = err_f / CE_LOSS_ATOL
        err_dh, ratio_dh = bf16_agreement(dh, rdh, CE_GRAD_ATOL)
        err_dw, ratio_dw = bf16_agreement(dw, rdw, CE_GRAD_ATOL)
        ign = lab == -100
        n_ign = int(ign.sum())
        zero_ign = not bool(loss[ign].any()) and not bool(dh[ign].any())
        plan = bc.bwd_plan(t, hid, vocab)
        print(f"  blockwise_ce[{name}] backward plan: route "
              f"{bc.ce_bwd_dh.route} / {bc.ce_bwd_dw.route}, clusters of "
              f"C={plan['cluster']} blocks, slice S={plan['slice']} "
              f"({plan['panels']} panel(s) of 128, {plan['groups']} "
              f"group(s)), tile {plan['tile_tokens']} tokens x "
              f"{plan['tile_vocab']} vocab; dh {plan['dh_clusters']} / dw "
              f"{plan['dw_clusters']} clusters, {plan['dh_smem_bytes']} / "
              f"{plan['dw_smem_bytes']} B shared memory a block, "
              f"{plan['dh_max_active_clusters']} / "
              f"{plan['dw_max_active_clusters']} clusters resident, "
              f"{plan['dh_busy_sms']} / {plan['dw_busy_sms']} SMs busy",
              flush=True)
        print(f"  blockwise_ce[{name}]: {n_ign} rows ignored; loss/lse err "
              f"{err_f:.3e} (worst {ratio_f:.3f} of atol {CE_LOSS_ATOL:g}), "
              f"dh err {err_dh:.3e} (worst {ratio_dh:.3f}), dw err "
              f"{err_dw:.3e} (worst {ratio_dw:.3f}) of atol "
              f"{CE_GRAD_ATOL:g} + 2 bf16 ulps", flush=True)
        check(finite, f"blockwise_ce {name}: non-finite output")
        check(zero_ign, f"blockwise_ce {name}: an ignored row has a loss or "
              "a gradient")
        check(ratio_f <= 1.0, f"blockwise_ce fwd {name}: err {err_f}")
        check(ratio_dh <= 1.0, f"blockwise_ce dh {name}: err {err_dh}, an "
              f"element off by {ratio_dh:.2f}x its allowance")
        check(ratio_dw <= 1.0, f"blockwise_ce dw {name}: err {err_dw}, an "
              f"element off by {ratio_dw:.2f}x its allowance")
        del rloss, rlse, rdh, rdw
        big = t >= 8192
        it, pit = (5, 3) if big else (10, 5)
        ms_f = time_ms(lambda: bc.ce_fwd(h, w, lab, -100), iters=it, warmup=1)
        dev_f = device_time_ms(lambda: bc.ce_fwd(h, w, lab, -100),
                               iters=2 * it)
        fplan = bc.fwd_plan(t, hid, vocab, h.dtype)
        print(f"    fwd route {bc.ce_fwd.route} ({fplan['splits']} vocab "
              f"splits of {fplan['tiles_per_split']} tiles of "
              f"{fplan['tile_tokens']} x {fplan['tile_vocab']}, "
              f"{fplan['stages']} stages, {fplan['blocks']} blocks, "
              f"{fplan['w_copy_bytes'] + fplan['h_copy_bytes']} bytes "
              f"copied to padded rows): device {dev_f:.4f} ms, "
              f"{2 * t * hid * vocab / dev_f / 1e9:.1f} TFLOP/s", flush=True)
        ms_dh = time_ms(lambda: bc.ce_bwd_dh(h, w, lab, g, lse, -100),
                        iters=it, warmup=1)
        ms_dw = time_ms(lambda: bc.ce_bwd_dw(h, w, lab, g, lse, -100),
                        iters=it, warmup=1)
        pl_f = time_ms(lambda: bc.ce_fwd_plain(h, w, lab, -100), iters=pit,
                       warmup=1)
        pl_dh = time_ms(lambda: bc.ce_bwd_dh_plain(h, w, lab, g, lse, -100),
                        iters=pit, warmup=1)
        pl_dw = time_ms(lambda: bc.ce_bwd_dw_plain(h, w, lab, g, lse, -100),
                        iters=pit, warmup=1)
        # library yardstick (timed only; the port never calls it): the
        # unfused pair, bf16 logits through cuBLAS then cross_entropy;
        # forward, and forward + the gradient of h (of w) alone
        hl, wl = (x.detach().clone().requires_grad_(True) for x in (h, w))

        def lib(wrt=None):
            out = Fn.cross_entropy(torch.matmul(hl, wl), lab,
                                   reduction="none", ignore_index=-100)
            if wrt is not None:
                torch.autograd.grad(out, [wrt], g)

        with torch.no_grad():
            lib_f = time_ms(lib, iters=it, warmup=1)
        lib_fdh = time_ms(lambda: lib(hl), iters=it, warmup=1)
        lib_fdw = time_ms(lambda: lib(wl), iters=it, warmup=1)
        with torch.no_grad():
            lib_dev_f = device_time_ms(lib, iters=2 * it)
        del hl, wl
        fb, ff, dhb, bf, dwb = ce_work(t, t - n_ign, hid, vocab)
        b_f = bound(fb, ff)
        b_dh = bound(dhb, bf)
        b_dw = bound(dwb, bf)
        for key, err, ratio, ms, pl, (b_ms, b_by), lib_ms, flops in (
                ("fwd", err_f, ratio_f, ms_f, pl_f, b_f, lib_f, ff),
                ("dh", err_dh, ratio_dh, ms_dh, pl_dh, b_dh, lib_fdh - lib_f,
                 bf),
                ("dw", err_dw, ratio_dw, ms_dw, pl_dw, b_dw, lib_fdw - lib_f,
                 bf)):
            rows[key].append(dict(
                case=name, max_abs_err=err, worst_err_over_allowed=ratio,
                atol=CE_LOSS_ATOL if key == "fwd" else CE_GRAD_ATOL, ms=ms,
                plain_ms=pl, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                tflops=flops / ms / 1e9))
            if key == "fwd":
                rows[key][-1].update(device_ms=dev_f, route=bc.ce_fwd.route,
                                     plan=fplan, library_device_ms=lib_dev_f)
            # the backward executes twice the bound's work: the logits and
            # the three split products of the contraction (8 T' H V)
            done = "" if key == "fwd" else \
                f", {2 * flops / ms / 1e9:.2f} TFLOP/s executed"
            print(f"    {key}: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
                  f"TFLOP/s of the bound's work{done}) plain {pl:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}) matmul+cross_entropy "
                  f"{lib_ms:.4f} ms", flush=True)
        print(f"    unfused matmul + cross_entropy: forward {lib_f:.4f} ms "
              f"(device {lib_dev_f:.4f} ms), + dh {lib_fdh:.4f} ms, + dw "
              f"{lib_fdw:.4f} ms", flush=True)
        del h, w, lab, g, loss, lse, dh, dw
        torch.cuda.empty_cache()
    return rows


def rope_flash_cases(torch, seed=41):
    """(name, q, k, v, do, causal, cos, sin) at [BH, S, D] in bf16 with the
    model's [S, D/2] f32 tables; the GQA case folded as
    flash_attention_bshd folds it."""
    from paddle_tpu_torch.nn.functional import rotary_embedding_cos_sin
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def bshd(b, s, h, d):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=gen).bfloat16()

    def fold(x, rep=1):
        b, s, h, d = x.shape
        x = torch.repeat_interleave(x, rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).reshape(b * h * rep, s, d).contiguous()

    cases = []
    for name, b, s, h, kvh, d in (
            ("rope_flagship_b8_s2048_h16_d64", 8, 2048, 16, 16, 64),
            ("rope_gqa_b4_s512_h16_kvh4_d64", 4, 512, 16, 4, 64),
            ("rope_off_tile_b2_s2000_h16_d64", 2, 2000, 16, 16, 64)):
        rep = h // kvh
        q, k, v, do = bshd(b, s, h, d), bshd(b, s, kvh, d), \
            bshd(b, s, kvh, d), bshd(b, s, h, d)
        cos, sin = rotary_embedding_cos_sin(s, d, device="cuda")
        cases.append((name, fold(q), fold(k, rep), fold(v, rep), fold(do),
                      True, cos, sin))
    return cases


def phase_flash_rope(torch):
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import flash_attention as fa
    rows = {"fwd": [], "bwd": []}
    for name, q, k, v, do, causal, cos, sin in rope_flash_cases(torch):
        bh, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        rope = (cos, sin)
        o, lse = fa.flash_fwd(q, k, v, scale, causal, *rope)
        ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal, *rope)
        grads = fa.flash_bwd(q, k, v, ro, rlse, do, scale, causal, *rope)
        refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal, *rope)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, lse) + tuple(grads))
        p_abs_v = fa.flash_fwd_plain(q, k, v.abs(), scale, causal, *rope)[0]
        err_o, ratio_o = bf16_agreement(o, ro, FLASH_O_ATOL,
                                        2.0 ** -8 * p_abs_v.float())
        err_l = float((lse - rlse).abs().max())
        gerr, gratio, worst = 0.0, 0.0, "dq"
        extras = flash_grad_rounding(torch, fa, q, k, v, ro, rlse, do, scale,
                                     causal, *rope)
        for gname, g, r, x in zip(("dq", "dk", "dv"), grads, refs, extras):
            e, ratio = bf16_agreement(g, r, FLASH_GRAD_ATOL, x)
            if ratio >= gratio:
                worst = gname
            gerr, gratio = max(gerr, e), max(gratio, ratio)
        print(f"  flash+rope[{name}]: fwd o err {err_o:.3e} (worst "
              f"{ratio_o:.3f} of its allowance), lse err {err_l:.2e}; bwd "
              f"err {gerr:.3e} (worst {gratio:.3f}, in {worst}, of atol "
              f"{FLASH_GRAD_ATOL:g} + flips of p, ds + 2 bf16 ulps)",
              flush=True)
        check(finite, f"flash+rope {name}: non-finite output")
        check(ratio_o <= 1.0, f"flash+rope fwd {name}: o max abs err {err_o}, "
              f"an element off by {ratio_o:.2f}x its allowance")
        check(err_l <= LSE_ATOL, f"flash+rope fwd {name}: lse err {err_l}")
        check(gratio <= 1.0, f"flash+rope bwd {name}: {worst} max abs err "
              f"{gerr}, an element off by {gratio:.2f}x its allowance")
        del p_abs_v, extras
        big = bh * s >= 65536
        it = 10 if big else 25
        ms_f = time_ms(lambda: fa.flash_fwd(q, k, v, scale, causal, *rope),
                       iters=it)
        ms_b = time_ms(lambda: fa.flash_bwd(q, k, v, ro, rlse, do, scale,
                                            causal, *rope), iters=it)
        # the same shapes without rope, in the same run: what rope costs
        ms_f0 = time_ms(lambda: fa.flash_fwd(q, k, v, scale, causal),
                        iters=it)
        ms_b0 = time_ms(lambda: fa.flash_bwd(q, k, v, ro, rlse, do, scale,
                                             causal), iters=it)
        pl_f = time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale, causal,
                                                  *rope),
                       iters=5 if big else 20)
        pl_b = time_ms(lambda: fa.flash_bwd_plain(q, k, v, ro, rlse, do,
                                                  scale, causal, *rope),
                       iters=5 if big else 20)
        # library yardstick (timed only): SDPA on the same q, k, v; no one
        # PyTorch call applies rope inside attention
        q4, k4, v4, do4 = (x[:, None] for x in (q, k, v, do))
        lib_f = time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters=it)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4)]

        def sdpa_fb():
            out = Fn.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                  scale=scale)
            torch.autograd.grad(out, leaves, do4)

        lib_fb = time_ms(sdpa_fb, iters=it)
        fb, ff, bb, bf = flash_work(bh, s, s, d, causal)
        tab = 2 * s * (d // 2) * 4                  # the two f32 tables
        rot = 3 * d * bh * 2 * s                    # 6 ops per (row, pair)
        bf_ms, bf_by = bound(fb + tab, ff + rot)
        bb_ms, bb_by = bound(bb + tab, bf + 2 * rot)
        rows["fwd"].append(dict(
            case=name, rope=True, max_abs_err=err_o, lse_err=err_l,
            atol=FLASH_O_ATOL, worst_err_over_allowed=ratio_o, ms=ms_f,
            ms_without_rope=ms_f0, plain_ms=pl_f, bound_ms=bf_ms,
            bound_by=bf_by, library_ms=lib_f, tflops=ff / ms_f / 1e9))
        rows["bwd"].append(dict(
            case=name, rope=True, max_abs_err=gerr, atol=FLASH_GRAD_ATOL,
            worst_err_over_allowed=gratio, ms=ms_b, ms_without_rope=ms_b0,
            plain_ms=pl_b, bound_ms=bb_ms, bound_by=bb_by,
            library_ms=lib_fb - lib_f, sdpa_fwd_bwd_ms=lib_fb,
            tflops=bf / ms_b / 1e9))
        print(f"    fwd kernel {ms_f:.4f} ms (without rope {ms_f0:.4f} ms) "
              f"plain {pl_f:.4f} ms bound {bf_ms:.4f} ms ({bf_by}) sdpa "
              f"{lib_f:.4f} ms; bwd kernel {ms_b:.4f} ms (without rope "
              f"{ms_b0:.4f} ms) plain {pl_b:.4f} ms bound {bb_ms:.4f} ms "
              f"({bb_by}) sdpa fwd+bwd {lib_fb:.4f} ms", flush=True)
        del q, k, v, do, o, lse, ro, rlse, grads, refs, leaves
        torch.cuda.empty_cache()
    return rows


def to_bf16_matrices(model):
    """The AMP-O2 forward cast: parameters with ndim >= 2 to bf16 (norm
    scales stay f32 and are cast down inside rms_norm)."""
    import torch
    for p in model.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model


def phase_forward(torch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=688,
                      num_hidden_layers=4, num_attention_heads=8,
                      num_key_value_heads=4, max_position_embeddings=128,
                      dtype="bfloat16")
    model = to_bf16_matrices(LlamaForCausalLM(cfg, device="cuda", seed=0))
    model.eval()
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1024, (4, 128))).cuda()
    with torch.no_grad():
        reset_counts()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd, bwd = read_flash_counts()
        with plain_attention():
            ref = model(ids)
    check(tuple(logits.shape) == (4, 128, 1024) and bool(
        torch.isfinite(logits).all()), "forward logits malformed")
    check((fwd, bwd) == (4, 0), f"forward launched flash fwd {fwd} / bwd "
          f"{bwd} times (want 4 / 0)")
    err = float((logits.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    # bf16 through 4 layers: the attention outputs differ in the last bf16
    # bit here and there (see FLASH_O_ATOL); allow 1% of the logit range
    tol = 0.01 * scale
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"  forward B=4 S=128 (bf16, 4 layers): logits {tuple(logits.shape)}"
          f" {logits.dtype}, kernel vs plain max abs diff {err:.3e} (tol "
          f"{tol:.3e}, logit max {scale:.3e}), argmax agreement {agree:.4f}, "
          f"flash fwd launches {fwd}", flush=True)
    check(err <= tol, f"forward logits differ by {err} > {tol}")
    return {"max_abs_diff": err, "tol": tol, "argmax_agreement": agree}


def phase_train(torch, options=None):
    """Flagship pretraining (phase 7), or with ``options`` set on the
    config (phase 11: the fused LM-head loss and rope inside the flash
    kernels), which adds the CE and rope launch checks."""
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    cfg, batch, seq = pretrain.flagship_config()
    for k, v in (options or {}).items():
        setattr(cfg, k, v)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    outputs = []
    model.register_forward_hook(
        lambda mod, args, out: outputs.append(out[0] is None))
    params, opt_state, meta = pretrain.make_train_state(model, None)
    step = pretrain.make_train_step(model, None, meta)
    n_params = sum(p.numel() for p in params.values())
    print(f"  model built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e6:.1f}M params", flush=True)
    rng = np.random.default_rng(0)

    def fresh_batch():
        # a different random batch every step (bench.py's rule): the loss
        # is a true random-data loss near ln V
        return pretrain.batch_to_device(
            {"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq)),
             "labels": rng.integers(0, cfg.vocab_size, (batch, seq))})

    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []
    for _ in range(2):                                    # warm-up
        params, opt_state, loss, gnorm = step(params, opt_state,
                                              fresh_batch())
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    timed = 3
    batches = [fresh_batch() for _ in range(timed)]       # pre-staged
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = []
    for b in batches:
        params, opt_state, loss, gnorm = step(params, opt_state, b)
        out.append((loss, gnorm))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = read_flash_counts()
    fused = read_fused_counts()
    tier = read_tier_counts()
    losses += [float(x) for x, _ in out]
    gnorms += [float(g) for _, g in out]
    check((fwd, bwd) == (cfg.num_hidden_layers * timed,) * 2,
          f"flash launched fwd {fwd} / bwd {bwd} times in {timed} steps "
          f"(want {cfg.num_hidden_layers} each per step)")
    want = (timed,) * 3 + (cfg.num_hidden_layers * timed,) * 2 if options \
        else (0,) * 5
    check(fused == want, f"ce fwd / dh / dw and rope flash fwd / bwd "
          f"launches {fused} in {timed} steps (want {want})")
    want_tier = tuple(timed * n for n in tier_counts_per_step(
        cfg, bool(options)))
    check(tier == want_tier, f"fused tier launches (norm fwd / bwd, swiglu "
          f"fwd / bwd, token CE fwd / bwd, AdamW) {tier} in {timed} steps "
          f"(want {want_tier})")
    check(outputs == [bool(options)] * (2 + timed),
          f"the forward returned logits {outputs} (None wanted only with "
          "the fused loss)")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"non-finite loss / grad norm: {losses} {gnorms}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0,
          f"step-0 loss {losses[0]} not within 1.0 of ln V = "
          f"{math.log(cfg.vocab_size):.3f}")
    tokens_per_s = batch * seq * timed / wall
    mfu = train_flops_per_token(cfg, n_params, seq) * tokens_per_s / \
        BF16_FLOPS_PER_S
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if options:
        print(f"  ce kernel launches fwd / dh / dw {fused[:3]}, rope-fused "
              f"flash fwd / bwd {fused[3:]} in {timed} steps; the forward "
              "returned None logits", flush=True)
    print(f"  train B={batch} S={seq} L={cfg.num_hidden_layers}: "
          f"{tokens_per_s:.1f} tokens/s, {wall / timed * 1e3:.1f} ms/step, "
          f"MFU {mfu:.4f} (bench.py's flops per token vs 989 TFLOP/s), "
          f"peak memory {peak_gb:.1f} GB", flush=True)
    print(f"  fused tier launches in {timed} steps: norm fwd / bwd "
          f"{tier[:2]}, swiglu fwd / bwd {tier[2:4]}, token CE fwd / bwd "
          f"{tier[4:6]}, AdamW {tier[6]}", flush=True)
    print(f"  losses {['%.4f' % x for x in losses]} (ln V = "
          f"{math.log(cfg.vocab_size):.4f}), grad norms "
          f"{['%.4f' % x for x in gnorms]}; flash launches fwd {fwd} bwd "
          f"{bwd} = {cfg.num_hidden_layers} x {timed} steps each", flush=True)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, loss, _ = step(params, opt_state, fresh_batch())
        float(loss)
        return 1

    prof = profile_window(torch, one_step, "train step")
    prof["other_by_head_ms"] = attribute_other(torch, one_step)
    del model, params, opt_state, batches, out
    torch.cuda.empty_cache()
    return {"tokens_per_s": tokens_per_s, "ms_per_step": wall / timed * 1e3,
            "mfu": mfu, "losses": losses, "grad_norms": gnorms,
            "flash_fwd_launches": fwd, "flash_bwd_launches": bwd,
            "ce_launches": list(fused[:3]),
            "rope_flash_launches": list(fused[3:]),
            "tier_launches": list(tier),
            "peak_memory_gb": peak_gb, "profile": prof}


def phase_train_parity(torch, options=None):
    """f32 training parity (phase 8), or with ``options`` on the config
    (phase 12), the reference path then also taking the plain CE."""
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, batch, seq = pretrain.flagship_config()
    cfg.num_hidden_layers = 2
    cfg.dtype = "float32"
    for k, v in (options or {}).items():
        setattr(cfg, k, v)
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    states = [pretrain.make_train_state(model, None) for _ in range(2)]
    step = pretrain.make_train_step(model, None, states[0][2])
    rng = np.random.default_rng(1)
    batches = [pretrain.batch_to_device(
        {"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq)),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq))})
        for _ in range(3)]
    runs = []
    for path, (params, opt, _) in zip(("kernel", "plain"), states):
        ctx = contextlib.ExitStack()
        if path == "plain":
            ctx.enter_context(plain_attention())
            ctx.enter_context(plain_ce())
            ctx.enter_context(plain_fused())
        rows = []
        reset_counts()
        with ctx:
            for b in batches:
                params, opt, loss, gnorm = step(params, opt, b)
                rows.append((float(loss), float(gnorm)))
        runs.append(np.array(rows))
        if path == "kernel":
            counts = read_flash_counts() + read_fused_counts()
            n = len(batches)
            want = (cfg.num_hidden_layers * n,) * 2 + (
                (n,) * 3 + (cfg.num_hidden_layers * n,) * 2 if options
                else (0,) * 5)
            check(counts == want, f"kernel path launched flash fwd / bwd, ce "
                  f"fwd / dh / dw, rope flash fwd / bwd {counts} (want "
                  f"{want})")
            tier = read_tier_counts()
            want = tuple(n * k for k in tier_counts_per_step(
                cfg, bool(options)))
            check(tier == want, f"kernel path launched the fused tier "
                  f"{tier} (want {want})")
    rel = np.abs(runs[0] - runs[1]) / np.abs(runs[1])
    print(f"  f32 L=2 B={batch} S={seq}: kernel (loss, gnorm) "
          f"{runs[0].tolist()} vs plain {runs[1].tolist()}; worst relative "
          f"difference {float(rel.max()):.2e} (rtol {TRAIN_RTOL:g})",
          flush=True)
    check(float(rel.max()) <= TRAIN_RTOL,
          f"f32 training diverges from the plain path: {rel.tolist()}")
    params, opt, _ = states[0]
    b = batches[0]
    losses = []
    for _ in range(10):
        params, opt, loss, _ = step(params, opt, b)
        losses.append(float(loss))
    print(f"  one repeated batch, 10 steps: losses "
          f"{['%.4f' % x for x in losses]}", flush=True)
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    del model, states, batches
    torch.cuda.empty_cache()
    return {"kernel": runs[0].tolist(), "plain": runs[1].tolist(),
            "worst_rel": float(rel.max()), "repeated_batch": losses}


FUSED_OPTIONS = dict(fused_lm_loss=True, fuse_rope_in_attention=True)


# -- phases 13-15: FlashMask and the two-pass flash backward ----------------

FM_O_ATOL = 1e-5        # o: f32 summation noise; p stays f32 on both sides
                        # (no bf16 rounding of p, unlike flash's), so only
                        # the final rounding to bf16 differs (2 ulps)
FM_F32_RTOL = 1e-4      # f32 phase 14: |err| <= 1e-4 * max(1, max |ref|),
                        # the same sums in another order
FM_TILE = 64            # the kernels' tile: q and k tiles of 64 rows
NEG_INF_F = -1e30       # the lse of a row that sees nothing


def documents(rng, s, lo, hi):
    """[S] int: the end of each column's document, documents of seeded
    lengths in [lo, hi] packed from position 0 (the last one cut at S)."""
    ends = np.minimum(np.cumsum(rng.integers(lo, hi + 1, s // lo + 1)), s)
    ends = ends[:np.searchsorted(ends, s) + 1]
    return ends[np.searchsorted(ends, np.arange(s), side="right")]


def flashmask_specs():
    """(name, B, S, H, KVH, MH, causal, index builder) of phase 13's cases;
    the builder takes a numpy Generator and returns (sr, er) [B, MH, S]."""
    def docs(lo, hi):
        def build(rng, b, mh, s):
            sr = np.stack([np.stack([documents(rng, s, lo, hi)
                                     for _ in range(mh)]) for _ in range(b)])
            return sr, np.full_like(sr, s)
        return build

    def band(rng, b, mh, s):          # rows [j + a, j + a + w) masked
        j = np.arange(s)
        sr = j + rng.integers(0, 513, (b, mh, s))
        return sr, sr + rng.integers(0, 1025, (b, mh, s))

    def intervals(rng, b, mh, s):     # non-causal: any [sr, er)
        sr = rng.integers(0, s + 1, (b, mh, s))
        return sr, sr + rng.integers(0, s // 2 + 1, (b, mh, s))

    def dead(rng, b, mh, s):          # columns below 64 masked for all rows
        sr = np.broadcast_to(np.where(np.arange(s) < 64, 0, s), (b, mh, s))
        return sr.copy(), np.full((b, mh, s), s)

    return [
        ("doc_b8_s2048_h16", 8, 2048, 16, 16, 1, True, docs(64, 1024)),
        ("band_b8_s2048_h16_mh16", 8, 2048, 16, 16, 16, True, band),
        ("gqa_b4_s512_h16_kvh4", 4, 512, 16, 4, 1, True, docs(64, 256)),
        ("off_tile_b2_s2000_h16", 2, 2000, 16, 16, 1, True, docs(64, 1024)),
        ("full_b2_s2048_h16_mh4", 2, 2048, 16, 16, 4, False, intervals),
        ("dead_rows_b2_s1024_h16", 2, 1024, 16, 16, 1, True, dead),
        ("long_b1_s16384_h16", 1, 16384, 16, 16, 1, True, docs(512, 4096)),
    ]


def flashmask_work(sr, er, h, sq, causal, d):
    """(visible pairs, live tiles, causal tiles, all tiles) of a case from
    its [B, MH, Sk] bounds: pairs counted per column (its causal rows less
    the interval's overlap), tiles by ``_block_live``'s rule at the
    kernels' 64 x 64 tiles, each mask row counted for its H / MH heads."""
    from paddle_tpu_torch.ops import work
    b, mh, sk = sr.shape
    rep = h // mh
    pairs = work.flashmask_pairs(sr, er, h, sq, causal)
    nq, nk = -(-sq // FM_TILE), -(-sk // FM_TILE)
    pad = nk * FM_TILE - sk
    srp = np.pad(sr, ((0, 0), (0, 0), (0, pad))).reshape(b, mh, nk, FM_TILE)
    erp = np.pad(er, ((0, 0), (0, 0), (0, pad)), constant_values=2 ** 31 - 1)
    smax = srp.max(-1)
    emin = erp.reshape(b, mh, nk, FM_TILE).min(-1)
    rlo = (np.arange(nq) * FM_TILE)[:, None]
    rhi = rlo + FM_TILE - 1
    dead = (rlo >= smax[..., None, :]) & (rhi < emin[..., None, :])
    tri = (np.arange(nk) * FM_TILE)[None, :] <= rhi if causal \
        else np.ones((nq, nk), bool)
    live = int((~dead & tri).sum()) * rep
    return pairs, live, int(tri.sum()) * b * h, nq * nk * b * h


def bwd_stage_ms(torch, mode, q, k, v, o, lse, do, sr, er, scale, causal,
                 iters):
    """(dq ms, dk / dv ms) of the backward kernels of csrc/flashmask.cu,
    each launched alone and timed with CUDA events; dq includes the
    pre-pass (delta, tile extremes) that its launch follows."""
    from paddle_tpu_torch.ops import flashmask as fm
    prep = fm._bwd_prep("timing", mode, q, k, o, do, sr, er)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ms_prep = time_ms(lambda: fm._bwd_prep("timing", mode, q, k, o, do, sr,
                                           er), iters=iters)
    ms_dq = time_ms(lambda: fm._bwd_launch(
        "dq", "timing", mode, q, k, v, lse, do, prep, (dq,), scale, causal),
        iters=iters)
    ms_dkv = time_ms(lambda: fm._bwd_launch(
        "dkv", "timing", mode, q, k, v, lse, do, prep, (dk, dv), scale,
        causal), iters=iters)
    return ms_prep + ms_dq, ms_dkv


def bwd_route_text(mode, dtype, d, pairs, ms_dq, ms_dkv):
    """(text, fields) of the backward's route as the built library reports
    it, and the TFLOP/s its dq and dk / dv kernels execute on the visible
    pairs: q k^T, do v^T and, per part of p and ds, ds k (dq) or p^T do
    and ds^T q (dk / dv), 2 D flops a pair each (one rounded part on the
    CUDA cores)."""
    from paddle_tpu_torch.ops import flashmask as fm
    route, parts = fm.bwd_route(mode, dtype)
    n = max(parts, 1)
    tf_dq = (2 + n) * 2 * d * pairs / ms_dq / 1e9
    tf_dkv = (2 + 2 * n) * 2 * d * pairs / ms_dkv / 1e9
    what = f"{parts} 16-bit parts of p and ds" if parts > 1 else \
        "p and ds rounded to 16 bits" if parts else "f32"
    text = (f"bwd route {route} ({what}); executed dq {tf_dq:.1f} + dk/dv "
            f"{tf_dkv:.1f} TFLOP/s on the visible pairs")
    return text, dict(bwd_body=route, parts=parts, dq_tflops=tf_dq,
                      dkv_tflops=tf_dkv)


def fwd_route_text(dtype, d, pairs, ms_f):
    """(text, fields) of the forward's route as the built library reports
    it, and the TFLOP/s it executes on the visible pairs: q k^T and one
    product of p v per part of p, 2 D flops a pair each (one f32 product
    on the CUDA cores)."""
    from paddle_tpu_torch.ops import flashmask as fm
    route, parts = fm.fwd_route(dtype)
    tf = (1 + max(parts, 1)) * 2 * d * pairs / ms_f / 1e9
    what = f"{parts} 16-bit parts of p" if parts else "f32"
    return (f"fwd route {route} ({what}); executed {tf:.1f} TFLOP/s on the "
            "visible pairs", dict(fwd_body=route, parts=parts,
                                  executed_tflops=tf))


def fm_inputs(torch, gen, b, s, h, kvh, d, dtype):
    """(q, k, v, do) folded to [B*H, S, D], kv heads repeated as
    ``flashmask_attention_bshd`` repeats them."""
    def bshd(hh):
        return torch.randn(b, s, hh, d, device="cuda", generator=gen) \
            .to(dtype)

    def fold(x):
        x = torch.repeat_interleave(x, h // x.shape[2], dim=2)
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    return fold(bshd(h)), fold(bshd(kvh)), fold(bshd(kvh)), fold(bshd(h))


def phase_flashmask(torch):
    from paddle_tpu_torch.ops import work
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import flashmask as fm
    rows = {"fwd": [], "dq": [], "dkv": []}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(51)
    rng = np.random.default_rng(51)
    d = 64
    for name, b, s, h, kvh, mh, causal, build in flashmask_specs():
        sr_np, er_np = (np.minimum(x, 2 ** 31 - 1).astype(np.int32)
                        for x in build(rng, b, mh, s))
        sr = torch.as_tensor(sr_np).cuda()
        er = torch.as_tensor(er_np).cuda()
        q, k, v, do = fm_inputs(torch, gen, b, s, h, kvh, d, torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        o, lse = fm.flashmask_fwd(q, k, v, sr, er, scale, causal)
        ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
        grads = fm.flashmask_bwd(q, k, v, ro, rlse, do, sr, er, scale, causal)
        refs = fm.flashmask_bwd_plain(q, k, v, ro, rlse, do, sr, er, scale,
                                      causal)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o,) + tuple(grads))
        err_o, ratio_o = bf16_agreement(o, ro, FM_O_ATOL)
        err_l = float((lse - rlse).abs().max())
        gerr, gratio, worst = 0.0, 0.0, "dq"
        for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
            e, ratio = bf16_agreement(g, r, FLASH_GRAD_ATOL)
            if ratio >= gratio:
                worst = gname
            gerr, gratio = max(gerr, e), max(gratio, ratio)
        pairs, live, tri, tiles = flashmask_work(sr_np, er_np, h, s, causal,
                                                 d)
        square = b * h * (s * (s + 1) // 2 if causal else s * s)
        print(f"  flashmask[{name}]: {pairs / (b * h):.0f} visible pairs per "
              f"head ({pairs / square:.3f} of the "
              f"{'causal' if causal else 'full'} square), live tiles "
              f"{live} of {tri} {'causal ' if causal else ''}tiles "
              f"({live / tri:.3f}); fwd o err {err_o:.3e} (worst "
              f"{ratio_o:.3f} of atol {FM_O_ATOL:g} + 2 bf16 ulps), lse err "
              f"{err_l:.2e}; bwd err {gerr:.3e} (worst {gratio:.3f}, in "
              f"{worst}, of atol {FLASH_GRAD_ATOL:g} + 2 bf16 ulps)",
              flush=True)
        check(finite, f"flashmask {name}: non-finite output")
        check(ratio_o <= 1.0, f"flashmask fwd {name}: o max abs err {err_o}, "
              f"an element off by {ratio_o:.2f}x its allowance")
        check(err_l <= LSE_ATOL, f"flashmask fwd {name}: lse err {err_l}")
        check(gratio <= 1.0, f"flashmask bwd {name}: {worst} max abs err "
              f"{gerr}, an element off by {gratio:.2f}x its allowance")
        if name.startswith("dead_rows"):
            zero = not any(bool(t[:, :64].any())
                           for t in (o,) + tuple(grads))
            check(zero and bool((lse[:, :64] == NEG_INF_F).all()),
                  "flashmask: a row that sees nothing has a non-zero o or "
                  "dq, a column no row sees a non-zero dk / dv, or lse is "
                  "not -1e30")
            print("    rows 0-63 see nothing: o, dq and dk / dv of columns "
                  "0-63 exactly 0, lse -1e30", flush=True)
        del refs
        long = s > 4096
        big = b * h * s >= 65536
        it, pit = (5, 1) if long else ((10, 3) if big else (25, 10))
        ms_f = time_ms(lambda: fm.flashmask_fwd(q, k, v, sr, er, scale,
                                                causal), iters=it)

        def bwd():
            return fm.flashmask_bwd(q, k, v, ro, rlse, do, sr, er, scale,
                                    causal)

        ms_b = time_ms(bwd, iters=it)
        ms_dq, ms_dkv = bwd_stage_ms(torch, fm.MODE_FLASHMASK, q, k, v, ro,
                                     rlse, do, sr, er, scale, causal, it)
        pl_f = time_ms(lambda: fm.flashmask_fwd_plain(q, k, v, sr, er, scale,
                                                      causal),
                       iters=pit, warmup=1)
        pl_b = time_ms(lambda: fm.flashmask_bwd_plain(
            q, k, v, ro, rlse, do, sr, er, scale, causal), iters=pit,
            warmup=1)
        # library yardstick (timed only; the port never calls it): SDPA with
        # the materialized boolean mask, forward and forward + backward
        rowi = torch.arange(s, device="cuda")[:, None]
        keep = ~((rowi >= sr[:, :, None, :]) & (rowi < er[:, :, None, :]))
        if causal:
            keep &= rowi >= torch.arange(s, device="cuda")[None, :]
        if mh not in (1, h):                 # SDPA broadcasts 1 or H heads
            keep = keep.repeat_interleave(h // mh, dim=1)
        q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
        lib_f = time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=keep, scale=scale), iters=it)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4)]

        def sdpa_fb():
            out = Fn.scaled_dot_product_attention(*leaves, attn_mask=keep,
                                                  scale=scale)
            torch.autograd.grad(out, leaves, do4)

        lib_fb = time_ms(sdpa_fb, iters=it)
        lib_b = lib_fb - lib_f
        # dq: q k v o do lse and the index in, dq out; dk / dv: the same in,
        # dk and dv out; each two of the backward's four products
        fm_work = work.flashmask(b, h, s, d, pairs, sr.numel())
        f_ms, f_by = bound(*fm_work["fwd"])
        dq_ms, dq_by = bound(*fm_work["dq"])
        dkv_ms, dkv_by = bound(*fm_work["dkv"])
        route_text, route = bwd_route_text(fm.MODE_FLASHMASK, q.dtype, d,
                                           pairs, ms_dq, ms_dkv)
        dev_f = device_time_ms(lambda: fm.flashmask_fwd(
            q, k, v, sr, er, scale, causal), iters=it)
        fwd_text, fwd_route = fwd_route_text(q.dtype, d, pairs, dev_f)
        common = dict(case=name, visible_pairs=pairs, live_tiles=live,
                      causal_tiles=tri, tiles=tiles)
        rows["fwd"].append(dict(
            common, max_abs_err=err_o, lse_err=err_l, atol=FM_O_ATOL,
            worst_err_over_allowed=ratio_o, ms=ms_f, device_ms=dev_f,
            plain_ms=pl_f, bound_ms=f_ms, bound_by=f_by, library_ms=lib_f,
            tflops=4 * d * pairs / ms_f / 1e9, **fwd_route))
        for key, ms, b_ms, b_by in (("dq", ms_dq, dq_ms, dq_by),
                                    ("dkv", ms_dkv, dkv_ms, dkv_by)):
            rows[key].append(dict(
                common, max_abs_err=gerr, atol=FLASH_GRAD_ATOL,
                worst_err_over_allowed=gratio, ms=ms, bwd_ms=ms_b,
                plain_ms=pl_b, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_b, sdpa_fwd_bwd_ms=lib_fb,
                plain_note="plain_ms and library_ms cover dq, dk and dv",
                **route))
        tf = 4 * d * pairs / ms_f / 1e9
        print(f"    fwd kernel {ms_f:.4f} ms, device {dev_f:.4f} ms ({tf:.2f} "
              f"TFLOP/s on visible pairs) plain {pl_f:.4f} ms bound "
              f"{f_ms:.4f} ms ({f_by}) masked sdpa {lib_f:.4f} ms; bwd "
              f"kernels {ms_b:.4f} ms (dq {ms_dq:.4f} + dk/dv {ms_dkv:.4f} "
              "alone; "
              f"{8 * d * pairs / ms_b / 1e9:.2f} TFLOP/s) plain {pl_b:.4f} ms "
              f"bound {dq_ms:.4f} + {dkv_ms:.4f} ms masked sdpa fwd+bwd "
              f"{lib_fb:.4f} ms", flush=True)
        print(f"    {fwd_text}; {route_text}", flush=True)
        del q, k, v, do, o, lse, ro, rlse, grads, leaves, keep, q4, k4, v4
        torch.cuda.empty_cache()
    return rows


def flashmask_step_inputs(torch, dtype, b):
    """[B, S, H, D] q, k, v leaves, the upstream gradient and a 1-column
    packed-document index [B, 1, S, 1] at case (a)'s widths (S=2048,
    H=16, D=64, documents of 64-1024 tokens)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    rng = np.random.default_rng(61)
    s, h, d = 2048, 16, 64
    x = [torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
         for _ in range(4)]
    idx = np.stack([documents(rng, s, 64, 1024) for _ in range(b)])
    return x, torch.as_tensor(idx[:, None, :, None].astype(np.int32)).cuda()


def attention_step(torch, fn, tensors, layers):
    """Forward and backward of ``layers`` attention calls on one set of
    leaves, as one step's attention; returns (outputs, leaf grads)."""
    q, k, v, g = tensors
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    outs = [fn(*leaves) for _ in range(layers)]
    torch.autograd.backward(outs, [g] * layers)
    return outs, [t.grad for t in leaves]


def phase_flashmask_step(torch):
    """24 layers' FlashMask attention, forward and backward through the
    ``incubate`` entry at case (a): the launch gate, then its time beside
    24 causal flash calls on the same tensors."""
    from paddle_tpu_torch.incubate.nn import functional as FI
    from paddle_tpu_torch.ops import flash_attention as fa
    tensors, idx = flashmask_step_inputs(torch, torch.bfloat16, 8)

    def fm_layer(q, k, v):
        return FI.flashmask_attention(q, k, v, idx, causal=True)

    def flash_layer(q, k, v):
        return fa.flash_attention_bshd(q, k, v, causal=True)

    attention_step(torch, fm_layer, tensors, 1)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    outs, grads = attention_step(torch, fm_layer, tensors, L)
    torch.cuda.synchronize()
    counts = read_flashmask_counts()
    check(counts[:3] == (L,) * 3, f"the FlashMask step launched fwd / dq / "
          f"dk-dv {counts[:3]} times (want {L} each)")
    check(all(bool(torch.isfinite(t).all()) for t in [outs[0]] + grads),
          "the FlashMask step gave non-finite values")
    del outs, grads

    def wall(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            attention_step(torch, fn, tensors, L)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    fm_ms, flash_ms = wall(fm_layer), wall(flash_layer)
    fm2 = wall(fm_layer)
    print(f"  {L} layers of FlashMask attention, fwd + bwd through autograd "
          f"(B=8 S=2048 H=16 D=64, packed documents): launches fwd / dq / "
          f"dk-dv {counts[:3]}; {fm_ms:.1f} ms (again {fm2:.1f} ms) vs "
          f"{flash_ms:.1f} ms for {L} causal flash calls (K1 + K2) on the "
          f"same tensors", flush=True)
    torch.cuda.empty_cache()
    return {"launches": list(counts[:3]), "step_ms": fm_ms,
            "step_ms_again": fm2, "causal_flash_step_ms": flash_ms}


@contextlib.contextmanager
def plain_flashmask():
    """Route the FlashMask autograd function through the plain versions on
    the card (the reference path of phase 14); restores the kernels."""
    from paddle_tpu_torch.ops import flashmask as fm
    saved = fm.flashmask_fwd, fm.flashmask_bwd
    fm.flashmask_fwd, fm.flashmask_bwd = (fm.flashmask_fwd_plain,
                                          fm.flashmask_bwd_plain)
    try:
        yield
    finally:
        fm.flashmask_fwd, fm.flashmask_bwd = saved


def phase_flashmask_f32(torch):
    from paddle_tpu_torch.incubate.nn import functional as FI
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tensors, idx = flashmask_step_inputs(torch, torch.float32, 2)

    def layer(q, k, v):
        return FI.flashmask_attention(q, k, v, idx, causal=True)

    reset_counts()
    got = attention_step(torch, layer, tensors, 1)
    counts = read_flashmask_counts()
    with plain_flashmask():
        want = attention_step(torch, layer, tensors, 1)
    torch.cuda.synchronize()
    check(counts == (1, 1, 1, 0, 0), f"f32 FlashMask launched {counts} "
          "(want one fwd, dq and dk-dv launch)")
    worst = 0.0
    for name, x, r in zip(("o", "dq", "dk", "dv"), got[0] + got[1],
                          want[0] + want[1]):
        x, r = x.detach(), r.detach()
        err = float((x - r).abs().max())
        ratio = err / (FM_F32_RTOL * max(1.0, float(r.abs().max())))
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"f32 FlashMask {name}: err {err} over "
              f"{FM_F32_RTOL:g} x max(1, max |ref|)")
    print(f"  f32 B=2 S=2048 H=16 D=64 documents: kernels vs plain o / dq / "
          f"dk / dv worst {worst:.4f} of {FM_F32_RTOL:g} x max(1, max |ref|);"
          f" launches {counts[:3]}", flush=True)
    torch.cuda.empty_cache()
    return {"worst_over_allowed": worst, "launches": list(counts[:3])}


def phase_twopass(torch):
    """The two-pass backward at the flagship shape: 24 calls counted (one
    step's worth of attention backward), then each element against
    ``flash_bwd_plain``, then its time beside the fused backward and SDPA's
    backward share."""
    from paddle_tpu_torch.ops import work
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    b, s, h, d = 8, 2048, 16, 64
    q, k, v, do = fm_inputs(torch, gen, b, s, h, h, d, torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale, True)
    fa.flash_bwd_twopass(q, k, v, ro, rlse, do, scale, True)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(L):
        grads = fa.flash_bwd_twopass(q, k, v, ro, rlse, do, scale, True)
    torch.cuda.synchronize()
    counts = read_flashmask_counts()
    check(counts == (0, 0, 0, L, L), f"two-pass launches {counts} (want "
          f"{L} dq and {L} dk-dv)")
    refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, True)
    # p and ds are rounded to bf16 on both sides from f32 values that agree
    # only to f32 rounding (the tensor cores sum q k^T and do v^T in
    # another order), so the gate allows their one-ulp flips, as phase 5's
    # does for the same arithmetic in the fused backward; the reading
    # without that term is printed beside it
    extras = flash_grad_rounding(torch, fa, q, k, v, ro, rlse, do, scale,
                                 True)
    torch.cuda.synchronize()
    gerr, gratio, worst, bare = 0.0, 0.0, "dq", 0.0
    for gname, g, r, x in zip(("dq", "dk", "dv"), grads, refs, extras):
        e, ratio = bf16_agreement(g, r, FLASH_GRAD_ATOL, x)
        bare = max(bare, bf16_agreement(g, r, FLASH_GRAD_ATOL)[1])
        if ratio >= gratio:
            worst = gname
        gerr, gratio = max(gerr, e), max(gratio, ratio)
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "two-pass: non-finite gradients")
    check(gratio <= 1.0, f"two-pass bwd: {worst} max abs err {gerr}, an "
          f"element off by {gratio:.2f}x its allowance")
    del refs, extras

    def twopass():
        return fa.flash_bwd_twopass(q, k, v, ro, rlse, do, scale, True)

    ms = time_ms(twopass, iters=10)
    ms_dq, ms_dkv = bwd_stage_ms(torch, fm.MODE_TWOPASS, q, k, v, ro, rlse,
                                 do, None, None, scale, True, 10)
    ms_fused = time_ms(lambda: fa.flash_bwd(q, k, v, ro, rlse, do, scale,
                                            True), iters=10)
    ms2 = time_ms(twopass, iters=10)
    pl = time_ms(lambda: fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale,
                                            True), iters=3, warmup=1)
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    lib_f = time_ms(lambda: Fn.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale), iters=10)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]

    def sdpa_fb():
        out = Fn.scaled_dot_product_attention(*leaves, is_causal=True,
                                              scale=scale)
        torch.autograd.grad(out, leaves, do4)

    lib_fb = time_ms(sdpa_fb, iters=10)
    pairs = b * h * s * (s + 1) // 2
    tp_work = work.flashmask(b, h, s, d, pairs, 0)    # q k v o do, lse in
    dq_ms, dq_by = bound(*tp_work["dq"])
    dkv_ms, dkv_by = bound(*tp_work["dkv"])
    name = "flagship_b8_s2048_h16_d64"
    route_text, route = bwd_route_text(fm.MODE_TWOPASS, q.dtype, d, pairs,
                                       ms_dq, ms_dkv)
    print(f"  two-pass bwd[{name}]: err {gerr:.3e} (worst {gratio:.3f}, in "
          f"{worst}, of atol {FLASH_GRAD_ATOL:g} + flips of p, ds + 2 bf16 "
          f"ulps; {bare:.3f} of the allowance without flips); launches "
          f"dq / dk-dv {counts[3:]}; kernels {ms:.4f} ms (again {ms2:.4f}; "
          f"dq {ms_dq:.4f} + dk/dv {ms_dkv:.4f} alone) vs fused backward "
          f"{ms_fused:.4f} ms; plain {pl:.4f} ms; bound {dq_ms:.4f} + "
          f"{dkv_ms:.4f} ms; sdpa bwd share {lib_fb - lib_f:.4f} ms",
          flush=True)
    print(f"    {route_text}", flush=True)
    rows = {}
    for key, kms, b_ms, b_by in (("dq", ms_dq, dq_ms, dq_by),
                                 ("dkv", ms_dkv, dkv_ms, dkv_by)):
        rows[key] = [dict(
            case=name, max_abs_err=gerr, atol=FLASH_GRAD_ATOL,
            worst_err_over_allowed=gratio,
            worst_err_over_allowed_without_flips=bare, ms=kms, bwd_ms=ms,
            bwd_ms_again=ms2, fused_bwd_ms=ms_fused, plain_ms=pl,
            bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_fb - lib_f, sdpa_fwd_bwd_ms=lib_fb,
            plain_note="plain_ms and library_ms cover dq, dk and dv",
            **route)]
    del q, k, v, do, ro, rlse, grads, leaves
    torch.cuda.empty_cache()
    return rows, counts[3:]


# -- phase 16: legacy paged decode attention ---------------------------------

DECODE_ATOL = 1e-5      # f32 summation noise: kernel and plain version take
                        # the same f32 products, online-softmax steps and
                        # p @ v in another order; on top of it one unit in
                        # the last place of the output type at max(|out|,
                        # |ref|), since each side rounds its f32 result
                        # once (at most half an ulp each)
AB_TOL = 2e-2           # legacy vs ragged kernel (serve_bench.py:233-239)
DECODE_STEPS = 64


def ulp_agreement(out, ref, atol):
    """(max abs error, largest error over its allowance): per element,
    atol plus one ulp of the output type at max(|out|, |ref|)."""
    mant = {"torch.float32": 23, "torch.bfloat16": 7,
            "torch.float16": 10}[str(out.dtype)]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    mag = o.abs().maximum(r.abs()).clamp_min(2.0 ** -126)
    allowed = atol + (mag.log2().floor() - mant).exp2()
    return float(err.max()), float((err / allowed).max())


def decode_tables(rng, b, max_nb, nb, lens, bs, free_tail=False):
    """Distinct blocks 1..nb-1 per row (block 0 parks), [b, max_nb] int32;
    with ``free_tail`` the entries past each row's last used block are -1."""
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = perm[:b * max_nb].reshape(b, max_nb).copy()
    if free_tail:
        used = np.minimum(-(-lens // bs), max_nb)
        for i in range(b):
            tables[i, used[i]:] = -1
    return tables


def decode_cases():
    """(name, B, H, KVH, BS, NB, max_nb, lens, dtype name, free tail) of
    phase 16's kernel cases."""
    rng = np.random.default_rng(16)
    lens_b = rng.integers(1, SMAX + 1, MAX_BATCH).astype(np.int32)
    maxnb = SMAX // BS
    return [
        ("a_serve_bench_bs64", 8, H, KVH, 64, 8 * 7 + 1, 7,
         np.array([448, 64, 192, 27, 448, 1, 320, 100], np.int32),
         "bfloat16", False),
        ("a_serve_bench_bs64_f32", 8, H, KVH, 64, 8 * 7 + 1, 7,
         np.array([448, 64, 192, 27, 448, 1, 320, 100], np.int32),
         "float32", False),
        ("b_serving_cache", MAX_BATCH, H, KVH, BS, NUM_BLOCKS, maxnb,
         lens_b, "bfloat16", False),
        ("c_mha_16_16", MAX_BATCH, H, H, BS, NUM_BLOCKS, maxnb, lens_b,
         "bfloat16", False),
        ("d_ctx0_and_capacity", MAX_BATCH, H, KVH, BS, NUM_BLOCKS, maxnb,
         np.array([0, SMAX, SMAX + 88, 33, 1, 250, BS, BS + 1], np.int32),
         "bfloat16", True),
        ("e_block_size_128", MAX_BATCH, H, KVH, 128,
         MAX_BATCH * (SMAX // 128) + 1, SMAX // 128, lens_b, "bfloat16",
         False),
        ("f_mqa_16_1", MAX_BATCH, H, 1, BS, NUM_BLOCKS, maxnb, lens_b,
         "bfloat16", False),
    ]


def decode_case_tensors(torch):
    """Phase 16's kernel cases on the card, one at a time: (case row of
    ``decode_cases``, q, k cache, v cache, int32 tables and lengths)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rng = np.random.default_rng(160)
    for case in decode_cases():
        (name, b, h, kvh, bs, nb, max_nb, lens, dt, free_tail) = case
        dtype = getattr(torch, dt)
        kc = torch.randn(kvh, nb, bs, D, device="cuda", generator=gen).to(
            dtype)
        vc = torch.randn(kvh, nb, bs, D, device="cuda", generator=gen).to(
            dtype)
        q = torch.randn(b, h, D, device="cuda", generator=gen).to(dtype)
        tables = decode_tables(rng, b, max_nb, nb, lens, bs, free_tail)
        yield (case, q, kc, vc, torch.as_tensor(tables).cuda(),
               torch.as_tensor(lens).cuda())


def decode_step_caches(torch):
    """Phase 16's serving cache as the decode-op run leaves it after
    ``DECODE_STEPS`` steps (case (b)'s tables, the lengths after the last
    append), random bf16 contents and one layer's q: (q, k cache, v cache,
    tables, lengths) on the card."""
    (_, b, h, kvh, bs, nb, max_nb, lens0, _, _) = decode_cases()[2]
    rng = np.random.default_rng(161)
    tables = decode_tables(rng, b, max_nb, nb, lens0, bs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(161)
    kc = torch.randn(kvh, nb, bs, D, device="cuda", generator=gen).bfloat16()
    vc = torch.randn(kvh, nb, bs, D, device="cuda", generator=gen).bfloat16()
    q = torch.randn(b, h, D, device="cuda", generator=gen).bfloat16()
    return (q, kc, vc, torch.as_tensor(tables).cuda(),
            torch.as_tensor(lens0 + DECODE_STEPS).cuda())


def decode_sdpa_inputs(torch, q, kc, vc, tables, lens):
    """SDPA's operands for a decode call: the KV of the table's blocks
    (ids clamped) gathered into a dense context, heads repeated for GQA,
    the mask pos < ctx (timed only; the port never calls SDPA)."""
    b, h, _ = q.shape
    kvh, nb, bs, _ = kc.shape
    tl = tables.long().clamp(0, nb - 1)
    span = tables.shape[1] * bs
    kg = kc[:, tl].reshape(kvh, b, span, D).transpose(0, 1)
    vg = vc[:, tl].reshape(kvh, b, span, D).transpose(0, 1)
    kg = kg.repeat_interleave(h // kvh, 1).contiguous()
    vg = vg.repeat_interleave(h // kvh, 1).contiguous()
    mask = (torch.arange(span, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    return q[:, :, None], kg, vg, mask


def decode_plan_text(plan):
    """A decode kernel plan (``paged_attention.decode_plan``) as one short
    field."""
    return (f"plan S {plan['splits']} x {plan['pages_per_split']} pages, "
            f"blocks {plan['blocks']}, workspace "
            f"{plan['workspace_bytes']} B")


def decode_work(lens, bs, max_nb, b, h, kvh, itemsize):
    """Bytes and flops the case's data needs (``ops.work.paged_decode``):
    the KV of each row's first min(ctx, max_nb * BS) positions read once
    per kv head, the table entries of the blocks used, q read and out
    written once; 4*D flops per (query head, key)."""
    from paddle_tpu_torch.ops import work
    return work.paged_decode(lens, bs, max_nb, b, h, kvh, D, itemsize)


def phase_paged_decode(torch):
    """Phase 16: the legacy decode kernel against its plain version and
    its split arithmetic at the plan's splits, then the fused op at full
    width. Returns (kernel rows, op stats)."""
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import paged_attention as pa
    rows = []
    for case, q, kc, vc, tab_d, lens_d in decode_case_tensors(torch):
        (name, b, h, kvh, bs, _, max_nb, lens, _, _) = case
        plan = pa.decode_plan(b, h, kvh, max_nb, bs, D, q.dtype)
        out = pa.paged_attention(q, kc, vc, tab_d, lens_d)
        again = pa.paged_attention(q, kc, vc, tab_d, lens_d)
        ref = pa.paged_attention_plain(q, kc, vc, tab_d, lens_d)
        split_ref = pa.paged_attention_split_plain(
            q, kc, vc, tab_d, lens_d, plan["splits"],
            plan["pages_per_split"])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"decode {name}: non-finite")
        check(torch.equal(out, again), f"decode {name}: two calls differ")
        zero = lens == 0
        check(not zero.any() or float(out[torch.as_tensor(zero).cuda()]
                                      .float().abs().max()) == 0.0,
              f"decode {name}: a ctx-0 row is not exactly zero")
        err, ratio = ulp_agreement(out, ref, DECODE_ATOL)
        check(ratio <= 1.0, f"decode {name}: max abs err {err}, an element "
              f"off by {ratio:.2f}x its allowance")
        s_err, s_ratio = ulp_agreement(out, split_ref, DECODE_ATOL)
        check(s_ratio <= 1.0, f"decode {name}: max abs err {s_err} against "
              f"the split arithmetic, {s_ratio:.2f}x its allowance")
        check(name != "b_serving_cache" or plan["splits"] > 1,
              f"decode {name}: plan {plan} does not split")
        ms = time_ms(lambda: pa.paged_attention(q, kc, vc, tab_d, lens_d))
        plain_ms = time_ms(lambda: pa.paged_attention_plain(
            q, kc, vc, tab_d, lens_d), iters=10)
        nbytes, flops = decode_work(lens, bs, max_nb, b, h, kvh,
                                    q.element_size())
        b_ms, b_by = bound(nbytes, flops)
        # library yardstick: SDPA over the gathered dense context with the
        # ctx mask (timed only; the port never calls it)
        q4, kg, vg, mask = decode_sdpa_inputs(torch, q, kc, vc, tab_d,
                                              lens_d)
        lib_ms = time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask))
        dev_ms = device_time_ms(lambda: pa.paged_attention(q, kc, vc, tab_d,
                                                           lens_d))
        lib_dev = device_time_ms(lambda: Fn.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask))
        del q4, kg, vg, mask
        rows.append(dict(case=name, max_abs_err=err, atol=DECODE_ATOL,
                         worst_err_over_allowed=ratio,
                         split_plain_err=s_err,
                         split_plain_worst_over_allowed=s_ratio, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev,
                         device_ratio_to_library=dev_ms / lib_dev,
                         repeat_bit_equal=True, plan=plan))
        print(f"  paged_decode_attention[{name}]: err {err:.3e} (worst "
              f"{ratio:.3f} of atol {DECODE_ATOL:g} + 1 ulp; split "
              f"arithmetic {s_ratio:.3f}; two calls bit-equal) kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by}) sdpa {lib_ms:.4f} ms; {decode_plan_text(plan)}; "
              f"device ms: kernel {dev_ms:.4f} sdpa {lib_dev:.4f} "
              f"({dev_ms / lib_dev:.2f}x)", flush=True)
    torch.cuda.empty_cache()
    return rows, decode_op_run(torch, pa)


def decode_op_inputs(torch):
    """The decode-op run's inputs: case (b)'s tables (host int32) and
    starting lengths, 24 layers of bf16 serving caches on the card and
    [DECODE_STEPS, L, B, 3, H, D] qkv, all from seed 161."""
    (_, b, h, kvh, bs, nb, max_nb, lens0, _, _) = decode_cases()[2]
    rng = np.random.default_rng(161)
    tables = decode_tables(rng, b, max_nb, nb, lens0, bs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(161)
    caches = [(torch.randn(kvh, nb, bs, D, device="cuda",
                           generator=gen).bfloat16(),
               torch.randn(kvh, nb, bs, D, device="cuda",
                           generator=gen).bfloat16()) for _ in range(L)]
    qkv = torch.randn(DECODE_STEPS, L, b, 3, h, D, device="cuda",
                      generator=gen).bfloat16()
    return tables, lens0, caches, qkv


def decode_op_steps(caches, qkv, tables, lens0, steps=DECODE_STEPS):
    """``steps`` decode steps x L layers of block_multihead_attention
    (each appends its token in place); the last step's outputs."""
    from paddle_tpu_torch.incubate.nn import functional as TF
    outs = None
    for step in range(steps):
        lens = lens0 + step
        outs = [TF.block_multihead_attention(qkv[step, li], *caches[li],
                                             tables, lens)[0]
                for li in range(len(caches))]
    return outs


def decode_op_run(torch, pa):
    """64 decode steps x 24 layers of block_multihead_attention at B=8 over
    the serving cache (case (b)'s tables and starting lengths; rows that
    reach the table's capacity have their writes dropped and still
    attend), against a plain-route run and the ragged kernel."""
    from paddle_tpu_torch.incubate.nn import functional as TF
    tables, lens0, caches, qkv = decode_op_inputs(torch)
    b = len(lens0)
    start = [(k.clone(), v.clone()) for k, v in caches]

    def run(cs, steps=DECODE_STEPS):
        return decode_op_steps(cs, qkv, tables, lens0, steps)

    TF.block_multihead_attention(qkv[0, 0].clone(), *[c.clone() for c in
                                                      caches[0]],
                                 tables, lens0)          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = run(caches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k7, int8 = read_decode_counts()
    attn, int4 = read_counts()
    check(k7 == L * DECODE_STEPS, f"decode kernel launched {k7} times in "
          f"{DECODE_STEPS} steps (want {L * DECODE_STEPS})")
    check((attn, int4, int8) == (0, 0, 0), f"other kernels launched "
          f"{(attn, int4, int8)} in the decode-op run")
    saved = pa.paged_attention
    pa.paged_attention = pa.paged_attention_plain
    try:
        t1 = time.perf_counter()
        refs = run(start)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t1
    finally:
        pa.paged_attention = saved
    check(all(torch.equal(a, c) and torch.equal(bb, d)
              for (a, bb), (c, d) in zip(caches, start)),
          "decode op: caches differ from the plain-route run")
    worst, werr = 0.0, 0.0
    for o, r in zip(outs, refs):
        err, ratio = ulp_agreement(o, r, DECODE_ATOL)
        worst, werr = max(worst, ratio), max(werr, err)
    check(worst <= 1.0, f"decode op: last step off the plain route by "
          f"{werr} ({worst:.2f}x the allowance)")
    # the legacy A/B: the ragged kernel on the same caches and lengths
    lens_last = lens0 + DECODE_STEPS          # after the last append
    q_last = qkv[DECODE_STEPS - 1, :, :, 0]   # [L, B, H, D]
    tab_d = torch.as_tensor(tables).cuda()
    lens_d = torch.as_tensor(lens_last).cuda()
    ab = 0.0
    for li in range(L):
        kc, vc = caches[li]
        q = q_last[li].contiguous()
        rg = pa.ragged_paged_attention(q, kc, vc, tab_d, lens_d).float()
        lg = pa.paged_attention(q, kc, vc, tab_d, lens_d).float()
        check(torch.allclose(lg, rg, rtol=AB_TOL, atol=AB_TOL),
              f"layer {li}: legacy vs ragged off by "
              f"{float((lg - rg).abs().max())}")
        ab = max(ab, float((lg - rg).abs().max()))
    q = q_last[0].contiguous()
    kc, vc = caches[0]
    legacy_ms = time_ms(lambda: pa.paged_attention(q, kc, vc, tab_d, lens_d))
    ragged_ms = time_ms(lambda: pa.ragged_paged_attention(q, kc, vc, tab_d,
                                                          lens_d))
    legacy_ms2 = time_ms(lambda: pa.paged_attention(q, kc, vc, tab_d,
                                                    lens_d))
    print(f"  block_multihead_attention: {DECODE_STEPS} steps x {L} layers "
          f"at B={b} in {wall:.3f} s ({wall / DECODE_STEPS * 1e3:.2f} "
          f"ms/step; plain route {plain_wall:.3f} s); decode kernel "
          f"launches {k7} = {L} x {DECODE_STEPS}; last step vs plain "
          f"route err {werr:.3e} (worst {worst:.3f}); caches equal", flush=True)
    print(f"  legacy vs ragged at the last step: max |diff| {ab:.3e} (tol "
          f"{AB_TOL:g}); one layer's call: legacy {legacy_ms:.4f} ms (again "
          f"{legacy_ms2:.4f}), ragged {ragged_ms:.4f} ms", flush=True)
    n_prof = min(8, DECODE_STEPS)        # the trace's size bounds its cost
    profile = profile_window(torch, lambda: (run(caches, n_prof), n_prof)[1],
                             "decode steps")
    k7_ms = None
    if profile.get("device_ms_by_class"):
        k7_ms = profile["device_ms_by_class"].get(
            "paged_decode_attention", 0.0) / profile["steps"]
        print(f"  decode kernel device time: {k7_ms:.4f} ms per decode step "
              f"({L} launches)", flush=True)
    del caches, start, qkv, outs, refs
    torch.cuda.empty_cache()
    return {"steps": DECODE_STEPS, "launches": k7, "wall_s": wall,
            "ms_per_step": wall / DECODE_STEPS * 1e3,
            "plain_route_wall_s": plain_wall, "worst_over_allowed": worst,
            "legacy_vs_ragged_max_diff": ab, "legacy_ms": legacy_ms,
            "legacy_ms_again": legacy_ms2, "ragged_ms": ragged_ms,
            "profile": profile, "k7_device_ms_per_step": k7_ms}


# -- phase 17: int8 serving ---------------------------------------------------

INT8_ATOL = 1e-4        # f32 sums of the same exact products in another
                        # order, then the same f32 scale; two bf16 ulps of
                        # |ref| on top, as for int4


@contextlib.contextmanager
def plain_int8():
    """Route the engine's weight-only GEMM through the plain version on the
    card (the reference path of phase 17's f32 parity); restores it."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops import quant_matmul as qm
    saved = inference.weight_only_matmul
    inference.weight_only_matmul = qm.weight_only_matmul_plain
    try:
        yield
    finally:
        inference.weight_only_matmul = saved


def int8_kernel_rows(torch):
    from paddle_tpu_torch.ops import work
    from paddle_tpu_torch.ops import quant_matmul as qm
    rows = []
    rng = np.random.default_rng(17)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    for m in (8, 128, 512):
        for k, n in ((E, (H + 2 * KVH) * D), (H * D, E), (E, 2 * F), (F, E)):
            w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
            sc = np.abs(w).max(0) / 127.0 + 1e-9
            q = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
            bn = qm.pick_block_n(n, "int8")
            w8 = torch.as_tensor(q).cuda()
            s = torch.as_tensor(sc.astype(np.float32)).cuda()
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            out = qm.weight_only_matmul(x, w8, s, "int8", bn)
            ref = qm.weight_only_matmul_plain(x, w8, s, "int8", bn)
            torch.cuda.synchronize()
            err, ratio = bf16_agreement(out, ref, INT8_ATOL)
            name = f"M{m}_K{k}_N{n}"
            check(ratio <= 1.0, f"int8 {name}: max abs err {err}, an "
                  f"element off by {ratio:.2f}x its allowance")
            ms = time_ms(lambda: qm.weight_only_matmul(x, w8, s, "int8", bn))
            plain_ms = time_ms(lambda: qm.weight_only_matmul_plain(
                x, w8, s, "int8", bn), iters=20)
            s16 = s.bfloat16()
            lib_ms = time_ms(lambda: x @ (w8.to(torch.bfloat16) * s16))
            wdq = w8.to(torch.bfloat16) * s16
            mm_ms = time_ms(lambda: torch.matmul(x, wdq))
            del wdq
            b_ms, b_by = bound(*work.weight_only_matmul(m, k, n, 8))
            plan = qm.plan(m, k, n, x.dtype)
            dev = device_times(
                lambda: qm.weight_only_matmul(x, w8, s, "int8", bn),
                lambda: qm.weight_only_matmul_plain(x, w8, s, "int8", bn),
                lambda: x @ (w8.to(torch.bfloat16) * s16))
            rows.append(dict(case=name, max_abs_err=err, atol=INT8_ATOL,
                             worst_err_over_allowed=ratio, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, bf16_matmul_ms=mm_ms,
                             plan=plan, **dev))
            print(f"  weight_only_int8[{name}]: err {err:.3e} (worst "
                  f"{ratio:.3f} of atol {INT8_ATOL:g} + 2 bf16 ulps) kernel "
                  f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
                  f"({b_by}) dequant+matmul {lib_ms:.4f} ms (matmul on a "
                  f"bf16 copy {mm_ms:.4f}); {plan_text(plan)}; "
                  f"{device_text(dev)}", flush=True)
    return rows


def decode_tps(eng, ids, new):
    """Dense greedy generate() tokens/s (host clock; generate returns host
    tokens, so the device has finished), after one warm-up call."""
    eng.generate(ids, max_new_tokens=4)
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new)
    dt = time.perf_counter() - t0
    check(out.shape == (ids.shape[0], new), f"generate gave {out.shape}")
    return ids.shape[0] * new / dt


def phase_int8(torch):
    """Phase 17: kernel rows, int8 serving, dense decode, f32 parity.
    Returns (kernel rows, stats)."""
    rows = int8_kernel_rows(torch)
    w = llama_weights(8, L)
    eng_q = make_engine(w, "bfloat16", weight_quant="int8")
    check(set(eng_q.quant_routes.values()) == {"kernel"},
          f"int8 engine routes {eng_q.quant_routes}: every flagship width "
          "fits a kernel block")
    eng_f = make_engine(dequantized_weights(eng_q, w, "int8"), "bfloat16")
    reqs = requests(9, 6)
    width = max(len(p) for p, _ in reqs)
    ids = np.zeros((len(reqs), width), np.int32)
    for i, (p, _) in enumerate(reqs):
        ids[i, :len(p)] = p
    lens = torch.as_tensor([len(p) for p, _ in reqs]).cuda()
    lq = eng_q._prefill_logits(ids, lens=lens).float()
    lf = eng_f._prefill_logits(ids, lens=lens).float()
    err = float((lq - lf).abs().max())
    scale = float(lf.abs().max())
    # as phase 4: the kernel scales in its f32 epilogue, the float engine
    # multiplies bf16-rounded dequantized weights; 24 layers: 5% of the
    # logit range
    tol = 0.05 * scale
    agree = float((lq.argmax(-1) == lf.argmax(-1)).float().mean())
    print(f"  int8 vs dequantized-float first-step logits: max abs diff "
          f"{err:.4e} (tol {tol:.4e}, logit max {scale:.4e}), argmax "
          f"agreement {agree:.2f}", flush=True)
    check(bool(torch.isfinite(lq).all()), "int8 logits non-finite")
    check(err <= tol, f"int8 logits differ by {err} > {tol}")
    del eng_f
    torch.cuda.empty_cache()
    serve(eng_q, requests(99, 2, prompt=(16, 80), new=(2, 4)))   # warm-up
    reset_counts()
    cb, greqs, steps, wall = serve(eng_q, reqs)
    attn, int4 = read_counts()
    k7, int8 = read_decode_counts()
    check(int8 == 4 * L * steps, f"int8 kernel launched {int8} times in "
          f"{steps} paged steps (want {4 * L * steps})")
    check(attn == L * steps and int4 == 0 and k7 == 0,
          f"ragged / int4 / decode launches {(attn, int4, k7)} in {steps} "
          f"int8 steps (want {(L * steps, 0, 0)})")
    toks = sum(len(cb.finished[r.request_id]) for r in greqs)
    print(f"  int8 serving: {len(greqs)} requests -> {toks} tokens in "
          f"{steps} paged steps, {wall:.3f} s ({toks / wall:.1f} tokens/s, "
          f"{wall / steps * 1e3:.2f} ms/step); int8 kernel launches {int8} "
          f"= 4 x {L} x {steps}", flush=True)
    profile = profile_window(torch, lambda: serve(
        eng_q, requests(10, 2, prompt=(16, 64), new=(8, 8)))[2],
        "paged steps")
    # dense decode at bench.py's int8 leg (bench.py:149-189)
    rng = np.random.default_rng(0)
    dids = rng.integers(0, V, (8, 16)).astype(np.int32)
    tps = {"int8": decode_tps(eng_q, dids, 64)}
    del eng_q, cb
    torch.cuda.empty_cache()
    for quant in (None, "int4"):
        eng = make_engine(w, "bfloat16", weight_quant=quant)
        tps[quant or "bf16"] = decode_tps(eng, dids, 64)
        del eng
        torch.cuda.empty_cache()
    print(f"  dense decode B=8, 16-token prompts, 64 new tokens: tokens/s "
          f"int8 {tps['int8']:.1f}, bf16 {tps['bf16']:.1f}, int4 "
          f"{tps['int4']:.1f}", flush=True)
    parity = int8_f32_parity(torch)
    narrow = narrow_quant_routes(torch)
    return rows, {"steps": steps, "int8_launches": int8, "tokens_per_s":
                  toks / wall, "ms_per_step": wall / steps * 1e3,
                  "logit_diff": err, "logit_tol": tol,
                  "decode_tokens_per_s": tps, "profile": profile,
                  "f32_parity": parity, "narrow_widths": narrow}


def narrow_quant_routes(torch):
    """Quantized engines at ``LlamaConfig.tiny``'s widths (E=64, F=128) on
    the card: lin and ffn2 (64 wide) fit no 128-column block, so every
    projection takes the dequant route, as in the JAX engine, and no GEMM
    kernel launches."""
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    from paddle_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(13)
    v, e, h, g, d, f, layers = 128, 64, 4, 2, 16, 128, 2

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    w = dict(ln_scales=[np.ones(e, np.float32)] * layers,
             qkv_weights=[mk(h + 2 * g, d, e) for _ in range(layers)],
             linear_weights=[mk(h * d, e) for _ in range(layers)],
             ffn_ln_scales=[np.ones(e, np.float32)] * layers,
             ffn1_weights=[mk(e, 2 * f) for _ in range(layers)],
             ffn2_weights=[mk(f, e) for _ in range(layers)],
             embedding=mk(v, e), lm_head=mk(e, v))
    ids = rng.integers(0, v, (2, 8)).astype(np.int32)
    out = {}
    for quant, counter in (("int8", "int8_launches"), ("int4", "launches")):
        eng = FusedMultiTransformerEngine(
            engine_weights_from_numpy(w, "cuda", "bfloat16"), num_heads=h,
            head_dim=d, max_seq_len=32, dtype="bfloat16", norm_type="rmsnorm",
            activation="swiglu", gqa_group_size=g, weight_quant=quant,
            device="cuda")
        want = dict.fromkeys(("qkv", "lin", "f1", "f2"), "dequant")
        check(eng.quant_routes == want, f"{quant} routes at E=64: "
              f"{eng.quant_routes} (want {want})")
        calls, inner = [], eng._kw["_mm"]

        def mm(z2d, wt, kind, li, _inner=inner):
            calls.append(kind)
            return _inner(z2d, wt, kind, li)

        mm.qkv_out = inner.qkv_out
        eng._kw["_mm"] = mm
        before = getattr(qm.weight_only_matmul, counter)
        toks = eng.generate(ids, max_new_tokens=8)
        torch.cuda.synchronize()
        launched = getattr(qm.weight_only_matmul, counter) - before
        check(launched == 0 and len(calls) > 0,
              f"{quant} at E=64: {launched} kernel launches for "
              f"{len(calls)} dequant-routed projections")
        check(toks.shape == (2, 8) and bool(((toks >= 0) & (toks < v)).all()),
              f"{quant} at E=64 decoded {toks}")
        out[quant] = {"kernel_launches": launched,
                      "dequant_calls": len(calls)}
        print(f"  {quant} at E=64: routes {eng.quant_routes}, {launched} "
              f"kernel launches, {out[quant]['dequant_calls']} dequant-"
              "routed projection calls", flush=True)
        del eng
    return out


def int8_f32_parity(torch):
    """An f32 L=2 int8 engine's greedy tokens through the kernel against
    the same engine on the plain route; a divergence must sit at a near
    tie (top-2 logit gap <= 1e-3, as in phase 3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = make_engine(llama_weights(11, 2), "float32", weight_quant="int8")
    check(set(eng.quant_routes.values()) == {"kernel"},
          f"f32 int8 engine routes {eng.quant_routes}")
    ids = np.random.default_rng(12).integers(1, V, (4, 16)).astype(np.int32)
    got = eng.generate(ids, max_new_tokens=16)
    with plain_int8():
        ref = eng.generate(ids, max_new_tokens=16)
    worst = 0.0
    for i in range(ids.shape[0]):
        if (got[i] == ref[i]).all():
            continue
        t = int(np.argmax(got[i] != ref[i]))
        prefix = np.concatenate([ids[i], ref[i, :t]])[None, :]
        with plain_int8():
            lg = eng._prefill_logits(prefix)[0].float()
        top = torch.topk(lg, 2).values
        gap = float(top[0] - top[1])
        worst = max(worst, gap)
        print(f"  f32 int8 row {i}: first differing token at step {t}, "
              f"top-2 logit gap {gap:.3e}", flush=True)
        check(gap <= 1e-3, f"f32 int8 row {i} diverges at step {t} with a "
              f"top-2 logit gap {gap} > 1e-3")
    equal = int((got == ref).all(axis=1).sum())
    print(f"  f32 int8 parity, L=2: {equal} of {ids.shape[0]} rows' 16 "
          f"tokens equal to the plain route", flush=True)
    del eng
    torch.cuda.empty_cache()
    return {"rows_equal": equal, "rows": int(ids.shape[0]),
            "largest_tie_gap": worst}


# -- phase 18: the training step's fused tier -------------------------------

# Gates of phase 18: every element within atol + 2 units in the last place
# (of its own dtype) of the plain version. atol covers f32 sums taken in
# another order: the norm's mean square and dot over H, the cross
# entropy's row sums over V (lse ~ 10: 1e-5), its sum of exp (S up to V:
# 1e-2), its totals over N rows and dw's column sums over R rows (a
# relative share of the largest element), and the one rounding that a
# fused multiply-add saves in dlogits (4 f32 ulps of the largest |dx|).
TIER_ATOL = 1e-6
CE_LOSS_ATOL_T = 1e-5
CE_SUM_ATOL = 1e-2
CE_TOTAL_RTOL = 1e-5
DW_RTOL = 1e-5


def ulps(t):
    """One unit in the last place of |t| in t's dtype, per element (f32)."""
    mant = {"torch.float32": 23, "torch.bfloat16": 7,
            "torch.float16": 10}[str(t.dtype)]
    return (t.float().abs().clamp_min(2.0 ** -126).log2().floor()
            - mant).exp2()


def two_ulp_agreement(out, ref, atol):
    """(max abs error, largest error over atol (a number or a tensor) + 2
    ulps of |ref| in out's dtype)."""
    err = (out.float() - ref.float()).abs()
    return float(err.max()), float((err / (atol + 2 * ulps(
        ref.to(out.dtype)))).max())


def tier_case(torch, kernel, name, run, plain, atols, nbytes, library=None,
              plain_iters=10, route=None, library_minus=None):
    """One phase-18 case: ``run()`` twice (bit-equal) and ``plain()`` on
    the same inputs, each output within its atol (a number, or a function
    of the plain output) + 2 ulps; device ms of the kernel, its plain
    version and ``library`` (one PyTorch call of the same function, or
    None; less ``library_minus``'s time where only a share of that call
    is the same function). ``route``: (the route the wrapper reports
    it passed to the kernel, the route the case names); the two must
    agree."""
    out1, out2, ref = run(), run(), plain()
    torch.cuda.synchronize()
    taken = None
    if route is not None:
        taken, planned = route()
        check(taken is not None and taken == planned,
              f"{kernel}[{name}]: took route {taken}, the case names "
              f"{planned}")
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"{kernel}[{name}]: two calls differ")
    err = ratio = 0.0
    for o, r, atol in zip(out1, ref, atols):
        check(bool(torch.isfinite(o).all()), f"{kernel}[{name}]: non-finite")
        e, q = two_ulp_agreement(o, r, atol(r) if callable(atol) else atol)
        err, ratio = max(err, e), max(ratio, q)
    check(ratio <= 1.0, f"{kernel}[{name}]: max abs err {err}, an element "
          f"off by {ratio:.2f}x its allowance")
    ms = device_time_ms(run)
    plain_ms = device_time_ms(plain, iters=plain_iters)
    lib_ms = None if library is None else device_time_ms(library) \
        if library_minus is None else library_share_ms(library, library_minus)
    b_ms, b_by = bound(nbytes, 0)
    print(f"  {kernel}[{name}]"
          + ("" if taken is None else f" route {taken}")
          + f": err {err:.3e} (worst {ratio:.3f} of atol + 2 ulps; two "
          f"calls bit-equal) device ms: kernel {ms:.4f} plain "
          f"{plain_ms:.4f} bound {b_ms:.4f} ({b_by})"
          + ("" if lib_ms is None else f" library {lib_ms:.4f}"), flush=True)
    return {"case": name, "route": taken, "max_abs_err": err,
            "worst_over_allowed": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


# phase 26 (a)'s rows a rank: fsdp 2 splits B = 8 into 4 rows of 2048
MESH_ROWS = MAX_BATCH // 2 * 2048

# kernel A's cases: (name, R, H, dtype name, residual, f32 output, the
# backward's route); the flagship's residual norm in bf16 and the first
# layer's (no residual), f32 (route "block"), H = 1000 (not a multiple of
# a warp's 1024) on a row count off any block, fused_rms_norm's f32
# output, phase 26 (a)'s rank (R = 8192, with and without the residual),
# Llama-7B's H = 4096 ("warps", 4 a row), one row of H = 8, H = 8200 past
# the register routes ("block"), and H = 1001, whose rows allow no
# 16-byte accesses ("block")
NORM_SPECS = (
    ("flagship_r16384_h1024", MAX_BATCH * 2048, E, "bfloat16", True, False,
     "warp"),
    ("flagship_first_norm", MAX_BATCH * 2048, E, "bfloat16", False, False,
     "warp"),
    ("f32_r16384_h1024", MAX_BATCH * 2048, E, "float32", True, False,
     "block"),
    ("h1000_r16383", 16383, 1000, "bfloat16", True, False, "warp"),
    ("fused_f32_out", MAX_BATCH * 2048, E, "bfloat16", True, True, "warp"),
    ("rank_r8192_h1024", MESH_ROWS, E, "bfloat16", True, False, "warp"),
    ("rank_first_norm_r8192", MESH_ROWS, E, "bfloat16", False, False,
     "warp"),
    ("h4096_r4096", 4096, 4096, "bfloat16", True, False, "warps"),
    ("h8_r1", 1, 8, "bfloat16", True, False, "warp"),
    ("h8200_r33", 33, 8200, "bfloat16", True, False, "block"),
    ("h1001_r7", 7, 1001, "bfloat16", True, False, "block"))


def norm_case(torch, gen, spec):
    """Kernel A's inputs, gates and bytes for one of NORM_SPECS: a dict
    with the forward's and backward's arguments (``fwd_args``,
    ``bwd_args`` in the wrappers' order), their atols, bytes, and the
    library calls (F.rms_norm after the add; its backward share)."""
    from paddle_tpu_torch.ops import work
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import fused_norm as fn
    name, r, hid, dtn, resid, f32_out, want_route = spec
    dt = getattr(torch, dtn)

    def rnd(*shape, dtype=dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    od = torch.float32 if f32_out else dt
    x, w = rnd(r, hid), 1 + 0.1 * rnd(hid, dtype=torch.float32)
    res = rnd(r, hid) if resid else None
    dout, dres = rnd(r, hid, dtype=od), rnd(r, hid) if resid else None
    eb, ob = torch.finfo(dt).bits // 8, torch.finfo(od).bits // 8
    _, h, inv = fn.rms_norm_fwd_plain(x, w, 1e-6, None, res, od)
    w_dt = w.to(dt)
    out_atol = TIER_ATOL
    if od != dt:
        # round_T(h * inv) may flip by one unit of T where inv differs
        # in its last bit; an f32 output keeps that unit times |w|
        n = (h.float() * inv[:, None]).to(dt)
        out_atol = TIER_ATOL + ulps(n) * w.abs()
    # dh + dres rounds twice on both sides; where the sum cancels, the
    # ulp that the norm's part may differ by is large beside the result
    dh_norm = fn.rms_norm_bwd_plain(dout, None, h, w, inv, od)[0]
    dh_atol = TIER_ATOL + 2 * ulps(dh_norm) if resid else TIER_ATOL
    hg, wg = h.detach().requires_grad_(), w_dt.detach().requires_grad_()
    dlib = dout.to(dt)

    def lib_fwd():
        with torch.enable_grad():
            return Fn.rms_norm(hg, (hid,), wg, 1e-6)

    def lib_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lib_fwd(), (hg, wg), dlib)
    return {"name": name, "fwd_args": (x, w, 1e-6, None, res, od),
            "bwd_args": (dout, dres, h, w, inv, od),
            "fwd_atols": (out_atol, 0.0, TIER_ATOL),
            "bwd_atols": (dh_atol,
                          lambda ref: DW_RTOL * float(ref.abs().max())),
            "fwd_bytes": work.rms_norm_fwd(r, hid, eb, ob, resid)[0],
            "bwd_bytes": work.rms_norm_bwd(r, hid, eb, ob, resid)[0],
            "lib_fwd": lambda: Fn.rms_norm(h, (hid,), w_dt, 1e-6),
            "lib_grad": lib_fwd_bwd, "lib_grad_minus": lib_fwd,
            "bwd_route": lambda: (fn.rms_norm_bwd.route, want_route)}


def norm_cases(torch, rows):
    """Kernel A forward and backward over NORM_SPECS, the backward's route
    printed and gated against the case's."""
    from paddle_tpu_torch.ops import fused_norm as fn
    gen = torch.Generator(device="cuda").manual_seed(81)
    for spec in NORM_SPECS:
        c = norm_case(torch, gen, spec)
        rows["fwd"].append(tier_case(
            torch, "fused_norm_fwd", c["name"],
            lambda: fn.rms_norm_fwd(*c["fwd_args"]),
            lambda: fn.rms_norm_fwd_plain(*c["fwd_args"]), c["fwd_atols"],
            c["fwd_bytes"], library=c["lib_fwd"]))
        rows["bwd"].append(tier_case(
            torch, "fused_norm_bwd", c["name"],
            lambda: fn.rms_norm_bwd(*c["bwd_args"]),
            lambda: fn.rms_norm_bwd_plain(*c["bwd_args"]), c["bwd_atols"],
            c["bwd_bytes"], library=c["lib_grad"],
            library_minus=c["lib_grad_minus"], route=c["bwd_route"]))
        del c


def swiglu_cases(torch, rows):
    """Kernel B forward and backward: the flagship's fused [R, 2 im]
    projection read in place, the two-tensor form, phase 26 (a)'s rank
    (its [gate_r | up_r] of F / mp = 1408 columns each on 8192 rows, read
    in place at a 2 x 1408 stride) and im = 1000 (off 8). No single
    PyTorch call computes SwiGLU: library_ms is null."""
    from paddle_tpu_torch.ops import work
    from paddle_tpu_torch.ops import swiglu as sw
    gen = torch.Generator(device="cuda").manual_seed(82)
    r0 = MAX_BATCH * 2048
    for name, r, im, fused in (("flagship_r16384_im2816", r0, F, True),
                               ("two_tensor_r16384_im2816", r0, F, False),
                               ("rank_fused_r8192_im1408", MESH_ROWS,
                                F // 2, True),
                               ("im1000_r4099", 4099, 1000, False)):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen,
                               device="cuda").bfloat16()
        if fused:
            gu = rnd(r, 2 * im)
            g, u = gu[:, :im], gu[:, im:]
        else:
            g, u = rnd(r, im), rnd(r, im)
        dout = rnd(r, im)
        rows["fwd"].append(tier_case(
            torch, "swiglu_fwd", name, lambda: (sw.swiglu_fwd(g, u),),
            lambda: (sw.swiglu_fwd_plain(g, u),), (TIER_ATOL,),
            work.swiglu_fwd(r, im)[0]))

        def bwd(fn):
            dg = torch.empty(r, 2 * im, dtype=torch.bfloat16, device="cuda")
            fn(dout, g, u, dg[:, :im], dg[:, im:])
            return (dg,)
        rows["bwd"].append(tier_case(
            torch, "swiglu_bwd", name, lambda: bwd(sw.swiglu_bwd),
            lambda: bwd(sw.swiglu_bwd_plain), (TIER_ATOL,),
            work.swiglu_bwd(r, im)[0]))


# kernel C's cases: (name, N, V, dtype name, label smoothing, every k-th
# row ignored or 0, the forward's route); the flagship's bf16 logits, the
# same in f32, phase 26 (a)'s rank (N = 8192), V = 32001 off 8 with
# ignored rows and smoothing (each row at another 16-byte phase), GPT-2's
# 50257 (off 8 too) and Llama-3's 128256
CE_SPECS = (
    ("flagship_n16384_v32000", MAX_BATCH * 2048, V, "bfloat16", 0.0, 0,
     "rows"),
    ("rank_n8192_v32000", MESH_ROWS, V, "bfloat16", 0.0, 0, "rows"),
    ("f32_n16384_v32000", MAX_BATCH * 2048, V, "float32", 0.0, 0,
     "cluster"),
    ("v32001_smooth_ignored", 4099, V + 1, "bfloat16", 0.1, 4, "rows"),
    ("v50257_smooth_ignored", 4099, 50257, "bfloat16", 0.1, 4, "cluster"),
    ("v128256_smooth_ignored", 4099, 128256, "bfloat16", 0.1, 4,
     "cluster"))


def ce_case(torch, gen, spec):
    """Kernel C's inputs, gates and bytes for one of CE_SPECS: a dict with
    the forward's and backward's arguments in the wrappers' order, their
    atols and bytes, and the library calls (F.cross_entropy; its backward
    share)."""
    from paddle_tpu_torch.ops import work
    import torch.nn.functional as Fn
    from paddle_tpu_torch.ops import token_ce as tc
    name, n, vocab, dtn, eps, ign, want_route = spec
    dt = getattr(torch, dtn)
    x = (2 * torch.randn(n, vocab, generator=gen, device="cuda")).to(dt)
    lab = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    if ign:
        lab[::ign] = -100
    g = torch.ones((), device="cuda")
    eb = torch.finfo(dt).bits // 8
    _, stats, totals = tc.token_ce_fwd_plain(x, lab, -100, eps)
    xg = x.detach().requires_grad_()

    def lib_fwd():
        with torch.enable_grad():
            return Fn.cross_entropy(xg, lab, ignore_index=-100,
                                    label_smoothing=eps)

    def lib_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(lib_fwd(), xg)
    return {"name": name, "fwd_args": (x, lab, -100, eps),
            "bwd_args": (x, lab, stats, g, totals, -100, eps, "mean"),
            "fwd_atols": (CE_LOSS_ATOL_T, CE_SUM_ATOL,
                          lambda ref: CE_TOTAL_RTOL * float(ref.abs().max())),
            "bwd_atols": (lambda ref: 2.0 ** -22 * float(ref.abs().max()),),
            "fwd_bytes": work.token_ce_fwd(n, vocab, eb)[0],
            "bwd_bytes": work.token_ce_bwd(n, vocab, eb)[0],
            "lib_fwd": lambda: Fn.cross_entropy(x, lab, ignore_index=-100,
                                                label_smoothing=eps),
            "lib_grad": lib_fwd_bwd, "lib_grad_minus": lib_fwd,
            "fwd_route": lambda: (tc.token_ce_fwd.route, want_route)}


def ce_nan_label_check(torch):
    """Kernel C's forward with labels outside [0, V) (V + 2 and -1) on
    each route ("rows" at 32000, "cluster" at 128256, "two-pass" at
    262145): those rows' losses NaN as in the plain version, every other
    row, the stats and the valid count within the gates. Returns the
    routes taken."""
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator(device="cuda").manual_seed(85)
    routes = []
    for vocab, want in ((V, "rows"), (128256, "cluster"),
                        (262145, "two-pass")):
        x = (2 * torch.randn(7, vocab, generator=gen, device="cuda")
             ).bfloat16()
        lab = torch.randint(0, vocab, (7,), generator=gen, device="cuda")
        lab[1], lab[3], lab[5] = vocab + 2, -1, -100
        loss, stats, totals = tc.token_ce_fwd(x, lab, -100, 0.1)
        rl, rs, rt = tc.token_ce_fwd_plain(x, lab, -100, 0.1)
        torch.cuda.synchronize()
        taken = tc.token_ce_fwd.route
        check(taken == want, f"token_ce_fwd[nan_label_v{vocab}]: took "
              f"route {taken}, not {want}")
        nan = torch.tensor([1, 3], device="cuda")
        keep = torch.tensor([0, 2, 4, 5, 6], device="cuda")
        check(bool(loss[nan].isnan().all()) and bool(rl[nan].isnan().all())
              and not bool(loss[keep].isnan().any()),
              f"token_ce_fwd[nan_label_v{vocab}]: NaN rows {loss.tolist()}")
        e1, q1 = two_ulp_agreement(loss[keep], rl[keep], CE_LOSS_ATOL_T)
        e2, q2 = two_ulp_agreement(stats, rs, CE_SUM_ATOL)
        check(max(q1, q2) <= 1.0 and float(totals[1]) == float(rt[1]) == 6,
              f"token_ce_fwd[nan_label_v{vocab}]: err {max(e1, e2)}, "
              f"{max(q1, q2):.2f}x the allowance, count {float(totals[1])}")
        print(f"  token_ce_fwd[nan_label_v{vocab}] route {taken}: labels "
              f"V + 2 and -1 give NaN as the plain version; the other rows "
              f"err {max(e1, e2):.3e} (worst {max(q1, q2):.3f})", flush=True)
        routes.append(taken)
    return routes


def token_ce_cases(torch, rows):
    """Kernel C forward and backward over CE_SPECS, the forward's route
    printed and gated against the case's; the library yardsticks are
    F.cross_entropy (forward) and its backward share (forward + backward
    minus forward) on the same logits. Then the labels outside [0, V)."""
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator(device="cuda").manual_seed(83)
    for spec in CE_SPECS:
        c = ce_case(torch, gen, spec)
        rows["fwd"].append(tier_case(
            torch, "token_ce_fwd", c["name"],
            lambda: tc.token_ce_fwd(*c["fwd_args"]),
            lambda: tc.token_ce_fwd_plain(*c["fwd_args"]), c["fwd_atols"],
            c["fwd_bytes"], library=c["lib_fwd"], route=c["fwd_route"]))
        rows["bwd"].append(tier_case(
            torch, "token_ce_bwd", c["name"],
            lambda: (tc.token_ce_bwd(*c["bwd_args"]),),
            lambda: (tc.token_ce_bwd_plain(*c["bwd_args"]),),
            c["bwd_atols"], c["bwd_bytes"], library=c["lib_grad"],
            library_minus=c["lib_grad_minus"]))
        del c
        torch.cuda.empty_cache()
    rows["nan_label_routes"] = ce_nan_label_check(torch)


def adamw_case(torch):
    """Kernel D over the flagship's 373.9M parameters (f32 masters,
    moments and grads, clip active): p, m, v and gnorm within 2 f32 ulps
    of the foreach passes, two runs from the same state bit-equal; the
    library yardstick is clip_grad_norm_(foreach=True) then
    torch.optim.AdamW(fused=True).step()."""
    from paddle_tpu_torch.ops import work
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    from paddle_tpu_torch.ops import adamw as ad
    cfg, _, _ = pretrain.flagship_config()
    shapes = [tuple(p.shape) for p in LlamaForCausalLM(
        cfg, device="cuda", seed=0).parameters()]
    gen = torch.Generator(device="cuda").manual_seed(84)

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    p0 = [rnd(s, 0.02) for s in shapes]
    g0 = [rnd(s, 1e-3) for s in shapes]
    m0 = [rnd(s, 1e-4) for s in shapes]
    v0 = [rnd(s, 1e-4) ** 2 for s in shapes]
    decay = [len(s) >= 2 for s in shapes]
    hp = (3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0, 3)
    n = sum(math.prod(s) for s in shapes)

    def state():
        return ([t.clone() for t in p0], [t.clone() for t in m0],
                [t.clone() for t in v0])
    runs = []
    for fn in (ad.adamw_step, ad.adamw_step, ad.adamw_step_plain):
        ps, ms, vs = state()
        gn = fn(ps, g0, ms, vs, decay, *hp)
        runs.append((ps, ms, vs, gn))
        torch.cuda.synchronize()
    (k1, k2, ref) = runs
    same = all(torch.equal(a, b) for x, y in zip(k1[:3], k2[:3])
               for a, b in zip(x, y)) and torch.equal(k1[3], k2[3])
    check(same, "adamw: two runs from the same state differ")
    err = ratio = 0.0
    worst = None
    for what, xs, ys in zip("pmv", k1[:3], ref[:3]):
        for i, (a, b) in enumerate(zip(xs, ys)):
            e, q = two_ulp_agreement(a, b, 0.0)
            if q > ratio:
                j = int(((a - b).abs() / (2 * ulps(b))).argmax())
                worst = (what, i, j, float(a.flatten()[j]),
                         float(b.flatten()[j]), float(p0[i].flatten()[j]),
                         float(g0[i].flatten()[j]), float(m0[i].flatten()[j]),
                         float(v0[i].flatten()[j]))
            err, ratio = max(err, e), max(ratio, q)
    ge, gq = two_ulp_agreement(k1[3].reshape(1), ref[3].reshape(1), 0.0)
    print(f"  adamw: gnorm kernel {float(k1[3]):.9g} plain "
          f"{float(ref[3]):.9g} ({gq:.3f} of 2 ulps); p, m, v worst "
          f"{ratio:.3f} of 2 ulps (max abs err {err:.3e}); the worst "
          f"element (tensor, param, index, kernel, plain, p0, g, m0, v0): "
          f"{worst}", flush=True)
    check(ratio <= 1.0 and gq <= 1.0, f"adamw: p / m / v off by {ratio:.2f}x"
          f", gnorm by {gq:.2f}x their 2-ulp allowance")
    mesh_row = adamw_mesh_case(torch, state, g0, decay, hp)
    ps, ms, vs = state()
    ms_k = device_time_ms(lambda: ad.adamw_step(ps, g0, ms, vs, decay, *hp),
                          iters=20)
    ps, ms, vs = state()
    ms_p = device_time_ms(
        lambda: ad.adamw_step_plain(ps, g0, ms, vs, decay, *hp), iters=5)
    del ps, ms, vs, runs, k1, k2, ref
    params = [torch.nn.Parameter(t.clone()) for t in p0]
    for prm, g in zip(params, g0):
        prm.grad = g.clone()
    opt = torch.optim.AdamW(params, lr=hp[0], betas=hp[1:3], eps=hp[3],
                            weight_decay=hp[4], fused=True)

    def library():
        torch.nn.utils.clip_grad_norm_(params, hp[5], foreach=True)
        opt.step()
    ms_l = device_time_ms(library, iters=20)
    nbytes = work.adamw(n)[0]       # p, g, m, v read; p, m, v written
    b_ms, b_by = bound(nbytes, 0)
    print(f"  adamw[flagship_{n / 1e6:.1f}M]: device ms kernel {ms_k:.4f} "
          f"plain {ms_p:.4f} bound {b_ms:.4f} ({b_by}) library "
          f"{ms_l:.4f}", flush=True)
    del params, opt, p0, g0, m0, v0
    torch.cuda.empty_cache()
    return [{"case": f"flagship_{n / 1e6:.1f}M", "max_abs_err": err,
             "worst_over_allowed": max(ratio, gq), "ms": ms_k,
             "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": ms_l}, mesh_row]


def adamw_mesh_case(torch, state, g0, decay, hp):
    """Kernel D's mesh form (phase 26's step) on the flagship's tensors:
    every other tensor owned, ``reduce`` doubling the sums in place (two
    ranks holding the same shards) and the telemetry on, against the
    plain version's mesh form: p, m, v and gnorm within 2 f32 ulps, the
    packed vector within 4 f32 ulps (f64 sums in another order)."""
    from paddle_tpu_torch.ops import adamw as ad
    owned = [i % 2 == 0 for i in range(len(g0))]
    groups = [i % 4 for i in range(len(g0))]
    loss = torch.tensor(2.5, device="cuda")

    def double(t):
        return t.mul_(2.0)
    runs = []
    for fn in (ad.adamw_step, ad.adamw_step):
        ps, ms, vs = state()
        gn, vec = fn(ps, g0, ms, vs, decay, *hp, groups=groups, loss=loss,
                     owned=owned, reduce=double)
        runs.append((ps, ms, vs, gn, vec))
    ps, ms, vs = state()
    old = [p.clone() for p in ps]
    gn = ad.adamw_step_plain(ps, g0, ms, vs, decay, *hp, owned, double)
    vec = ad.pack_telemetry_plain(loss, gn, g0, old, ps, groups, owned,
                                  double)
    torch.cuda.synchronize()
    k1, k2 = runs
    same = all(torch.equal(a, b) for a, b in zip(k1[3:], k2[3:])) and all(
        torch.equal(a, b) for x, y in zip(k1[:3], k2[:3])
        for a, b in zip(x, y))
    check(same, "adamw mesh form: two runs from the same state differ")
    err = ratio = 0.0
    for xs, ys in zip(k1[:3], (ps, ms, vs)):
        for a, b in zip(xs, ys):
            e, q = two_ulp_agreement(a, b, 0.0)
            err, ratio = max(err, e), max(ratio, q)
    ge, gq = two_ulp_agreement(k1[3].reshape(1), gn.reshape(1), 0.0)
    ve, vq = two_ulp_agreement(k1[4], vec, 0.0)
    print(f"  adamw mesh form: gnorm kernel {float(k1[3]):.9g} plain "
          f"{float(gn):.9g} ({gq:.3f} of 2 ulps); p, m, v worst {ratio:.3f} "
          f"of 2 ulps; telemetry vector worst {vq / 2:.3f} of 4 ulps",
          flush=True)
    check(ratio <= 1.0 and gq <= 1.0 and vq <= 2.0,
          f"adamw mesh form: p / m / v off by {ratio:.2f}x, gnorm by "
          f"{gq:.2f}x their 2-ulp allowance, the vector by {vq:.2f}x 2 ulps")
    del runs, k1, k2, ps, ms, vs, old
    return {"case": "mesh_form_owned_half", "max_abs_err": max(err, ge, ve),
            "worst_over_allowed": max(ratio, gq, vq / 2)}


def phase_fused_tier(torch):
    """Phase 18: kernels A-D against their plain versions (module
    docstring); A's backward and C's forward on every route their plans
    name. Returns {kernel: rows}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {k: [] for k in ("norm_fwd", "norm_bwd", "swiglu_fwd",
                            "swiglu_bwd", "ce_fwd", "ce_bwd")}
    with torch.no_grad():
        for key, fn in (("norm", norm_cases), ("swiglu", swiglu_cases),
                        ("ce", token_ce_cases)):
            part = {"fwd": [], "bwd": []}
            fn(torch, part)
            rows[f"{key}_fwd"], rows[f"{key}_bwd"] = part["fwd"], part["bwd"]
            torch.cuda.empty_cache()
        nan_routes = part["nan_label_routes"]
        rows["adamw"] = adamw_case(torch)
    taken = ({r["route"] for r in rows["norm_bwd"]},
             {r["route"] for r in rows["ce_fwd"]} | set(nan_routes))
    print(f"  routes taken: fused_norm_bwd {sorted(taken[0])}, token_ce_fwd "
          f"{sorted(taken[1])}", flush=True)
    check(taken == ({"warp", "warps", "block"},
                    {"rows", "cluster", "two-pass"}),
          f"phase 18 took routes {taken}, not every route of the plans")
    return rows


# -- phases 21-22: recompute, the telemetry and the health monitor ----------

TEL_RTOL = 1e-5         # packed telemetry vector, kernel D vs plain: f64
                        # sums in another order, each rounded to f32 once
RECOMPUTE_GNORM_RTOL = 1e-2   # grad norms vs phase 7: K2's dq sums in f32
                              # atomics, so gradients differ run to run
F32_EPS = 2.0 ** -23
RECOMPUTE_SPREAD_K = 4        # step-0 gradients: each tensor within 4x its
                              # spread over two repeats of phase 7's step 0


def flagship_batches(cfg, batch, seq, n):
    """Phase 7's host batches (bench.py's rule: a fresh random batch each
    step, from seed 0), as numpy."""
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq)),
             "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
            for _ in range(n)]


def train_flops_per_token(cfg, n_params, seq):
    """bench.py's flops per trained token (bench.py:85-87)."""
    return 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq


def step0_grad_rel(torch, ref, m, gnorm, clip):
    """{tensor: relative error} of one run's step-0 gradients against
    ``ref`` = (its gnorm, {tensor: first moment on the host}). After one
    AdamW step the first moment is (1 - b1) x the clipped gradient, so each
    side's clip scale min(1, clip / (gnorm + 1e-6)) is taken out first."""
    scale = min(1.0, clip / (ref[0] + 1e-6)) / min(1.0, clip / (gnorm + 1e-6))
    rel = {}
    for n, t in m.items():
        r = ref[1][n].to(t.device)
        rel[n] = float((t * scale - r).norm() / r.norm())
    return rel


def phase_recompute(torch, base):
    """Phase 21: phase 7's run with ``recompute`` True and
    "dots_saveable" (2 warm-up and 3 timed steps on phase 7's batches):
    the step-0 loss bit-equal to phase 7's, the forward-side kernels
    launched twice (flash forward 48 a step), grad norms within
    RECOMPUTE_GNORM_RTOL of phase 7's at the same step, each tensor's
    step-0 gradient within RECOMPUTE_SPREAD_K times its spread over two
    repeats of phase 7's step 0 (K2's dq atomics: the only difference a
    correct recompute leaves), and peak memory below phase 7's. Returns
    {mode: stats}."""
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain

    def first_step(mode):
        cfg, batch, seq = pretrain.flagship_config()
        cfg.recompute = mode
        model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        params, opt_state, meta = pretrain.make_train_state(model, None)
        step = pretrain.make_train_step(model, None, meta)
        host = flagship_batches(cfg, batch, seq, 1)[0]
        _, opt_state, loss, gnorm = step(params, opt_state,
                                         pretrain.batch_to_device(host))
        return float(loss), float(gnorm), opt_state["m"], meta["grad_clip"]

    # phase 7's step 0 from a fresh model: the reference, then two repeats
    # whose error against it is each tensor's run-to-run spread
    loss, gnorm, m, clip = first_step(False)
    check(loss == base["losses"][0], f"phase 7's step 0 again: loss "
          f"{loss!r} is not phase 7's {base['losses'][0]!r}")
    ref = (gnorm, {n: t.cpu() for n, t in m.items()})
    del m
    spread = {}
    for _ in range(2):
        _, gnorm, m, _ = first_step(False)
        for n, r in step0_grad_rel(torch, ref, m, gnorm, clip).items():
            # a tensor that no dq reaches differs only by the rounding of
            # the scale: one f32 epsilon is its floor
            spread[n] = max(spread.get(n, F32_EPS), r)
        del m
    torch.cuda.empty_cache()
    lo, hi = min(spread, key=spread.get), max(spread, key=spread.get)
    print(f"  step-0 gradients of phase 7 run twice more against a third: "
          f"relative spread {spread[lo]:.3e} ({lo}) to {spread[hi]:.3e} "
          f"({hi}); limit {RECOMPUTE_SPREAD_K} x each tensor's",
          flush=True)
    out = {}
    for mode in (True, "dots_saveable"):
        cfg, batch, seq = pretrain.flagship_config()
        cfg.recompute = mode
        model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        params, opt_state, meta = pretrain.make_train_state(model, None)
        step = pretrain.make_train_step(model, None, meta)
        n_params = sum(p.numel() for p in params.values())
        host = flagship_batches(cfg, batch, seq, 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, gnorms = [], []
        for b in host[:2]:                                  # warm-up
            params, opt_state, loss, gnorm = step(
                params, opt_state, pretrain.batch_to_device(b))
            losses.append(float(loss))
            gnorms.append(float(gnorm))
            if len(losses) == 1:
                rel0 = step0_grad_rel(torch, ref, opt_state["m"], gnorms[0],
                                      clip)
        worst = max(rel0, key=lambda n: rel0[n] / spread[n])
        check(all(rel0[n] <= RECOMPUTE_SPREAD_K * spread[n] for n in rel0),
              f"recompute={mode!r}: step-0 gradient of {worst} "
              f"{rel0[worst]:.3e} relative to phase 7's, over "
              f"{RECOMPUTE_SPREAD_K} x its spread {spread[worst]:.3e}")
        timed = 3
        batches = [pretrain.batch_to_device(b) for b in host[2:]]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = []
        for b in batches:
            params, opt_state, loss, gnorm = step(params, opt_state, b)
            res.append((loss, gnorm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = read_flash_counts()
        tier = read_tier_counts()
        losses += [float(x) for x, _ in res]
        gnorms += [float(g) for _, g in res]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        nl = cfg.num_hidden_layers
        check((fwd, bwd) == (2 * nl * timed, nl * timed),
              f"recompute={mode!r}: flash launched fwd {fwd} / bwd {bwd} "
              f"times in {timed} steps (want {2 * nl} / {nl} a step)")
        per = tier_counts_per_step(cfg, False)
        want = tuple(timed * n for n in (per[0] + 2 * nl, per[1],
                                         per[2] + nl, per[3], per[4],
                                         per[5], per[6]))
        check(tier == want, f"recompute={mode!r}: fused tier launches "
              f"{tier} in {timed} steps (want {want}: the forward-side "
              "kernels of the layers twice)")
        check(losses[0] == base["losses"][0],
              f"recompute={mode!r}: step-0 loss {losses[0]!r} is not "
              f"phase 7's {base['losses'][0]!r}")
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"recompute={mode!r}: non-finite loss / grad norm: {losses} "
              f"{gnorms}")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(gnorms, base["grad_norms"]))
        check(rel <= RECOMPUTE_GNORM_RTOL,
              f"recompute={mode!r}: grad norms {gnorms} vs phase 7's "
              f"{base['grad_norms']} (worst relative {rel:.3e})")
        check(peak_gb < base["peak_memory_gb"],
              f"recompute={mode!r}: peak memory {peak_gb:.2f} GB is not "
              f"below phase 7's {base['peak_memory_gb']:.2f} GB")
        tokens_per_s = batch * seq * timed / wall
        mfu = train_flops_per_token(cfg, n_params, seq) * tokens_per_s / \
            BF16_FLOPS_PER_S
        print(f"  recompute={mode!r}: {tokens_per_s:.1f} tokens/s, "
              f"{wall / timed * 1e3:.1f} ms/step, MFU {mfu:.4f} (phase 7's "
              "flops per token, the recomputed forward not counted), peak "
              f"memory {peak_gb:.2f} GB; beside phase 7: "
              f"{base['tokens_per_s']:.1f} tokens/s, "
              f"{base['ms_per_step']:.1f} ms/step, MFU {base['mfu']:.4f}, "
              f"{base['peak_memory_gb']:.2f} GB", flush=True)
        print(f"    flash fwd / bwd {fwd} / {bwd} in {timed} steps; fused "
              f"tier {tier}; step-0 loss {losses[0]!r} (phase 7 "
              f"{base['losses'][0]!r}); grad norms "
              f"{['%.5f' % g for g in gnorms]} (worst relative to phase 7 "
              f"{rel:.2e}); step-0 gradients {min(rel0.values()):.3e} to "
              f"{max(rel0.values()):.3e} relative to phase 7's, worst "
              f"against its spread {worst} at "
              f"{rel0[worst] / spread[worst]:.2f} x", flush=True)
        spare = iter(batches)

        def one_step():
            nonlocal params, opt_state
            params, opt_state, loss, _ = step(params, opt_state, next(spare))
            float(loss)
            return 1

        prof = profile_window(torch, one_step, f"recompute={mode!r} step")
        out[str(mode)] = {
            "tokens_per_s": tokens_per_s, "ms_per_step": wall / timed * 1e3,
            "mfu": mfu, "peak_memory_gb": peak_gb, "losses": losses,
            "grad_norms": gnorms, "flash_fwd_launches": fwd,
            "flash_bwd_launches": bwd, "tier_launches": list(tier),
            "grad_norm_worst_rel": rel,
            "step0_grad_rel": [min(rel0.values()), max(rel0.values())],
            "step0_worst_vs_spread": [worst, rel0[worst] / spread[worst]],
            "profile": prof}
        del model, params, opt_state, batches, res, step, spare
        torch.cuda.empty_cache()
    out["step0_spread"] = [spread[lo], spread[hi]]
    return out


def health_config():
    """tools/train_health.json's monitor block."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "train_health.json")
    with open(path) as f:
        return json.load(f)["monitor"]


def _collate_rows(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def telemetry_train(torch, base):
    """Phase 22 (a): the flagship with telemetry every step and a
    TrainHealthMonitor, fed through the port's DataLoader (two workers,
    instrument=True), 6 steps on phase 7's batches; then the NaN'd-batch
    leg from a fresh model."""
    import shutil
    import tempfile
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    from paddle_tpu_torch.observability import train_health as th
    from paddle_tpu_torch.ops import adamw
    from paddle_tpu_torch.testing import TrainFaultInjector
    cfg, batch, seq = pretrain.flagship_config()
    mon_cfg = health_config()
    steps = 6
    flight_dir = tempfile.mkdtemp(prefix="smoke_health_")
    try:
        flight = obs.FlightRecorder(min_interval_s=0.0)
        flight.arm(flight_dir)
        # the healthy run's stall threshold, as the gate's healthy leg:
        # the workers' first batch comes after their start-up
        mon = obs.TrainHealthMonitor.from_config(
            mon_cfg, flight_recorder=flight, data_stall_s=30.0)
        model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        params, opt_state, meta = pretrain.make_train_state(model, None)
        step = pretrain.make_train_step(model, None, meta, monitor=mon)
        labels = step._telemetry_spec.labels
        samples = []
        for b in flagship_batches(cfg, batch, seq, steps):
            samples += [{k: v[j] for k, v in b.items()}
                        for j in range(batch)]
        loader = DataLoader(samples, batch_size=batch, num_workers=2,
                            instrument=True, collate_fn=_collate_rows)
        loader.health_monitor = mon
        th.pop_data_wait()
        reg = obs.get_registry()
        waits0 = reg.histogram("train_data_wait_seconds").count
        losses, gnorms = [], []
        t0 = None
        for i, b in enumerate(loader):
            if i == 2:
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
            params, opt_state, loss, gnorm = step(
                params, opt_state, pretrain.batch_to_device(b))
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        torch.cuda.synchronize()
        timed = steps - 2
        wall = time.perf_counter() - t0
        launches = (adamw.adamw_step.launches,
                    adamw.adamw_step.telemetry_launches)
        snap = reg.snapshot()

        def gauges(name):
            return {k: v["value"] for k, v in
                    snap.get(name, {}).get("children", {}).items()}
        norms = {f: gauges(f"train_group_{f}")
                 for f in ("grad_norm", "param_norm", "update_ratio")}
        batches_seen = reg.histogram("train_data_wait_seconds").count - \
            waits0
        check(mon.steps_observed == steps and mon.breaches_total == 0,
              f"telemetry run: {mon.steps_observed} steps observed, "
              f"breaches {mon.breach_counts}")
        want_labels = ("embed", "blocks_00_05", "blocks_06_11",
                       "blocks_12_17", "blocks_18_23", "norm_bias", "head")
        check(labels == want_labels and all(
            set(v) == set(want_labels) for v in norms.values()),
            f"telemetry groups {labels} / gauges "
            f"{ {k: sorted(v) for k, v in norms.items()} } (want "
            f"{want_labels})")
        check(all(math.isfinite(x) for v in norms.values()
                  for x in v.values()),
              f"non-finite group norms: {norms}")
        check(losses[0] == base["losses"][0],
              f"telemetry run: step-0 loss {losses[0]!r} is not phase 7's "
              f"{base['losses'][0]!r}")
        check(launches == (2 * timed, 2 * timed),
              f"kernel D launched {launches[0]} times ({launches[1]} with "
              f"the telemetry) in {timed} steps (want {2 * timed} each)")
        check(batches_seen == steps, f"the instrumented loader counted "
              f"{batches_seen} batches (want {steps})")
        ms = wall / timed * 1e3
        print(f"  telemetry every step + monitor + DataLoader(num_workers=2,"
              f" instrument=True): {ms:.1f} ms/step (phase 7: "
              f"{base['ms_per_step']:.1f}), {batch * seq / ms * 1e3:.1f} "
              f"tokens/s; 0 breaches over {steps} steps; kernel D "
              f"{launches[0]} launches in {timed} steps; step-0 loss "
              f"{losses[0]!r}", flush=True)
        print("    groups (grad norm / param norm / update ratio): "
              + ", ".join(f"{g} {norms['grad_norm'][g]:.4f} / "
                          f"{norms['param_norm'][g]:.2f} / "
                          f"{norms['update_ratio'][g]:.2e}"
                          for g in want_labels), flush=True)
        # the same vector computed every step but fetched once: the cost
        # of the per-step fetch (a sync) apart from kernel D's share
        sparse = pretrain.make_train_step(model, None, meta, telemetry=True,
                                          telemetry_every=1000)
        host = flagship_batches(cfg, batch, seq, 5)
        devb = [pretrain.batch_to_device(b) for b in host]
        params, opt_state, loss, _ = sparse(params, opt_state, devb[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in devb[1:]:
            params, opt_state, loss, _ = sparse(params, opt_state, b)
        torch.cuda.synchronize()
        ms_sparse = (time.perf_counter() - t0) / (len(devb) - 1) * 1e3
        print(f"    telemetry computed every step, fetched once: "
              f"{ms_sparse:.1f} ms/step", flush=True)
        stats = {"ms_per_step": ms, "ms_per_step_fetch_once": ms_sparse,
                 "losses": losses, "grad_norms": gnorms,
                 "breaches": mon.breaches_total, "groups": list(labels),
                 "adamw_launches": launches[0],
                 "telemetry_launches": launches[1],
                 "group_norms": norms}
        del model, params, opt_state, step, loader, samples, sparse, devb
        torch.cuda.empty_cache()

        # the NaN'd batch at the flagship: out-of-vocab ids read NaN
        # embedding rows (no device assert), non_finite fires once, and
        # the step after the fault runs
        nan_dir = os.path.join(flight_dir, "nan")
        flight = obs.FlightRecorder(min_interval_s=0.0)
        flight.arm(nan_dir)
        mon = obs.TrainHealthMonitor.from_config(mon_cfg,
                                                 flight_recorder=flight)
        model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        params, opt_state, meta = pretrain.make_train_state(model, None)
        step = pretrain.make_train_step(model, None, meta, monitor=mon)
        inj = TrainFaultInjector().nan_batch(1)
        nan_losses = []
        for i, b in enumerate(flagship_batches(cfg, batch, seq, 3)):
            b = inj.adjust_batch(i, b)
            params, opt_state, loss, gnorm = step(
                params, opt_state, pretrain.batch_to_device(b))
            nan_losses.append(float(loss))
        torch.cuda.synchronize()
        reasons = sorted(obs.load_dump(p)["reason"] for p in flight.dumps)
        check(mon.breach_counts == {"non_finite": 1}
              and reasons == ["non_finite_loss"]
              and inj.injected["nan_batch"] == 1
              and math.isfinite(nan_losses[0])
              and not math.isfinite(nan_losses[1]) and len(nan_losses) == 3,
              f"NaN'd batch: fired {mon.breach_counts}, dumps {reasons}, "
              f"losses {nan_losses}")
        print(f"  NaN'd batch at step 1 of 3: losses {nan_losses}, fired "
              f"{mon.breach_counts}, dumps {reasons}; the next step ran, "
              "no CUDA error", flush=True)
        stats["nan_leg"] = {"losses": nan_losses,
                            "fired": dict(mon.breach_counts),
                            "dumps": reasons}
        del model, params, opt_state, step
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    return stats


def adamw_telemetry_case(torch):
    """Kernel D over the flagship's 147 tensors with and without the
    telemetry: p, m, v and gnorm bit-equal, the packed vector within
    TEL_RTOL of ``pack_telemetry_plain`` (non-finite counts exact), and
    the device ms of each beside the bound and the plain version's."""
    from paddle_tpu_torch.ops import work
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    from paddle_tpu_torch.observability import train_health as th
    from paddle_tpu_torch.ops import adamw as ad
    cfg, _, _ = pretrain.flagship_config()
    named = [(n, tuple(p.shape)) for n, p in LlamaForCausalLM(
        cfg, device="cuda", seed=0).named_parameters()]
    spec = th.build_telemetry_spec({n: len(s) for n, s in named})
    group_of = {n: j for j, (_, ns) in enumerate(spec.groups) for n in ns}
    groups = [group_of[n] for n, _ in named]
    ng = len(spec.groups)
    shapes = [s for _, s in named]
    gen = torch.Generator(device="cuda").manual_seed(85)

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    p0 = [rnd(s, 0.02) for s in shapes]
    g0 = [rnd(s, 1e-3) for s in shapes]
    m0 = [rnd(s, 1e-4) for s in shapes]
    v0 = [rnd(s, 1e-4) ** 2 for s in shapes]
    loss = torch.tensor(10.375, device="cuda")
    decay = [len(s) >= 2 for s in shapes]
    hp = (3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0, 3)
    n = sum(math.prod(s) for s in shapes)

    def state():
        return ([t.clone() for t in p0], [t.clone() for t in m0],
                [t.clone() for t in v0])
    ps, ms, vs = state()
    gn_off = ad.adamw_step(ps, g0, ms, vs, decay, *hp)
    off = (ps, ms, vs)
    pt, mt, vt = state()
    gn_on, vec = ad.adamw_step(pt, g0, mt, vt, decay, *hp, groups=groups,
                               loss=loss)
    torch.cuda.synchronize()
    same = torch.equal(gn_off, gn_on) and all(
        torch.equal(a, b) for x, y in zip(off, (pt, mt, vt))
        for a, b in zip(x, y))
    check(same, "kernel D: p / m / v / gnorm differ with the telemetry on")
    ref = ad.pack_telemetry_plain(loss, gn_on, g0, p0, pt, groups)
    rel = float(((vec - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    nf_k = vec[2:].reshape(ng, 4)[:, 3]
    nf_p = ref[2:].reshape(ng, 4)[:, 3]
    check(rel <= TEL_RTOL and torch.equal(nf_k, nf_p),
          f"kernel D telemetry: {vec.tolist()} vs plain {ref.tolist()} "
          f"(worst relative {rel:.3e}, rtol {TEL_RTOL:g})")
    del off, ps, ms, vs
    ps, ms, vs = state()
    ms_off = device_time_ms(
        lambda: ad.adamw_step(ps, g0, ms, vs, decay, *hp), iters=20)
    ms_on = device_time_ms(
        lambda: ad.adamw_step(ps, g0, ms, vs, decay, *hp, groups=groups,
                              loss=loss), iters=20)

    def plain():
        old = [p.clone() for p in ps]
        gn = ad.adamw_step_plain(ps, g0, ms, vs, decay, *hp)
        ad.pack_telemetry_plain(loss, gn, g0, old, ps, groups)
    ms_plain = device_time_ms(plain, iters=5)
    b_ms, b_by = bound(*work.adamw(n))
    print(f"  adamw_telemetry[flagship_{n / 1e6:.1f}M, {len(shapes)} "
          f"tensors, {ng} groups]: p / m / v / gnorm bit-equal on and off; "
          f"vector worst relative {rel:.2e} of plain (rtol {TEL_RTOL:g}); "
          f"device ms telemetry on {ms_on:.4f} off {ms_off:.4f} plain "
          f"{ms_plain:.4f} bound {b_ms:.4f} ({b_by})", flush=True)
    del ps, ms, vs, pt, mt, vt, p0, g0, m0, v0
    torch.cuda.empty_cache()
    return [{"case": f"flagship_{n / 1e6:.1f}M", "max_abs_err": float(
        (vec - ref).abs().max()), "worst_rel": rel, "ms": ms_on,
        "ms_off": ms_off, "plain_ms": ms_plain, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}]


def train_monitor_gate():
    """Phase 22 (b): tools/torch_train_monitor.py --device cuda --check
    tools/train_health.json in a process of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools",
                                      "torch_train_monitor.py"),
         "--device", "cuda", "--check",
         os.path.join(root, "tools", "train_health.json")],
        cwd=root, capture_output=True, text=True, timeout=600)
    for line in r.stdout.strip().splitlines()[-12:]:
        print(f"    | {line}", flush=True)
    check(r.returncode == 0, f"tools/torch_train_monitor.py --device cuda "
          f"--check failed (exit {r.returncode}): {r.stderr[-2000:]}")
    secs = time.perf_counter() - t0
    print(f"  the train_health gate passed on the card in {secs:.1f} s",
          flush=True)
    return {"seconds": secs}


def phase_health(torch, base):
    """Phase 22: telemetry, the monitor and the faults."""
    stats = telemetry_train(torch, base)
    stats["gate"] = train_monitor_gate()
    rows = adamw_telemetry_case(torch)
    return stats, rows



# -- phase 23: the incubate options at the serving flagship's width -------

PRE, SUF = 128, 384             # phase 23 (a): prefix + prompt, B = 8
INC_F32_ATOL = 1e-4             # f32: the same math; the GEMMs of a 384-
#                                 and a 512-row slab may sum in another order
INC_BF16_RTOL = 5e-2            # bf16, 24 layers: a rounding flip early on
#                                 moves later rows by a few bf16 ulps of max


def incubate_weights(torch, dtype, layers=None, seed=23, biases=False):
    """Phase 23's stack: the serving flagship's shapes (rmsnorm, swiglu,
    GQA) from seeded numpy, as the functional op's keyword lists on the
    card; with ``biases`` also the numpy dict of FusedMultiTransformer's
    parameter names."""
    layers = layers or L
    w = llama_weights(seed, layers)
    rng = np.random.default_rng(seed + 1)
    lists = {k: w[k] for k in ("ln_scales", "qkv_weights", "linear_weights",
                               "ffn_ln_scales", "ffn1_weights",
                               "ffn2_weights")}
    lists.update({k: [] for k in ("ln_biases", "qkv_biases",
                                  "linear_biases", "ffn_ln_biases",
                                  "ffn1_biases", "ffn2_biases")})
    if biases:
        def mk(*shape):
            return rng.standard_normal(shape, dtype=np.float32) * 0.02
        lists.update(
            ln_biases=[mk(E) for _ in range(layers)],
            qkv_biases=[mk(H + 2 * KVH, D) for _ in range(layers)],
            linear_biases=[mk(E) for _ in range(layers)],
            ffn_ln_biases=[mk(E) for _ in range(layers)],
            ffn1_biases=[mk(2 * F) for _ in range(layers)],
            ffn2_biases=[mk(E) for _ in range(layers)])
    dt = getattr(torch, dtype)
    kw = {k: [torch.as_tensor(a).to("cuda", dt) for a in v]
          for k, v in lists.items()}
    named = {f"{k[:-1] if not k.endswith('biases') else k[:-2]}_{i}": a
             for k, v in lists.items() for i, a in enumerate(v)}
    return kw, named


def incubate_kw(extra=None):
    return dict(norm_type="rmsnorm", activation="swiglu",
                gqa_group_size=KVH, epsilon=1e-6, **(extra or {}))


def phase_incubate(torch):
    """Phase 23: ``fused_multi_transformer``'s serving options and the
    fused layer at the serving flagship's width (L=24): (a) pre_caches,
    (b) attn_mask, (c) dropout, (d) FusedMultiTransformer from numpy."""
    from paddle_tpu_torch.incubate.nn import functional as TF
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              fused_layer_state_from_numpy)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, s = MAX_BATCH, PRE + SUF
    stats = {}
    for dtn in ("float32", "bfloat16"):
        w, _ = incubate_weights(torch, dtn)
        dt = getattr(torch, dtn)
        x = torch.randn(b, s, E, device="cuda", generator=gen).to(dt)

        def zeros():
            return [torch.zeros(2, b, KVH, s, D, device="cuda", dtype=dt)
                    for _ in range(L)]
        full_c = zeros()
        full = TF.fused_multi_transformer(x, cache_kvs=full_c, **w,
                                          **incubate_kw())
        pre = [c[:, :, :, :PRE].clone() for c in full_c]
        suf_c = zeros()
        suf = TF.fused_multi_transformer(x[:, PRE:], pre_caches=pre,
                                         cache_kvs=suf_c, **w,
                                         **incubate_kw())
        torch.cuda.synchronize()
        ref = full[:, PRE:].float()
        err = float((suf.float() - ref).abs().max())
        cerr = max(float((a.float() - c.float()).abs().max())
                   for a, c in zip(suf_c, full_c))
        top = float(ref.abs().max())
        allowed = INC_F32_ATOL * max(1.0, top) if dtn == "float32" \
            else INC_BF16_RTOL * top
        check(bool(torch.isfinite(suf).all()) and err <= allowed
              and cerr <= allowed * 4,
              f"pre_caches {dtn}: suffix rows off by {err} (caches {cerr}) "
              f"against the concatenated prefill, allowed {allowed}")
        print(f"  (a) pre_caches {dtn}: {PRE}-token prefix + {SUF} tokens, "
              f"B={b}: suffix rows max abs err {err:.3e} (allowed "
              f"{allowed:.3e}, max |ref| {top:.3f}; bit-equal "
              f"{bool(torch.equal(suf, full[:, PRE:]))}), caches "
              f"{cerr:.3e}", flush=True)
        stats[f"pre_caches_err_{dtn}"] = err
        # (b) a zero mask is the unmasked op, bit for bit; -1e30 over
        # columns [len, S) is those columns dropped through seq_lens
        lens = np.clip(np.array([s, s - 212, s, 17, s // 2, 1, s - 112,
                                 s - 1], np.int64)[:b], 1, s)
        plain = TF.fused_multi_transformer(x, **w, **incubate_kw())
        zero = TF.fused_multi_transformer(
            x, attn_mask=torch.zeros(b, 1, s, s, device="cuda"), **w,
            **incubate_kw())
        neg = torch.zeros(b, 1, s, s, device="cuda")
        cols = torch.arange(s, device="cuda")[None, :] >= \
            torch.as_tensor(lens, device="cuda")[:, None]
        neg.masked_fill_(cols[:, None, None, :], -1e30)
        masked = TF.fused_multi_transformer(x, attn_mask=neg, **w,
                                            **incubate_kw())
        dropped = TF.fused_multi_transformer(x, seq_lens=lens, **w,
                                             **incubate_kw())
        check(torch.equal(plain, zero), f"attn_mask {dtn}: a zero mask "
              "changed the output")
        check(torch.equal(masked, dropped), f"attn_mask {dtn}: -1e30 over "
              f"columns [len, S) differs from seq_lens by "
              f"{float((masked.float() - dropped.float()).abs().max())}")
        print(f"  (b) attn_mask {dtn}: zero mask bit-equal to none; -1e30 "
              f"over columns [len, {s}) bit-equal to seq_lens "
              f"{[int(n) for n in lens]}",
              flush=True)
        # (c) dropout p=0.1 on one layer whose input is zero and whose
        # FFN is zero: the output is the dropped out-projection itself
        p = 0.1
        w1, _ = incubate_weights(torch, dtn, layers=1, biases=True)
        w1["ffn2_weights"] = [torch.zeros_like(w1["ffn2_weights"][0])]
        w1["ffn2_biases"] = [torch.zeros_like(w1["ffn2_biases"][0])]
        z = torch.zeros(b, s, E, device="cuda", dtype=dt)
        base = TF.fused_multi_transformer(z, **w1, **incubate_kw())
        got = TF.fused_multi_transformer(z, training=True, dropout_rate=p,
                                         **w1, **incubate_kw())
        kept = got != 0
        share = float(kept.float().mean())
        sigma = math.sqrt(p * (1 - p) / kept.numel())
        exact = torch.equal(got[kept], (base / (1 - p))[kept])
        check(abs(share - (1 - p)) <= 6 * sigma and exact,
              f"dropout {dtn}: kept share {share} (6 sigma {6 * sigma}), "
              f"scaling exact {exact}")
        ev = TF.fused_multi_transformer(x, training=False, dropout_rate=p,
                                        **w, **incubate_kw())
        check(torch.equal(ev, plain), f"dropout {dtn}: training=False is "
              "not bit-equal to p=0")
        print(f"  (c) dropout p={p} {dtn}: kept share {share:.5f} (0.9 +- "
              f"{6 * sigma:.5f} at 6 sigma), kept values exactly x / 0.9; "
              "training=False bit-equal to p=0", flush=True)
        stats[f"dropout_keep_{dtn}"] = share
        del full_c, suf_c, pre, plain, zero, masked, dropped, neg
    # (d) the fused layer with numpy weights (biases too) against the
    # functional op on the same values, bf16
    wb, named = incubate_weights(torch, "bfloat16", biases=True)
    layer = FusedMultiTransformer(E, H, F, activation="swiglu",
                                  norm_type="rmsnorm", gqa_group_size=KVH,
                                  epsilon=1e-6, num_layers=L, device="cuda")
    fused_layer_state_from_numpy(layer, named)
    layer = layer.to(torch.bfloat16).eval()
    xb = torch.randn(b, s, E, device="cuda", generator=gen).bfloat16()
    lo = layer(xb)
    fo = TF.fused_multi_transformer(xb, **wb, **incubate_kw())
    check(torch.equal(lo, fo), "FusedMultiTransformer with numpy weights "
          f"differs from the functional op by "
          f"{float((lo.float() - fo.float()).abs().max())}")
    print(f"  (d) FusedMultiTransformer ({L} layers, weights and biases "
          "from numpy) bit-equal to the functional op", flush=True)
    del layer
    # time: a bf16 prefill of 512 tokens, and the prefix form
    w, _ = incubate_weights(torch, "bfloat16")
    xb = xb[:, :s]
    pre = [torch.randn(2, b, KVH, PRE, D, device="cuda",
                       generator=gen).bfloat16() for _ in range(L)]
    ms_full = time_ms(lambda: TF.fused_multi_transformer(
        xb, **w, **incubate_kw()), iters=10)
    ms_pre = time_ms(lambda: TF.fused_multi_transformer(
        xb[:, PRE:], pre_caches=pre, **w, **incubate_kw()), iters=10)
    print(f"  bf16 prefill, L={L}, B={b}: {s} tokens {ms_full:.2f} ms; "
          f"{PRE}-token prefix + {SUF} tokens {ms_pre:.2f} ms (CUDA events)",
          flush=True)
    stats.update(prefill_ms=ms_full, prefix_prefill_ms=ms_pre)
    torch.cuda.empty_cache()
    return stats


# -- phase 24: the cost catalog and the memory monitor on the card ---------

def timed_ticks(watch):
    """Wrap ``watch.tick`` to add up its host seconds; returns the list
    [calls, seconds]."""
    acc = [0, 0.0]
    inner = watch.tick

    def tick(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            acc[0] += 1
            acc[1] += time.perf_counter() - t0

    watch.tick = tick
    return acc


def request_tokens(cb, greqs):
    return [list(cb.finished[r.request_id]) for r in greqs]


def phase_observability(torch):
    """Phase 24 (a) and (b), under no_grad: phase 2's serving workload
    plain and with the memory monitor, pressure shedding and the cost
    catalog on; then the pressure leg."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    eng = make_engine(llama_weights(0, L), "bfloat16")
    serve(eng, requests(99, 2, prompt=(16, 80), new=(2, 4)))
    reqs = requests(1, 12)
    cb0, g0, steps0, wall0 = serve(eng, reqs)
    plain = request_tokens(cb0, g0)
    cat = obs.get_cost_catalog()
    cat.reset()
    cat.enabled = True
    watch = obs.MemoryMonitor(interval_s=0)
    ticks = timed_ticks(watch)
    try:
        cb1, g1, steps1, wall1 = serve(eng, reqs, memory_watch=watch,
                                       shed_on_pressure=True)
    finally:
        cat.enabled = False
    check(request_tokens(cb1, g1) == plain, "serving tokens changed with "
          "the monitor and the catalog on")
    rows = {r["program"]: r for r in cat.table()}
    r = rows["paged_step"]
    ragged = r["kernels"].get("ragged_paged_attention", {})
    check(r["mfu"] is not None and 0 < r["mfu"] <= 1.0
          and 0 < r["roofline_frac"] <= 1.0,
          f"paged_step MFU {r['mfu']} / roofline share {r['roofline_frac']} "
          "not in (0, 1]")
    check(ragged.get("launches", 0) == L,
          f"ragged launches in the last counted step {ragged} (want {L})")
    rep = watch.last_report
    check(rep["devices"] and not rep["pressure"] and rep["census_bytes"]
          is None, f"monitor report on the card: {rep}")
    tick_us = ticks[1] / max(ticks[0], 1) * 1e6
    print(f"  serving x2 ({steps0} / {steps1} paged steps): tokens equal "
          f"with MemoryMonitor(interval_s=0) + shed_on_pressure + the "
          f"catalog; {ticks[0]} ticks, mean {tick_us:.1f} us a tick (no "
          "census on the card)", flush=True)
    print(f"  paged_step: {r['signatures']} signatures counted; last "
          f"counted: {r['flops']:.4e} flops, {r['bytes_accessed']:.4e} "
          f"bytes, intensity {r['intensity']:.3f}, peak {r['peak_hbm']} B; "
          f"device p50 {r['device_s'] * 1e3:.3f} ms, MFU "
          f"{r['mfu']:.3e}, roofline share {r['roofline_frac']:.3e}; K3 in "
          f"the counted steps: {ragged}", flush=True)
    for name in ("paged_rewind", "paged_copy"):
        if name in rows:
            print(f"  {name}: {rows[name]['bytes_accessed']:.4e} bytes "
                  f"counted", flush=True)
    # (b) the pressure leg: a budget just above the reserved bytes; the
    # admitted class runs on, the queued low class is shed
    first, later = requests(5, 4), requests(6, 4)

    def pressure_run(watch, shed):
        cb = ContinuousBatchingEngine(
            eng, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=MAX_BATCH,
            prefill_chunk=CHUNK, memory_watch=watch, shed_on_pressure=shed)
        hi = [GenerationRequest(p, n, priority=0) for p, n in first]
        for q in hi:
            cb.submit(q)
        cb.step()
        lo = [GenerationRequest(p, n, priority=2) for p, n in later]
        if shed:
            for q in lo:
                cb.submit(q)
        cb.run()
        return cb, hi, lo

    cb_a, hi_a, _ = pressure_run(None, False)
    reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    budget = reserved * 1.05
    shed0 = obs.get_registry().snapshot().get(
        "serve_requests_shed_total", {}).get("children", {}).get(
            "hbm_pressure", {}).get("value", 0)
    watch2 = obs.MemoryMonitor(budget_bytes=budget, min_headroom_frac=0.1,
                               interval_s=0)
    cb_b, hi_b, lo_b = pressure_run(watch2, True)
    shed1 = obs.get_registry().snapshot()["serve_requests_shed_total"][
        "children"]["hbm_pressure"]["value"]
    check(watch2.pressure_events >= 1 and all(
        cb_b.finished[q.request_id].status == "shed" for q in lo_b)
        and shed1 - shed0 == len(lo_b),
          f"pressure leg: {watch2.pressure_events} pressure events, "
          f"statuses {[cb_b.finished[q.request_id].status for q in lo_b]}")
    check(request_tokens(cb_b, hi_b) == request_tokens(cb_a, hi_a),
          "admitted requests' tokens changed under pressure")
    check_pool(cb_b)
    print(f"  pressure: budget {budget / 1e9:.3f} GB (reserved "
          f"{reserved / 1e9:.3f} GB x 1.05), headroom "
          f"{watch2.last_report['headroom_frac']:.4f} < 0.1: hbm_pressure "
          f"fired {watch2.pressure_events} times, {len(lo_b)} queued "
          f"priority-2 requests shed (reason hbm_pressure), the {len(hi_b)} "
          "admitted ones finished with their unpressured tokens", flush=True)
    del eng, cb0, cb1, cb_a, cb_b
    torch.cuda.empty_cache()
    return {"tick_us": tick_us, "ticks": ticks[0],
            "paged_step": {k: r[k] for k in (
                "flops", "bytes_accessed", "intensity", "peak_hbm",
                "device_s", "mfu", "roofline_frac", "signatures")},
            "pressure_events": watch2.pressure_events}


def phase_train_catalog(torch, base):
    """Phase 24 (c): phase 7's step with the catalog: the first step
    counted as pretrain_step, three timed on the device; flops per token
    beside bench.py's formula, the catalog's MFU beside phase 7's, and
    each hand-written kernel's count against ``ops.work`` at the
    flagship's shapes."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    from paddle_tpu_torch.ops import work
    cfg, batch, seq = pretrain.flagship_config()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    params, opt_state, meta = pretrain.make_train_state(model, None)
    step = pretrain.make_train_step(model, None, meta)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    cat = obs.get_cost_catalog()
    cat.reset()
    cat.enabled = True
    try:
        for _ in range(4):
            b_ = pretrain.batch_to_device(
                {"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq)),
                 "labels": rng.integers(0, cfg.vocab_size, (batch, seq))})
            params, opt_state, loss, _ = step(params, opt_state, b_)
        float(loss)
    finally:
        cat.enabled = False
    row = {r["program"]: r for r in cat.table()}["pretrain_step"]
    tokens = batch * seq
    per_tok = row["flops"] / tokens
    bench = train_flops_per_token(cfg, n_params, seq)
    check(row["mfu"] is not None and 0 < row["mfu"] <= 1.0
          and 0 < row["roofline_frac"] <= 1.0,
          f"pretrain_step MFU {row['mfu']} / roofline share "
          f"{row['roofline_frac']} not in (0, 1]")
    bh, hd = batch * cfg.num_attention_heads, \
        cfg.hidden_size // cfg.num_attention_heads
    im = cfg.intermediate_size
    want = {"flash_fwd": work.flash_fwd(bh, seq, seq, hd, True),
            "flash_bwd": work.flash_bwd(bh, seq, seq, hd, True),
            "swiglu_fwd": work.swiglu_fwd(tokens, im),
            "swiglu_bwd": work.swiglu_bwd(tokens, im),
            "token_ce_fwd": work.token_ce_fwd(tokens, cfg.vocab_size, 2),
            "token_ce_bwd": work.token_ce_bwd(tokens, cfg.vocab_size, 2),
            "adamw": work.adamw(n_params)}
    lines = []
    for name, (nb, fl) in want.items():
        got = row["kernels"].get(name)
        check(got is not None and got["launches"] > 0,
              f"{name} not counted in pretrain_step: {row['kernels']}")
        launches = got["launches"]
        b_got, _ = work.bound_ms(got["bytes"] / launches,
                                 got["flops"] / launches)
        b_want, by = work.bound_ms(nb, fl)
        check(abs(b_got - b_want) <= 0.01 * b_want,
              f"{name}: the catalog's count gives {b_got} ms a launch, the "
              f"table {b_want} ms")
        lines.append(f"{name} {got['launches']} x {b_got:.4f} ms ({by})")
    print(f"  pretrain_step counted once: {row['flops']:.4e} flops = "
          f"{per_tok:.4e} a token, {per_tok / bench:.3f} of bench.py's 6N + "
          f"12 L E S = {bench:.4e}; bytes {row['bytes_accessed']:.4e}, "
          f"intensity {row['intensity']:.1f}, peak {row['peak_hbm']} B; device p50 {row['device_s'] * 1e3:.1f} ms a step over "
          f"the 3 timed steps: catalog MFU {row['mfu']:.4f} (phase 7's "
          f"bench-formula MFU {base['mfu']:.4f}), roofline share "
          f"{row['roofline_frac']:.4f}", flush=True)
    print(f"  kernels' own counts a launch, each the table's bound within "
          f"1%: {'; '.join(lines)}", flush=True)
    del model, params, opt_state
    torch.cuda.empty_cache()
    return {"flops_per_token": per_tok, "bench_flops_per_token": bench,
            "ratio": per_tok / bench, "mfu": row["mfu"],
            "roofline_frac": row["roofline_frac"],
            "device_ms": row["device_s"] * 1e3,
            "kernels": row["kernels"]}


# -- phase 25: kv-head-sharded tensor-parallel serving -----------------------

TP_TIMEOUT_S = 120.0    # every gloo operation of phase 25's groups
TP_IDLE_S = 900.0       # a follower's wait for rank 0's next op
TP_JOIN_S = 120.0       # a follower's exit after its last leg
TP_SEED = 0             # phase 2's weights
# (leg, dtype, weight_quant, layers) of the tp=2 group, in order
TP2_LEGS = (("f32", "float32", None, L), ("bf16", "bfloat16", None, L),
            ("int8_f32", "float32", "int8", L),
            ("int4_f32", "float32", "int4", L),
            ("int8_bf16", "bfloat16", "int8", L),
            ("int4_bf16", "bfloat16", "int4", L))
TP4_LEGS = (("f32_L2", "float32", None, 2),)
TP_LOGIT_RTOL = 0.05    # bf16 step-0 logits: 5% of the logit range


def tp_follower(spec_path):
    """A follower rank of phase 25 (``chip_smoke.py --tp-follower SPEC``):
    joins the group, then for each leg of the spec builds its engine from
    the seeded weights and replays rank 0's programs until rank 0 stops
    it, counting its kernel launches and all_reduces; writes the counts
    as JSON to the spec's ``out``."""
    import torch
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.distributed import collective
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    group = collective.new_group(spec["rank"], spec["tp"], spec["store"],
                                 timeout=TP_TIMEOUT_S)
    weights, out = {}, []
    for name, dtype, quant, layers in spec["legs"]:
        if layers not in weights:
            weights = {layers: llama_weights(TP_SEED, layers)}
        reset_counts()
        calls0 = collective.all_reduce.calls
        eng = make_engine(weights[layers], dtype, quant, tp=spec["tp"],
                          group=group)
        stats = eng.serve_follower(idle_timeout=TP_IDLE_S)
        torch.cuda.synchronize()
        attn, int4 = read_counts()
        stats.update(leg=name, attn=attn, int4=int4,
                     int8=read_decode_counts()[1],
                     all_reduce=collective.all_reduce.calls - calls0,
                     routes=sorted(set(eng.quant_routes.values())))
        out.append(stats)
        del eng
        torch.cuda.empty_cache()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def spawn_followers(tp, legs, tmp):
    """Start ranks 1..tp-1 of a group over a FileStore in `tmp`, each a
    process of this script; returns their (process, spec, log) list."""
    procs = []
    for rank in range(1, tp):
        spec = {"rank": rank, "tp": tp, "store": os.path.join(tmp,
                                                             f"store{tp}"),
                "legs": [list(leg) for leg in legs],
                "out": os.path.join(tmp, f"tp{tp}_rank{rank}.json")}
        path = os.path.join(tmp, f"tp{tp}_rank{rank}_spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        log = open(os.path.join(tmp, f"tp{tp}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-follower",
             path], stdout=log, stderr=subprocess.STDOUT), spec, log))
    return procs


def join_followers(procs):
    """Wait (bounded) for every follower's exit; fail unless each exited
    0. Returns each follower's per-leg counts."""
    results = []
    for proc, spec, log in procs:
        try:
            rc = proc.wait(TP_JOIN_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            with open(log.name) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(f"tp follower rank {spec['rank']} ended "
                               f"{rc}:\n{tail}")
        with open(spec["out"]) as f:
            results.append(json.load(f))
    return results


def kill_followers(procs):
    for proc, _, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@contextlib.contextmanager
def step_record(engine):
    """Record each paged step's slab width and rank 0's step-0 logits
    while the block runs: yields {"widths": [...], "logits": tensor}."""
    rec = {"widths": [], "logits": None}
    inner, select = engine._paged_step, engine._select

    def step(*a, **k):
        rec["widths"].append(int(np.asarray(a[2]).shape[1]))
        return inner(*a, **k)

    def sel(logits, *a, **k):
        if rec["logits"] is None:
            rec["logits"] = logits.float().cpu()
        return select(logits, *a, **k)

    engine._paged_step, engine._select = step, sel
    try:
        yield rec
    finally:
        engine._paged_step = inner
        del engine._select


def cache_bytes(caches):
    return sum(c.numel() * c.element_size() for c in caches)


def collective_bytes():
    from paddle_tpu_torch import observability as obs
    fam = obs.get_registry().get("collective_bytes_total")
    return sum(c.value for c in fam._children.values()) \
        if fam is not None else 0.0


def token_agreement(ref, got):
    """(equal tokens, tokens, first divergence as (request, step) or
    None), position by position."""
    eq = n = 0
    first = None
    for i, (a, b) in enumerate(zip(ref, got)):
        n += len(a)
        for t, (x, y) in enumerate(zip(a, b)):
            if x == y:
                eq += 1
            elif first is None:
                first = (i, t)
        if len(a) != len(b) and first is None:
            first = (i, min(len(a), len(b)))
    return eq, n, first


def tp_tie_gap(torch, e1, reqs, ref, got, label):
    """Phase 3's rule between two engines' greedy tokens: equal, or
    parting only where the tp=1 engine's top-2 logits sit within 1e-3.
    Returns the largest such gap (0.0 when every token is equal)."""
    worst = 0.0
    for i, ((p, _), a, b) in enumerate(zip(reqs, ref, got)):
        if a == b:
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ids = np.concatenate([p, np.asarray(a[:t], np.int32)])[None, :]
        lg = e1._prefill_logits(ids)[0].float()
        top = torch.topk(lg, 2).values
        gap = float(top[0] - top[1])
        print(f"  {label}: request {i} parts at step {t}, top-2 logit gap "
              f"{gap:.3e}", flush=True)
        check(gap <= 1e-3, f"{label}: request {i} diverges at step {t} "
              f"with a top-2 logit gap {gap} > 1e-3")
        worst = max(worst, gap)
    return worst


def tp_kernel_rows(torch):
    """K3 at each rank's kv heads (tp=2: 8 q / 4 kv heads; tp=4: 4 / 2)
    on phase 1's three cases, and K4 at each rank's projection shapes
    (tp=2: qkv K=1024 N=1024, out K=512 N=1024, ffn1 K=1024 N=2816, ffn2
    K=1408 N=1024; tp=4's ffn2 K=704 N=1024), int8 and int4 at M=8 and
    512 in bf16 and M=8 in f32, each against its plain version. Device
    ms of each beside its plain version's and the library's: SDPA over
    the gathered context at the rank's heads (K3), ``torch.matmul`` on a
    copy of the dequantized shard weight in the activations' dtype
    (K4)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    rows = {"attn": [], "int4": [], "int8": []}
    for tp in (2, 4):
        kc, vc, cases = attention_cases(torch, pa, H // tp, KVH // tp)
        for name, q, tables, lens, qls in cases:
            tab_d = torch.as_tensor(tables).cuda()
            lens_d = torch.as_tensor(lens).cuda()
            qls_d = None if qls is None else torch.as_tensor(qls).cuda()

            def run():
                return pa.ragged_paged_attention(q, kc, vc, tab_d, lens_d,
                                                 q_lens=qls_d)
            out = run()
            ref = pa.ragged_paged_attention_plain(q, kc, vc, tab_d, lens_d,
                                                  q_lens=qls_d)
            err, ratio = bf16_agreement(out, ref, ATTN_ATOL)
            c = 1 if q.dim() == 3 else q.shape[1]
            plan = pa.ragged_plan(MAX_BATCH, c, H // tp, KVH // tp,
                                  tables.shape[1], BS, D, q.dtype)
            check(ratio <= 1.0 and bool(torch.isfinite(out).all()),
                  f"tp={tp} attention {name}: max abs err {err}, worst "
                  f"{ratio:.2f}x its allowance")
            check(pa.ragged_paged_attention.route == plan["route"],
                  f"tp={tp} attention {name}: route "
                  f"{pa.ragged_paged_attention.route} against the plan's "
                  f"{plan['route']}")
            b_ms, b_by = bound(*attention_work(q, tables, lens, qls,
                                               KVH // tp))
            dev = device_times(
                run, lambda: pa.ragged_paged_attention_plain(
                    q, kc, vc, tab_d, lens_d, q_lens=qls_d),
                sdpa_yardstick(torch, q, kc, vc, tables, lens, qls,
                               H // tp, KVH // tp))
            rows["attn"].append(dict(case=f"tp{tp}_{name}", max_abs_err=err,
                                     worst_err_over_allowed=ratio,
                                     bound_ms=b_ms, bound_by=b_by,
                                     plan=plan, **dev))
            print(f"  ragged_paged_attention[tp{tp} {H // tp}/{KVH // tp} "
                  f"heads, {name}]: err {err:.3e} (worst {ratio:.3f}) "
                  f"bound {b_ms:.4f} ms ({b_by}); {device_text(dev)}; "
                  f"{ragged_plan_text(plan)}", flush=True)
    rng = np.random.default_rng(25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    shapes = ((E, (H + 2 * KVH) * D // 2), (H * D // 2, E), (E, F),
              (F // 2, E), (F // 4, E))
    for k, n in shapes:
        w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
        pk, sc4 = qm.pack_int4_blocked(w, qm.kernel_block_n(n))
        sc8 = np.abs(w).max(0) / 127.0 + 1e-9
        q8 = np.clip(np.round(w / sc8), -127, 127).astype(np.int8)
        ops = {"int4": (torch.as_tensor(pk).cuda(),
                        torch.as_tensor(sc4).cuda(), qm.kernel_block_n(n)),
               "int8": (torch.as_tensor(q8).cuda(),
                        torch.as_tensor(sc8.astype(np.float32)).cuda(),
                        qm.pick_block_n(n, "int8"))}
        for quant, (wq, s, bn) in ops.items():
            for m, dt in ((8, torch.bfloat16), (512, torch.bfloat16),
                          (8, torch.float32)):
                x = torch.randn(m, k, device="cuda", generator=gen).to(dt)

                def run():
                    return qm.weight_only_matmul(x, wq, s, quant, bn)
                out = run()
                ref = qm.weight_only_matmul_plain(x, wq, s, quant, bn)
                atol = INT4_ATOL if quant == "int4" else INT8_ATOL
                err, ratio = bf16_agreement(out, ref, atol) \
                    if dt == torch.bfloat16 \
                    else two_ulp_agreement(out, ref, atol)
                name = f"M{m}_K{k}_N{n}_{str(dt)[6:]}"
                check(ratio <= 1.0 and bool(torch.isfinite(out).all()),
                      f"{quant} {name}: max abs err {err}, worst "
                      f"{ratio:.2f}x its allowance")
                plan = qm.plan(m, k, n, dt)
                wint = qm.unpack_int4_blocked(wq, bn) if quant == "int4" \
                    else wq
                wdq = (wint.float() * s[None, :]).to(dt)
                dev = device_times(
                    run, lambda: qm.weight_only_matmul_plain(x, wq, s, quant,
                                                             bn),
                    lambda: torch.matmul(x, wdq))
                rows[quant].append(dict(case=name, max_abs_err=err,
                                        worst_err_over_allowed=ratio,
                                        plan=plan, **dev))
                print(f"  weight_only_{quant}[{name}]: err {err:.3e} "
                      f"(worst {ratio:.3f}) {device_text(dev)}; "
                      f"{plan_text(plan)}", flush=True)
    return rows


def tp_healthz(torch, cb):
    """The port's gateway in front of rank 0's tp=2 scheduler: /healthz
    carries the mesh block, two device rows at the allocator's per-rank
    bytes, and validates."""
    import http.client
    from paddle_tpu_torch import serving
    from tools.torch_serve_gates import GatewayThread
    stepper = serving.EngineStepper(cb).start()
    gw = serving.ServingGateway(stepper)
    th = GatewayThread(gw).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
    finally:
        th.close()
        stepper.stop()
    check(resp.status == 200, f"/healthz answered {resp.status}")
    serving.validate_healthz(payload)
    mesh = payload.get("mesh") or {}
    rows = mesh.get("devices", [])
    per = cb.allocator.high_water * cb.engine.kv_device_block_bytes(BS)
    check(mesh.get("tp") == 2 and len(rows) == 2
          and all(r["kv_bytes_high_water"] == per for r in rows),
          f"/healthz mesh block {mesh} (want tp 2, two rows of {per} B)")
    return mesh


def tp_leg(torch, w, reqs, warm, leg, group, tp, collective):
    """One leg on rank 0: the tp=1 engine, then the tp engine (its
    followers replaying), the same requests; returns the leg's record."""
    name, dtype, quant, layers = leg
    rec = {"leg": name, "tp": tp}
    e1 = make_engine(w, dtype, quant)
    serve(e1, warm)
    reset_counts()
    with step_record(e1) as r1:
        cb1, g1, steps1, wall1 = serve(e1, reqs)
    toks1 = [list(cb1.finished[r.request_id]) for r in g1]
    rec["tp1"] = {"steps": steps1, "wall_s": wall1,
                  "ms_per_step": wall1 / steps1 * 1e3,
                  "tokens_per_s": sum(map(len, toks1)) / wall1,
                  "cache_bytes": cache_bytes(cb1.caches),
                  "kv_block_bytes": e1.kv_device_block_bytes(BS)}
    if name == "bf16":
        rec["tp1"]["profile"] = profile_window(
            torch, lambda: serve(e1, reqs)[2], "paged steps (tp=1)")
    del cb1
    t0 = time.perf_counter()
    e2 = make_engine(w, dtype, quant, tp=tp, group=group)
    rec["build_s"] = time.perf_counter() - t0
    routes = set(e2.quant_routes.values())
    check(quant is None or routes == {"kernel"}, f"{name}: tp={tp} routes "
          f"{e2.quant_routes}: every rank's widths fit a kernel block")
    with counted_steps(e2) as leg_steps:
        serve(e2, warm)
        reset_counts()
        calls0, coll0 = collective.all_reduce.calls, collective_bytes()
        with step_record(e2) as r2:
            cb2, g2, steps2, wall2 = serve(e2, reqs)
        attn, int4 = read_counts()
        int8 = read_decode_counts()[1]
        calls = collective.all_reduce.calls - calls0
        coll = collective_bytes() - coll0
        toks2 = [list(cb2.finished[r.request_id]) for r in g2]
        bytes2 = cache_bytes(cb2.caches)
        if name == "bf16":
            rec["healthz_mesh"] = tp_healthz(torch, cb2)
            rec["profile"] = profile_window(
                torch, lambda: serve(e2, reqs)[2], f"paged steps (tp={tp}, "
                "rank 0)")
    want_k4 = {"int4": (4 * layers * steps2, 0),
               "int8": (0, 4 * layers * steps2), None: (0, 0)}[quant]
    check(attn == layers * steps2, f"{name}: ragged kernel launched {attn} "
          f"times in {steps2} tp={tp} steps on rank 0 (want "
          f"{layers * steps2})")
    check((int4, int8) == want_k4, f"{name}: int4 / int8 launches "
          f"{(int4, int8)} in {steps2} steps (want {want_k4})")
    check(calls == 2 * layers * steps2, f"{name}: {calls} all_reduce calls "
          f"in {steps2} steps (want {2 * layers * steps2})")
    want_coll = sum(e2.tp_step_comm_bytes(MAX_BATCH, c)
                    for c in r2["widths"])
    check(coll == want_coll and len(r2["widths"]) == steps2,
          f"{name}: collective_bytes_total moved {coll}, the steps' "
          f"tp_step_comm_bytes sum to {want_coll}")
    check(bytes2 * tp == rec["tp1"]["cache_bytes"]
          and e2.kv_device_block_bytes(BS) * tp == rec["tp1"]
          ["kv_block_bytes"], f"{name}: rank 0's caches {bytes2} B, block "
          f"{e2.kv_device_block_bytes(BS)} B against tp=1's "
          f"{rec['tp1']['cache_bytes']} / {rec['tp1']['kv_block_bytes']}")
    eq, n, first = token_agreement(toks1, toks2)
    rec.update(steps=steps2, wall_s=wall2, ms_per_step=wall2 / steps2 * 1e3,
               tokens_per_s=sum(map(len, toks2)) / wall2, attn=attn,
               int4=int4, int8=int8, all_reduce=calls,
               collective_bytes=coll, cache_bytes=bytes2,
               equal_tokens=eq, tokens=n, first_divergence=first,
               leg_steps=leg_steps[0])
    if dtype == "float32":
        rec["largest_tie_gap"] = tp_tie_gap(torch, e1, reqs, toks1, toks2,
                                            f"{name} tp={tp}")
    else:
        l1, l2 = r1["logits"], r2["logits"]
        err = float((l1 - l2).abs().max())
        tol = TP_LOGIT_RTOL * float(l1.abs().max())
        rec.update(step0_logit_err=err, step0_logit_tol=tol)
        check(bool(torch.isfinite(l2).all()) and err <= tol,
              f"{name}: step-0 logits {err} from tp=1's (tol {tol})")
    print(f"  {name} tp={tp}: {eq}/{n} tokens equal to tp=1 (first "
          f"divergence {first}); {steps2} steps, {rec['ms_per_step']:.2f} "
          f"ms/step, {rec['tokens_per_s']:.1f} tokens/s (tp=1 "
          f"{rec['tp1']['ms_per_step']:.2f} ms/step, "
          f"{rec['tp1']['tokens_per_s']:.1f} tokens/s); launches a step: "
          f"K3 {attn / steps2:g}, int4 {int4 / steps2:g}, int8 "
          f"{int8 / steps2:g}, all_reduce {calls / steps2:g}; collective "
          f"{coll:.0f} B; rank 0's caches {bytes2} B (tp=1 "
          f"{rec['tp1']['cache_bytes']} B)" + (
              f"; step-0 logits {rec['step0_logit_err']:.4e} from tp=1's "
              f"(tol {rec['step0_logit_tol']:.4e})" if dtype != "float32"
              else ""), flush=True)
    e2.stop_followers()
    del e1, e2, cb2
    torch.cuda.empty_cache()
    return rec


def check_followers(results, recs, legs, layers_of):
    """Each follower replayed every step of each leg, with the kernels'
    launches and the all_reduces that many steps give, and held half
    (a quarter) of tp=1's cache bytes."""
    for rank, res in enumerate(results, 1):
        for st, rec, leg in zip(res, recs, legs):
            n, lay = st["steps"], layers_of[leg[0]]
            k4 = 4 * lay * n if leg[2] else 0
            got = (st["steps"], st["attn"], st["all_reduce"],
                   st["int4"] + st["int8"], st["cache_bytes"] * rec["tp"])
            want = (rec["leg_steps"], lay * n, 2 * lay * n, k4,
                    rec["tp1"]["cache_bytes"])
            check(got == want, f"tp={rec['tp']} rank {rank} leg {leg[0]}: "
                  f"(steps, K3, all_reduce, K4, tp x cache bytes) {got}, "
                  f"want {want}")


def phase_tp(torch):
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed import collective
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": "gloo, one card"}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs = []
    try:
        procs = spawn_followers(2, TP2_LEGS, tmp)
        out["kernels"] = tp_kernel_rows(torch)
        w = llama_weights(TP_SEED, L)
        reqs = requests(1, 12)
        warm = requests(99, 2, prompt=(16, 80), new=(2, 4))
        group = collective.new_group(0, 2, os.path.join(tmp, "store2"),
                                     timeout=TP_TIMEOUT_S)
        recs = [tp_leg(torch, w, reqs, warm, leg, group, 2, collective)
                for leg in TP2_LEGS]
        check_followers(join_followers(procs), recs, TP2_LEGS,
                        {leg[0]: leg[3] for leg in TP2_LEGS})
        procs = spawn_followers(4, TP4_LEGS, tmp)
        w2 = llama_weights(TP_SEED, 2)
        group4 = collective.new_group(0, 4, os.path.join(tmp, "store4"),
                                      timeout=TP_TIMEOUT_S)
        recs4 = [tp_leg(torch, w2, reqs, warm, leg, group4, 4, collective)
                 for leg in TP4_LEGS]
        check_followers(join_followers(procs), recs4, TP4_LEGS,
                        {leg[0]: leg[3] for leg in TP4_LEGS})
        procs = []
    finally:
        kill_followers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    out["legs"] = recs + recs4
    bf = next(r for r in recs if r["leg"] == "bf16")
    prof1, prof2 = bf["tp1"]["profile"], bf["profile"]

    def k3(p):
        d = p.get("device_ms_by_class")
        return None if not d else d.get("ragged_attention", 0.0) / p["steps"]

    def idle(p):
        return None if p.get("device_busy_s") is None \
            else 1 - p["device_busy_s"] / p["wall_s"]
    out["bf16_summary"] = {
        "tp1_ms_per_step": bf["tp1"]["ms_per_step"],
        "tp2_ms_per_step": bf["ms_per_step"],
        "tp1_tokens_per_s": bf["tp1"]["tokens_per_s"],
        "tp2_tokens_per_s": bf["tokens_per_s"],
        "tp1_idle": idle(prof1), "tp2_rank0_idle": idle(prof2),
        "tp1_k3_ms_per_step": k3(prof1), "tp2_k3_ms_per_step_rank0":
            k3(prof2)}
    print(f"  tensor-parallel serving over gloo on one card (bf16, 12 "
          f"requests): {json.dumps(out['bf16_summary'])}", flush=True)
    return out


# -- phase 26: the sharded pretrain mesh over gloo on the one card ----------

MESH_TIMEOUT_S = 300.0     # every gloo operation of phase 26's groups
MESH_JOIN_S = 600.0        # a rank's exit after its last step
MESH_LOSS_RTOL = 2e-3      # step-0 bf16 loss against phase 7's: a bf16
#                            rounding is 2**-9 relative; the mean over
#                            16384 tokens averages the ones that differ
MESH_GNORM_RTOL = 1e-3     # step-0 bf16 grad norm against phase 7's: on
#                            one card phases 11, 21 and 22 land 7e-5 to
#                            1.0e-4 from it (K2's dq atomics; H100 run),
#                            the mesh sums the row-parallel outputs and the
#                            gradients in another order besides
MESH_MASTER_ATOL = 2.4e-4  # f32 masters after 3 steps: below one AdamW
#                            step (lr 3e-4), which an element whose
#                            gradient sums to ~0 may take in either sign
MESH_MASTER_BULK = 1e-4    # ... and within this: 99.9% of every tensor's
#                            elements, and every element of a 1-D tensor
#                            (norm weights: whole on every rank, their
#                            gradients summed over the data group)
MESH_LEGS = (
    # (leg, mesh, world, dtype, layers, weight seed, batch seed, steps)
    ("a", {"fsdp": 2, "mp": 2}, 4, "bfloat16", L, 0, 0, 4),
    ("b", {"dp": 2, "fsdp": 2, "mp": 2}, 8, "float32", 2, 1, 1, 3),
)


def mesh_config(dtype, layers):
    from paddle_tpu_torch.models import pretrain
    cfg, batch, seq = pretrain.flagship_config()
    cfg.dtype = dtype
    cfg.num_hidden_layers = layers
    return cfg, batch, seq


def mesh_batches(cfg, batch, seq, seed, n):
    """Phase 7's (seed 0) or phase 8's (seed 1) host batches."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq)),
             "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
            for _ in range(n)]


def llama_shapes(cfg):
    """{name: shape} of the fused Llama's parameters, from the config
    alone (the analytic side of the bytes-at-rest gate)."""
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * \
        cfg.head_dim
    shapes = {"llama.embed_tokens.weight": (v, e), "llama.norm.weight": (e,),
              "lm_head.weight": (e, v)}
    for i in range(cfg.num_hidden_layers):
        p = f"llama.layers.{i}."
        shapes.update({
            p + "self_attn.qkv_proj.weight": (e, qkv),
            p + "self_attn.o_proj.weight": (e, e),
            p + "mlp.gate_up_fused_proj.weight": (e, 2 * f),
            p + "mlp.down_proj.weight": (f, e),
            p + "input_layernorm.weight": (e,),
            p + "post_attention_layernorm.weight": (e,)})
    return shapes


def mesh_analytic(cfg, mesh_kw, world, tokens_local):
    """(bytes at rest a rank, one step's collectives a rank) from the
    specs of ``spec_for_param`` and ``sharded.step_comm``."""
    from paddle_tpu_torch.distributed.fleet import sharded
    from paddle_tpu_torch.models import pretrain
    mesh = pretrain.make_mesh(world, device="cpu", **mesh_kw)
    shapes = llama_shapes(cfg)
    specs = {n: pretrain.spec_for_param(n, s, mesh,
                                        pretrain.llama_sharding_rules())
             for n, s in shapes.items()}
    rest = 0
    for n, shp in shapes.items():
        rest += 3 * 4 * int(np.prod([d // (mesh.shape[a] if a else 1)
                                     for d, a in zip(shp, specs[n])]))
    plans, split = sharded.plan_params(cfg, shapes, specs, mesh.shape)
    bf16 = cfg.dtype == "bfloat16"
    comm = sharded.step_comm(plans, split, mesh.shape, tokens_local,
                             cfg.hidden_size, 2 if bf16 else 4,
                             2 if bf16 else 4)
    return rest, comm, sum(int(np.prod(s)) for s in shapes.values())


def mesh_rank(spec_path):
    """A rank of phase 26 (``chip_smoke.py --mesh-rank SPEC``): joins the
    world group, builds the seeded model on the card, keeps its shards of
    the state (the whole weights go to the meta device), runs the leg's
    steps and writes its numbers as JSON to the spec's ``out``; leg (b)'s
    rank 0 also writes the gathered masters."""
    import torch
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import collective, comm_watchdog
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = collective.new_group(spec["rank"], spec["world"], spec["store"],
                                 timeout=MESH_TIMEOUT_S)

    def coll_seconds():
        fam = obs.get_registry().snapshot().get("collective_seconds", {})
        return {k: c["sum"] for k, c in fam.get("children", {}).items()}
    cfg, batch, seq = mesh_config(spec["dtype"], spec["layers"])
    mesh = pretrain.make_mesh(spec["world"], group=group, **spec["mesh"])
    model = LlamaForCausalLM(cfg, device="cuda", seed=spec["seed"])
    params, opt, meta = pretrain.make_train_state(model, mesh)
    model.to("meta")
    torch.cuda.empty_cache()
    step = pretrain.make_train_step(model, mesh, meta)
    rest = sum(t.numel() * t.element_size()
               for tree in (params, opt["m"], opt["v"])
               for t in tree.values())
    batches = [pretrain.shard_batch(b, mesh) for b in mesh_batches(
        cfg, batch, seq, spec["batch_seed"], spec["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, out = [], {"rank": spec["rank"], "rest_bytes": rest}
    warm = 1 if spec["leg"] == "a" else 0
    for b in batches[:warm]:
        params, opt, loss, gnorm = step(params, opt, b)
        hist.append((float(loss), float(gnorm)))
    torch.cuda.synchronize()
    reset_counts()
    # the watchdog's collective_seconds{op, axis}: host seconds from each
    # collective's dispatch to its result (waits for peers included)
    comm_watchdog.enable_comm_watchdog(timeout=MESH_TIMEOUT_S,
                                       poll_interval=60)
    c0 = coll_seconds()
    t0 = time.perf_counter()
    res = []
    for b in batches[warm:]:
        params, opt, loss, gnorm = step(params, opt, b)
        res.append((loss, gnorm))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = len(batches) - warm
    c1 = coll_seconds()
    comm_watchdog.disable_comm_watchdog()
    out["collective_ms_per_step"] = {
        k: (v - c0.get(k, 0.0)) / timed * 1e3 for k, v in c1.items()}
    hist += [(float(x), float(g)) for x, g in res]
    out.update(hist=hist, timed=timed, ms_per_step=wall / timed * 1e3,
               flash=list(read_flash_counts()), tier=list(read_tier_counts()),
               comm=dict(step.comm),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if spec["leg"] == "a":
        def one_step():
            nonlocal params, opt
            params, opt, loss, _ = step(params, opt, batches[-1])
            float(loss)
            return 1
        if spec["rank"] == 0:
            out["profile"] = profile_window(torch, one_step, "mesh step")
        else:
            one_step()
    else:
        masters = pretrain.gather_state_to_numpy(params, mesh, meta)
        if spec["rank"] == 0:
            np.savez(spec["masters"], **masters)
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def run_mesh_leg(leg, tmp):
    """Start every rank of `leg` as a process of this script over a
    FileStore in `tmp`, join them (bounded) and return their outputs in
    rank order; a rank that fails or hangs fails the phase with its log's
    tail."""
    name, mesh_kw, world, dtype, layers, seed, bseed, steps = leg
    procs = []
    try:
        for rank in range(world):
            spec = {"rank": rank, "world": world, "leg": name,
                    "store": os.path.join(tmp, f"store_{name}"),
                    "mesh": mesh_kw, "dtype": dtype, "layers": layers,
                    "seed": seed, "batch_seed": bseed, "steps": steps,
                    "out": os.path.join(tmp, f"{name}_rank{rank}.json"),
                    "masters": os.path.join(tmp, f"{name}_masters.npz")}
            path = os.path.join(tmp, f"{name}_rank{rank}_spec.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            log = open(os.path.join(tmp, f"{name}_rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 path], stdout=log, stderr=subprocess.STDOUT), spec, log))
        results = []
        deadline = time.monotonic() + MESH_JOIN_S
        for proc, spec, log in procs:
            try:
                rc = proc.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise SmokeFailure(f"mesh leg {name} rank {spec['rank']} "
                                   f"ended {rc}:\n{tail}")
            with open(spec["out"]) as f:
                results.append(json.load(f))
        return results, procs[0][1]
    finally:
        kill_followers(procs)   # kills a rank still running, closes logs


def mesh_reference(torch, leg):
    """Leg (b)'s reference: the one-card f32 step (kernels on) from the
    same seeded weights and batches: the (loss, gnorm) of each step and
    the masters after the last, as numpy."""
    from paddle_tpu_torch.models import LlamaForCausalLM, pretrain
    _, _, _, dtype, layers, seed, bseed, steps = leg
    cfg, batch, seq = mesh_config(dtype, layers)
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    params, opt, meta = pretrain.make_train_state(model, None)
    step = pretrain.make_train_step(model, None, meta)
    hist = []
    for b in mesh_batches(cfg, batch, seq, bseed, steps):
        params, opt, loss, gnorm = step(params, opt,
                                        pretrain.batch_to_device(b))
        hist.append((float(loss), float(gnorm)))
    masters = {n: t.cpu().numpy() for n, t in params.items()}
    del model, params, opt
    torch.cuda.empty_cache()
    return np.array(hist), masters


def phase_mesh(torch, train_stats):
    import shutil
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {"backend": "gloo, one card"}
    try:
        leg_a, leg_b = MESH_LEGS
        name, mesh_kw, world, dtype, layers, _, _, steps = leg_a
        cfg, batch, seq = mesh_config(dtype, layers)
        data = mesh_kw.get("dp", 1) * mesh_kw.get("fsdp", 1)
        rest, comm, n_params = mesh_analytic(cfg, mesh_kw, world,
                                             batch // data * seq)
        t0 = time.perf_counter()
        ranks, _ = run_mesh_leg(leg_a, tmp)
        out["a_wall_s"] = time.perf_counter() - t0
        per_step = tier_counts_per_step(cfg, False)
        for r in ranks:
            n = r["timed"]
            check(r["flash"] == [cfg.num_hidden_layers * n] * 2,
                  f"mesh (a) rank {r['rank']}: flash fwd / bwd launches "
                  f"{r['flash']} in {n} steps (want {cfg.num_hidden_layers} "
                  "each a step)")
            check(r["tier"] == [n * k for k in per_step],
                  f"mesh (a) rank {r['rank']}: fused tier launches "
                  f"{r['tier']} in {n} steps (want {per_step} a step)")
            check(r["rest_bytes"] == rest,
                  f"mesh (a) rank {r['rank']}: {r['rest_bytes']} bytes at "
                  f"rest, the specs give {rest}")
            check(r["comm"] == comm, f"mesh (a) rank {r['rank']}: "
                  f"collectives {r['comm']}, the formula gives {comm}")
            check(all(math.isfinite(x) for h in r["hist"] for x in h),
                  f"mesh (a) rank {r['rank']}: non-finite {r['hist']}")
        r0 = ranks[0]
        check(batch // data * seq == MESH_ROWS,
              f"mesh (a): {batch // data * seq} rows a rank, phase 18's "
              f"rank cases hold the tier at {MESH_ROWS}")
        loss0, ref0 = r0["hist"][0][0], train_stats["losses"][0]
        check(abs(loss0 - ref0) <= MESH_LOSS_RTOL * abs(ref0),
              f"mesh (a) step-0 loss {loss0} against phase 7's {ref0} "
              f"(rtol {MESH_LOSS_RTOL:g})")
        gn0, gref0 = r0["hist"][0][1], train_stats["grad_norms"][0]
        gn_rel = abs(gn0 - gref0) / abs(gref0)
        check(gn_rel <= MESH_GNORM_RTOL,
              f"mesh (a) step-0 grad norm {gn0} against phase 7's {gref0}: "
              f"relative {gn_rel:.3e} (rtol {MESH_GNORM_RTOL:g})")
        tokens_per_s = batch * seq / (r0["ms_per_step"] / 1e3)
        mfu = train_flops_per_token(cfg, n_params, seq) * tokens_per_s / \
            BF16_FLOPS_PER_S
        prof = r0.get("profile", {})
        idle = None if prof.get("device_busy_s") is None \
            else 1 - prof["device_busy_s"] / prof["wall_s"]
        out["a"] = {
            "mesh": mesh_kw, "ms_per_step": r0["ms_per_step"],
            "tokens_per_s": tokens_per_s, "mfu": mfu,
            "step0_loss": loss0, "phase7_step0_loss": ref0,
            "step0_grad_norm": gn0, "phase7_step0_grad_norm": gref0,
            "step0_grad_norm_rel": gn_rel,
            "losses": [h[0] for h in r0["hist"]],
            "grad_norms": [h[1] for h in r0["hist"]],
            "ms_per_step_by_rank": [r["ms_per_step"] for r in ranks],
            "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
            "rest_bytes": rest, "rank0_idle": idle,
            "collectives": r0["comm"], "launches_rank0": {
                "flash": r0["flash"], "tier": r0["tier"],
                "timed_steps": r0["timed"]},
            "rank0_profile": prof}
        print(f"  (a) fsdp 2 x mp 2, L={cfg.num_hidden_layers} B={batch} "
              f"S={seq} bf16: {r0['ms_per_step']:.1f} ms/step, "
              f"{tokens_per_s:.1f} global tokens/s, MFU {mfu:.4f} (one "
              f"card's 989 TFLOP/s; phase 7 {train_stats['ms_per_step']:.1f}"
              f" ms/step, {train_stats['tokens_per_s']:.1f} tokens/s); "
              f"step-0 loss {loss0:.5f} vs phase 7's {ref0:.5f}, grad norm "
              f"{gn0:.6f} vs {gref0:.6f} (relative {gn_rel:.2e}, rtol "
              f"{MESH_GNORM_RTOL:g}); peak GB by "
              f"rank {['%.2f' % r['peak_gb'] for r in ranks]} (phase 7 "
              f"{train_stats['peak_memory_gb']:.2f}); {rest} bytes at rest "
              f"a rank; rank 0 idle "
              f"{'not measured' if idle is None else '%.1f%%' % (idle * 100)}"
              f"; launches a rank in {r0['timed']} steps: flash "
              f"{r0['flash']}, tier {r0['tier']}", flush=True)
        print(f"  (a) collectives a step on rank 0: "
              f"{json.dumps(r0['comm'])}", flush=True)
        inside = r0["collective_ms_per_step"]
        out["a"]["collective_ms_per_step_rank0"] = inside
        print(f"  (a) rank 0's host ms a step inside collectives (dispatch to "
              f"result): {sum(inside.values()):.1f} of "
              f"{r0['ms_per_step']:.1f}; by op, axis "
              f"{json.dumps({k: round(v, 1) for k, v in inside.items()})}",
              flush=True)

        name, mesh_kw, world, dtype, layers, _, _, steps = leg_b
        ref_hist, ref_masters = mesh_reference(torch, leg_b)
        ranks, spec0 = run_mesh_leg(leg_b, tmp)
        got = np.array(ranks[0]["hist"])
        rel = np.abs(got - ref_hist) / np.abs(ref_hist)
        for r in ranks:
            check(np.array_equal(np.array(r["hist"]), got),
                  f"mesh (b) rank {r['rank']}: (loss, gnorm) {r['hist']} "
                  f"differ from rank 0's {got.tolist()}")
        check(float(rel.max()) <= TRAIN_RTOL,
              f"mesh (b) (loss, gnorm) {got.tolist()} against the one-card "
              f"step {ref_hist.tolist()}: worst rel {float(rel.max()):.2e}")
        masters = np.load(spec0["masters"])
        # per tensor: its largest difference and the one that 99.9% of its
        # elements stay within (every element of a 1-D tensor)
        per = {}
        for n in ref_masters:
            d = np.abs(masters[n] - ref_masters[n]).ravel()
            per[n] = (float(d.max()), float(d.max() if ref_masters[n].ndim
                                            == 1 else np.quantile(d, 0.999)))
        worst_n = max(per, key=lambda n: per[n][0])
        bulk_n = max(per, key=lambda n: per[n][1])
        worst, q999 = per[worst_n][0], per[bulk_n][1]
        check(worst <= MESH_MASTER_ATOL and q999 <= MESH_MASTER_BULK,
              f"mesh (b) masters after {steps} steps: max abs diff {worst} "
              f"in {worst_n} (allowed {MESH_MASTER_ATOL:g}); worst tensor's "
              f"99.9th percentile (max for a 1-D tensor) {q999} in {bulk_n}"
              f" (allowed {MESH_MASTER_BULK:g})")
        one_d = max(v[0] for n, v in per.items() if ref_masters[n].ndim == 1)
        out["b"] = {"mesh": mesh_kw, "hist": got.tolist(),
                    "one_card": ref_hist.tolist(),
                    "worst_rel": float(rel.max()),
                    "masters_max_abs": worst, "masters_max_tensor": worst_n,
                    "masters_q999_worst_tensor": q999,
                    "masters_q999_tensor": bulk_n,
                    "masters_1d_max_abs": one_d,
                    "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
                    "collectives_rank0": ranks[0]["comm"]}
        print(f"  (b) dp 2 x fsdp 2 x mp 2, f32 L={layers}: (loss, gnorm) "
              f"{got.tolist()} vs one card {ref_hist.tolist()}, worst rel "
              f"{float(rel.max()):.2e} (rtol {TRAIN_RTOL:g}); masters max "
              f"abs diff {worst:.3e} ({worst_n}), worst tensor's 99.9th "
              f"percentile {q999:.3e} ({bulk_n}), 1-D tensors' max "
              f"{one_d:.3e}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
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
        print("phase 19: the HTTP/SSE gateway and its stepper thread, full "
              "width, bf16", flush=True)
        gateway_stats = phase_gateway(torch)
        print("phase 20: two replicas behind EngineRouter, full width, bf16 "
              "(f32 at L=2 for the tokens)", flush=True)
        router_stats = phase_router(torch)
        print("phase 25: kv-head-sharded tensor-parallel serving, full "
              "width: tp=2 over gloo in two processes on the card (f32, "
              "bf16, int8 and int4), tp=4 at L=2", flush=True)
        tp_stats = phase_tp(torch)

    # training needs autograd: phases 5-8 run outside no_grad
    print("phase 5: flash kernels against their plain versions (bf16)",
          flush=True)
    flash_rows = phase_flash(torch)
    print("phase 6: Llama forward at the forward entry's shape, bf16",
          flush=True)
    fwd_stats = phase_forward(torch)
    print("phase 7: flagship pretraining, bf16 AMP-O2, B=8 S=2048",
          flush=True)
    train_stats = phase_train(torch)
    print("phase 8: f32 training parity, full width, L=2", flush=True)
    parity_stats = phase_train_parity(torch)
    print("phase 9: blockwise cross-entropy kernels against their plain "
          "versions (bf16)", flush=True)
    ce_rows = phase_ce(torch)
    print("phase 10: flash kernels with rope against their plain versions "
          "(bf16)", flush=True)
    rope_rows = phase_flash_rope(torch)
    print("phase 11: flagship pretraining with the fused LM-head loss and "
          "rope in the flash kernels, bf16 AMP-O2, B=8 S=2048", flush=True)
    fused_stats = phase_train(torch, FUSED_OPTIONS)
    print(f"  beside phase 7: tokens/s {fused_stats['tokens_per_s']:.1f} vs "
          f"{train_stats['tokens_per_s']:.1f}, ms/step "
          f"{fused_stats['ms_per_step']:.1f} vs "
          f"{train_stats['ms_per_step']:.1f}, MFU {fused_stats['mfu']:.4f} "
          f"vs {train_stats['mfu']:.4f}, peak memory "
          f"{fused_stats['peak_memory_gb']:.2f} GB vs "
          f"{train_stats['peak_memory_gb']:.2f} GB", flush=True)
    check(fused_stats["peak_memory_gb"] < train_stats["peak_memory_gb"],
          f"peak memory with the fused loss {fused_stats['peak_memory_gb']} "
          f"GB is not below phase 7's {train_stats['peak_memory_gb']} GB")
    print("phase 12: f32 training parity with both options, full width, L=2",
          flush=True)
    fused_parity = phase_train_parity(torch, FUSED_OPTIONS)
    print("phase 13: FlashMask kernels against their plain versions (bf16), "
          f"then {L} layers' FlashMask attention", flush=True)
    fm_rows = phase_flashmask(torch)
    fm_step = phase_flashmask_step(torch)
    print("phase 14: FlashMask in f32, B=2 S=2048", flush=True)
    fm_f32 = phase_flashmask_f32(torch)
    print("phase 15: the two-pass flash backward at the flagship shape (A/B "
          "against the fused backward)", flush=True)
    tp_rows, tp_launches = phase_twopass(torch)
    with torch.no_grad():
        print("phase 16: legacy paged decode attention (bf16; f32 for one "
              f"case), then {DECODE_STEPS} steps x {L} layers of "
              "block_multihead_attention", flush=True)
        decode_rows, decode_stats = phase_paged_decode(torch)
        print("phase 17: int8 weight-only GEMM, int8 serving, dense decode "
              "and f32 parity", flush=True)
        int8_rows, int8_stats = phase_int8(torch)
    print("phase 18: the training step's fused tier (RMSNorm + residual, "
          "SwiGLU, token cross entropy, AdamW) against its plain versions",
          flush=True)
    tier_rows = phase_fused_tier(torch)
    print("phase 21: flagship pretraining with activation recompute (True, "
          "then \"dots_saveable\"), bf16 AMP-O2, B=8 S=2048", flush=True)
    recompute_stats = phase_recompute(torch, train_stats)
    print("phase 22: the flagship with in-step telemetry, the health "
          "monitor and the instrumented DataLoader; the NaN'd batch; the "
          "train_health gate on the card; kernel D's telemetry alone",
          flush=True)
    health_stats, tel_rows = phase_health(torch, train_stats)
    with torch.no_grad():
        print("phase 23: fused_multi_transformer's pre_caches, attn_mask and "
              "dropout and FusedMultiTransformer at the serving flagship's "
              "width (L=24), f32 and bf16", flush=True)
        incubate_stats = phase_incubate(torch)
        print("phase 24: phase 2's serving with the memory monitor, pressure "
              "shedding and the cost catalog; the pressure leg", flush=True)
        obs_stats = phase_observability(torch)
    print("phase 24 (c): phase 7's step with the cost catalog", flush=True)
    obs_stats["train"] = phase_train_catalog(torch, train_stats)
    print("phase 26: the sharded pretrain mesh over gloo in processes on "
          "the card: (a) the flagship on fsdp 2 x mp 2, bf16; (b) f32 L=2 "
          "on dp 2 x fsdp 2 x mp 2", flush=True)
    mesh_stats = phase_mesh(torch, train_stats)

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
        kernel_entry("flash_attention_fwd",
                     "paddle_tpu_torch/csrc/flash_attention.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:78",
                     train_stats["flash_fwd_launches"],
                     flash_rows["fwd"] + rope_rows["fwd"],
                     "flagship_b8_s2048_h16_d64"),
        kernel_entry("flash_attention_bwd",
                     "paddle_tpu_torch/csrc/flash_attention.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:223",
                     train_stats["flash_bwd_launches"],
                     flash_rows["bwd"] + rope_rows["bwd"],
                     "flagship_b8_s2048_h16_d64"),
    ]
    # the rope cases' launches are phase 11's, where every flash launch
    # carried the tables
    for entry, n in zip(kernels[2:], fused_stats["rope_flash_launches"]):
        entry["rope_launches"] = n
    for i, (key, line) in enumerate((("fwd", 57), ("dh", 179),
                                     ("dw", 209))):
        kernels.append(kernel_entry(
            f"blockwise_ce_{key}", "paddle_tpu_torch/csrc/blockwise_ce.cu",
            f"paddle_tpu/ops/pallas/blockwise_ce.py:{line}",
            fused_stats["ce_launches"][i], ce_rows[key],
            "flagship_t16384_h1024_v32000"))
    fm_main = flashmask_specs()[0][0]
    for i, (key, line) in enumerate((("fwd", 69), ("dq", 123),
                                     ("dkv", 170))):
        kernels.append(kernel_entry(
            "flashmask_" + ("fwd" if key == "fwd" else f"bwd_{key}"),
            "paddle_tpu_torch/csrc/flashmask.cu",
            f"paddle_tpu/ops/pallas/flashmask.py:{line}",
            fm_step["launches"][i], fm_rows[key], fm_main))
    for i, (key, line) in enumerate((("dq", 316), ("dkv", 370))):
        kernels.append(kernel_entry(
            f"flash_bwd_twopass_{key}", "paddle_tpu_torch/csrc/flashmask.cu",
            f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            tp_launches[i], tp_rows[key], "flagship_b8_s2048_h16_d64"))
    kernels.append(kernel_entry(
        "paged_decode_attention",
        "paddle_tpu_torch/csrc/paged_decode_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:74",
        decode_stats["launches"], decode_rows, "b_serving_cache"))
    kernels.append(kernel_entry(
        "weight_only_int8", "paddle_tpu_torch/csrc/weight_only_matmul.cu",
        "paddle_tpu/ops/pallas/quant_matmul.py:65",
        int8_stats["int8_launches"], int8_rows, f"M8_K{E}_N{2 * F}"))
    tier_launches = train_stats["tier_launches"]
    for i, (name, source, replaces, key, case) in enumerate((
            ("fused_norm_fwd", "fused_norm", "nn/functional/norm.py:81",
             "norm_fwd", "flagship_r16384_h1024"),
            ("fused_norm_bwd", "fused_norm", "nn/functional/norm.py:81",
             "norm_bwd", "flagship_r16384_h1024"),
            ("swiglu_fwd", "swiglu", "models/llama.py:209",
             "swiglu_fwd", "flagship_r16384_im2816"),
            ("swiglu_bwd", "swiglu", "models/llama.py:209",
             "swiglu_bwd", "flagship_r16384_im2816"),
            ("token_ce_fwd", "token_ce", "nn/functional/loss.py:23",
             "ce_fwd", "flagship_n16384_v32000"),
            ("token_ce_bwd", "token_ce", "nn/functional/loss.py:23",
             "ce_bwd", "flagship_n16384_v32000"),
            ("adamw", "adamw", "models/pretrain.py:176", "adamw",
             tier_rows["adamw"][0]["case"]))):
        # no pallas_call stands behind these: "replaces" names the JAX
        # source whose XLA fusion each kernel takes over
        kernels.append(kernel_entry(
            name, f"paddle_tpu_torch/csrc/{source}.cu",
            f"paddle_tpu/{replaces}", tier_launches[i], tier_rows[key],
            case))
    # kernel D's telemetry instance: launch 2 with the group sums and the
    # packed vector (no pallas_call: the JAX step's _pack_telemetry is an
    # XLA fusion), counted in phase 22's telemetry run
    kernels.append(kernel_entry(
        "adamw_telemetry", "paddle_tpu_torch/csrc/adamw.cu",
        "paddle_tpu/models/pretrain.py:205",
        health_stats["telemetry_launches"], tel_rows,
        tel_rows[0]["case"]))
    check(len(kernels) == 22 and all(e["launches"] > 0 for e in kernels),
          f"kernel entries {[(e['name'], e['launches']) for e in kernels]}")
    print(f"card: {card}; FlashMask step: {json.dumps(fm_step)}; f32: "
          f"{json.dumps(fm_f32)}", flush=True)
    print(f"card: {card}; serve: {json.dumps(serve_stats)}; int4 serve: "
          f"{json.dumps(int4_stats)}", flush=True)
    print(f"card: {card}; gateway: {json.dumps(gateway_stats)}; router: "
          f"{json.dumps(router_stats)}", flush=True)
    print(f"card: {card}; forward: {json.dumps(fwd_stats)}; train: "
          f"{json.dumps(train_stats)}; f32 parity: "
          f"{json.dumps(parity_stats)}", flush=True)
    print(f"card: {card}; train with the fused loss and rope: "
          f"{json.dumps(fused_stats)}; f32 parity with both: "
          f"{json.dumps(fused_parity)}", flush=True)
    print(f"card: {card}; decode op: {json.dumps(decode_stats)}; int8: "
          f"{json.dumps(int8_stats)}", flush=True)
    print(f"card: {card}; fused tier: {json.dumps(tier_rows)}", flush=True)
    print(f"card: {card}; recompute: {json.dumps(recompute_stats)}; "
          f"telemetry and health: {json.dumps(health_stats)}", flush=True)
    print(f"card: {card}; incubate options: {json.dumps(incubate_stats)}; "
          f"observability: {json.dumps(obs_stats)}", flush=True)
    print(f"card: {card}; tensor parallel: {json.dumps(tp_stats)}",
          flush=True)
    print(f"card: {card}; sharded pretrain mesh: {json.dumps(mesh_stats)}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--tp-follower"]:
            rc = tp_follower(sys.argv[2])
        elif sys.argv[1:2] == ["--mesh-rank"]:
            rc = mesh_rank(sys.argv[2])
        else:
            rc = main()
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
