"""Kernel autotune layer of the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/autotune.py``; reference
paddle/phi/kernels/autotune/ — cache + gpu_timer: time candidate
configurations once per key, remember the winner across the process and
across runs).

Two tiers, as in the JAX module:

* the generic ``autotune(key, candidates, run)`` harness: the first time
  a key is seen, each candidate runs once to warm up and ``reps`` times
  timed (CUDA events for a CUDA result, the host clock for a CPU one);
  a candidate that raises is skipped (``cache_stats()["skipped"]``); the
  winner is served from an in-memory and on-disk JSON cache after that
  (write-through, atomic replace). The cache path follows
  ``PADDLE_TPU_AUTOTUNE_CACHE`` or ``~/.cache/paddle_tpu_torch/
  autotune.json``.
* the serving sweep. ``sweep_ragged_serve`` sweeps one (shape class,
  occupancy bucket) of the ragged paged-attention kernel (K3,
  ``csrc/ragged_paged_attention.cu``): the scheduler's work-list
  ``pack`` and ``prefill_chunk``, as in JAX, and in the place of JAX's
  ``buffer_depth`` the kernel's page-split knob ``split_waves`` (the
  waves of SMs a split grid aims to cover, ``ops.paged_attention.
  split_pages``; the legacy decode kernel K7 shares it). Off the card
  (``measure=False``) JAX's model at depth 2 ranks ``pack`` /
  ``prefill_chunk`` (so the port's pack and chunk are JAX's for the same
  bucket) and the port's own term ranks ``split_waves`` (the kernel's
  waves of blocks times the pages a block walks, plus the split
  workspace's bytes written and read): a CPU run reproduces its winners
  bit for bit. On the card only ``split_waves`` is swept: each split plan
  is timed through K3 on synthetic live inputs (device time), while pack
  and chunk stay at the bucket's own (the default pack, the bucket's slab
  width). Neither changes K3's launch, and JAX's model of them is a TPU's,
  so a card's cache never moves the scheduler's chunk on a guess. The
  winner's arithmetic intensity is cross-checked as in JAX (more than 10%
  under the default's is suspect).
  ``sweep_wo_gemm`` sweeps the weight-only GEMM's plan knobs (K4,
  ``csrc/weight_only_matmul.cu``: column tile ``bn`` and split
  ``waves``) per shape over ``autotune()`` and writes a ``wo_gemm`` table
  into the same cache.

The engines read a saved cache once, at construction
(``FusedMultiTransformerEngine`` / ``ContinuousBatchingEngine``
``autotune_cache=``): no per-step host work, no new step buckets after
warm-up. The port writes its own schema (``SERVE_SCHEMA``); an entry it
measured names the card (``torch.cuda.get_device_name``), and
``load_serve_cache`` gives None for a JAX cache, a broken file or
entries measured on another card, so the engine keeps its defaults.

What has no counterpart: ``kv_buffer_depth`` (the Pallas DMA pipeline
depth; the CUDA kernel streams pages through its own ``cp.async`` ring)
and the Mosaic compiler settings ``cparams`` / ``VMEM_LIMIT``. ``pack``
is kept, and is bookkeeping only on the card: the CUDA kernel walks the
block tables, and the work list's padded length keys the scheduler's
step buckets.
"""
import json
import os
import time

import numpy as np
import torch

__all__ = ["autotune", "cache_stats", "clear_cache",
           "SERVE_SCHEMA", "serve_shape_class", "serve_bucket_key",
           "ragged_cost_model", "split_cost_model", "ragged_candidates",
           "sweep_ragged_serve", "bucket_inputs", "sweep_wo_gemm",
           "wo_gemm_key", "load_serve_cache", "save_serve_cache",
           "serve_winner", "serve_winner_for_engine", "wo_gemm_plans",
           "card_of"]


def _metrics():
    from ..observability import instrument
    return instrument


_mem = None
_stats = {"hits": 0, "misses": 0, "tuned": 0, "skipped": 0}


def _cache_path():
    return os.environ.get(
        "PADDLE_TPU_AUTOTUNE_CACHE",
        os.path.expanduser("~/.cache/paddle_tpu_torch/autotune.json"))


def _load():
    global _mem
    if _mem is None:
        try:
            with open(_cache_path()) as f:
                _mem = json.load(f)
        except Exception:
            _mem = {}
    return _mem


def _save():
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_mem, f)
        os.replace(tmp, path)
    except Exception:
        pass  # the cache is an optimization; never fail the op


def cache_stats():
    return dict(_stats, entries=len(_load()))


def clear_cache():
    global _mem
    _mem = {}
    try:
        os.unlink(_cache_path())
    except FileNotFoundError:
        pass


def _kernel_label(key):
    # bounded metric label: the kernel family prefix, never the full
    # shape-bearing key
    return str(key).split(":", 1)[0].split("/", 1)[0] or "unknown"


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


_SLEEP_CYCLES = 5_000_000      # ~2.5 ms of a sleep kernel at ~2 GHz


def _timed(run, cand, reps):
    """Seconds a call of ``run(cand)`` takes: one warm-up call, then
    ``reps`` calls between two CUDA events queued behind a sleep kernel,
    so that the card never waits for the host's enqueue and the events
    time the device alone (a CUDA result), or on the host clock (anything
    else)."""
    out = _first_tensor(run(cand))
    if out is not None and out.is_cuda:
        torch.cuda.synchronize(out.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            run(cand)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        run(cand)
    return (time.perf_counter() - t0) / reps


def autotune(key, candidates, run, reps=3):
    """Return the best candidate for ``key`` (a string).

    ``run(candidate)`` executes the kernel with that configuration and
    returns its output. Timing: one warm-up call and ``reps`` timed calls
    a candidate (``_timed``). The winner persists in the JSON cache under
    ``key``. A candidate that raises is skipped (a tile the kernel
    rejects) and counted in ``cache_stats()["skipped"]``; RuntimeError
    when every candidate fails."""
    cache = _load()
    key = str(key)
    hit = cache.get(key)
    if hit is not None:
        _stats["hits"] += 1
        _metrics().autotune_cache_hits().inc()
        # stored as a list (JSON); candidates are tuples
        return tuple(hit) if isinstance(hit, list) else hit
    _stats["misses"] += 1
    _metrics().autotune_cache_misses().inc()
    trials = _metrics().autotune_trials().labels(kernel=_kernel_label(key))
    best, best_t = None, None
    for cand in candidates:
        try:
            dt = _timed(run, cand, reps)
        except Exception:
            _stats["skipped"] += 1
            continue
        trials.inc()
        if best_t is None or dt < best_t:
            best, best_t = cand, dt
    if best is None:
        raise RuntimeError(f"autotune: every candidate failed for {key}")
    _stats["tuned"] += 1
    cache[key] = list(best) if isinstance(best, tuple) else best
    _save()
    return best


# -- serving-kernel sweep (ragged paged attention) -----------------------

SERVE_SCHEMA = "paddle_tpu_torch.serve_autotune/1"
_SERVE_KERNEL = "ragged_paged_attention"
TUNABLES = ("pack", "prefill_chunk", "split_waves")

# JAX's analytic model, unchanged (nominal v5e-class figures; only ratios
# matter: it ranks pack / prefill_chunk and gives the intensity the
# measured winners are cross-checked against)
_PEAK_FLOPS = 180e12
_PEAK_BW = 820e9
_SWAP_S = 2e-6
_DMA_LAT_S = 5e-7
_SUBLANE = 8
# the split term's card: H100 SXM (132 SMs, 3.35 TB/s); on the card the
# sweep takes the card's own SM count
NOMINAL_SMS = 132
_CARD_BW = 3.35e12


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    try:
        return np.dtype(dtype).name
    except Exception:
        return str(dtype)


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, _dtype_name(dtype))


def serve_shape_class(kv_heads, group_q, block_size, head_dim, dtype):
    """Shape-class key: everything that keys the kernel's geometry EXCEPT
    the per-step occupancy (which the bucket key carries). JAX's key."""
    return (f"kvh{int(kv_heads)}_g{int(group_q)}_bs{int(block_size)}"
            f"_d{int(head_dim)}_{_dtype_name(dtype)}")


def serve_bucket_key(t_total, chunk):
    """Occupancy-bucket key: the (padded work-list length, chunk width)
    pair ``ContinuousBatchingEngine._seen_buckets`` tracks. JAX's key."""
    return f"t{int(t_total)}_c{int(chunk)}"


def ragged_cost_model(pack, chunk, group_q, block_size, head_dim,
                      t_total, kv_heads, batch, itemsize=4,
                      buffer_depth=2):
    """JAX's analytic per-bucket cost of one ragged-kernel call under a
    candidate (``paddle_tpu/ops/pallas/autotune.py`` ``ragged_cost_model``,
    the same numbers): ``flops`` (valid query rows only), ``bytes`` (KV
    traffic and q/out block revisits), ``intensity`` and
    ``model_wall_s``. The sweep prices every candidate at depth 2."""
    pg = int(pack) * int(chunk) * int(group_q)
    rows_eff = -(-pg // _SUBLANE) * _SUBLANE
    steps = int(kv_heads) * int(t_total)
    flops_step = 4.0 * rows_eff * block_size * head_dim
    kv_bytes_step = 2.0 * block_size * head_dim * itemsize
    compute_s = flops_step / _PEAK_FLOPS
    dma_s = kv_bytes_step / _PEAK_BW
    per_step = (compute_s + dma_s + _DMA_LAT_S) if buffer_depth == 1 \
        else max(compute_s, dma_s)
    ngroups = -(-int(batch) // int(pack))
    swaps = ngroups * int(kv_heads)
    wall = (steps * per_step + swaps * _SWAP_S
            + (int(buffer_depth) - 1) * dma_s)
    useful_flops = 4.0 * chunk * group_q * block_size * head_dim * steps
    total_bytes = (steps * kv_bytes_step
                   + swaps * 2.0 * pg * head_dim * itemsize)
    return {
        "flops": useful_flops,
        "bytes": total_bytes,
        "intensity": useful_flops / max(total_bytes, 1.0),
        "model_wall_s": wall,
    }


def split_cost_model(batch, chunk, kv_heads, group_q, max_nb, block_size,
                     head_dim, itemsize, split_waves, sms=NOMINAL_SMS):
    """The port's term for the split knob: K3's plan (``ragged_plan`` at
    ``split_waves``) for q [batch, chunk, kv_heads * group_q, head_dim]
    against tables of ``max_nb`` pages, priced as the waves of blocks the
    grid takes times the pages one block walks (each page's K and V
    streamed at an SM's share of the card's bandwidth), plus the split
    workspace written and read once. Returns {"split_s", "splits",
    "pages_per_split", "blocks", "workspace_bytes"}."""
    from .paged_attention import ragged_plan
    plan = ragged_plan(int(batch), int(chunk), int(kv_heads * group_q),
                       int(kv_heads), int(max_nb), int(block_size),
                       int(head_dim), torch.float32, int(sms),
                       int(split_waves))
    page_s = 2.0 * block_size * head_dim * itemsize / (_CARD_BW / sms)
    waves = -(-plan["blocks"] // int(sms))
    split_s = waves * plan["pages_per_split"] * page_s \
        + 2.0 * plan["workspace_bytes"] / _CARD_BW
    return {"split_s": split_s, "splits": plan["splits"],
            "pages_per_split": plan["pages_per_split"],
            "blocks": plan["blocks"],
            "workspace_bytes": plan["workspace_bytes"]}


def ragged_candidates(batch, group_q, chunk=None, max_chunk=256,
                      waves=(1, 2, 4)):
    """The candidate grid for one bucket: JAX's pow2 packs up to the
    batch and pow2 chunk widths up to ``max_chunk`` (a decode bucket,
    ``chunk=None``, pins chunk to 1), with the split ``waves`` in JAX's
    ``buffer_depth`` place. Chunks stay in the pow2 family, so a tuned
    width never mints a step bucket the default treadmill would not."""
    packs, p = [], 1
    while p <= max(1, int(batch)):
        packs.append(p)
        p *= 2
    if chunk is None:
        chunks = [1]
    else:
        chunks, c = [], 1
        while c <= max(int(chunk), 1):
            if c <= max_chunk:
                chunks.append(c)
            c *= 2
    return [{"pack": pk, "prefill_chunk": ch, "split_waves": int(w)}
            for pk in packs for ch in chunks for w in waves]


def _model_score(rec):
    """Deterministic ranking tuple off the card: JAX's score at depth 2
    (model wall per token, then the tile that fills the sublane granule,
    the smaller tile) ranks pack / prefill_chunk; the split term, then
    the rule's waves and fewer waves, break what is left."""
    from .paged_attention import SPLIT_WAVES
    pg = rec["pack"] * rec["prefill_chunk"] * rec["_group_q"]
    tokens = max(1, rec["_batch"] * rec["prefill_chunk"])
    return (rec["model_wall_s"] / tokens, -min(pg, _SUBLANE), pg,
            rec["split_s"], abs(rec["split_waves"] - SPLIT_WAVES),
            rec["split_waves"])


def card_of(device):
    """The card's name for a CUDA ``device`` (what a measured entry
    records), None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def bucket_inputs(kv_heads, group_q, head_dim, block_size, context_lens,
                  chunk=None, dtype="float32", seed=0, device="cuda"):
    """Synthetic live inputs of one bucket on ``device``: (q, k_cache,
    v_cache, block tables, context lens, q_lens). Tables give each
    sequence its own pages; q is [B, H, D] for a decode bucket and
    [B, chunk, H, D] with q_lens min(max(len, 1), chunk) for a prefill
    one. The sweep times K3 on them; the card's smoke holds every split
    against the plain version on them."""
    tdt = _torch_dtype(dtype)
    lens = np.asarray(context_lens, np.int64).reshape(-1)
    batch = int(lens.shape[0])
    max_nb = max(1, int(-(-int(lens.max(initial=1)) // block_size)))
    tables = np.arange(batch * max_nb, dtype=np.int32).reshape(batch, max_nb)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    h = kv_heads * group_q
    shape = (kv_heads, batch * max_nb, block_size, head_dim)
    kc = (torch.randn(shape, generator=gen) * 0.1).to(tdt).to(device)
    vc = (torch.randn(shape, generator=gen) * 0.1).to(tdt).to(device)
    if chunk is None:
        q = torch.randn((batch, h, head_dim), generator=gen) * 0.1
        q_lens = None
    else:
        q = torch.randn((batch, int(chunk), h, head_dim), generator=gen) * 0.1
        q_lens = torch.as_tensor(np.minimum(np.maximum(lens, 1), int(chunk)),
                                 dtype=torch.int32).to(device)
    return (q.to(tdt).to(device), kc, vc,
            torch.as_tensor(tables).to(device),
            torch.as_tensor(lens, dtype=torch.int32).to(device), q_lens)


def sweep_ragged_serve(kv_heads, group_q, head_dim, block_size,
                       context_lens, *, chunk=None, dtype="float32",
                       candidates=None, waves=(1, 2, 4), reps=3,
                       measure=None, cache=None, seed=0, device="cuda"):
    """Sweep the ragged kernel's tunables for ONE (shape class, occupancy)
    bucket and record the winner in ``cache`` (a serve cache dict; a new
    one when None), which is returned.

    ``context_lens`` is the bucket's occupancy (one post-step KV length an
    active sequence); ``chunk=None`` sweeps a decode bucket, an int a
    prefill bucket of that slab width. With ``measure`` (default: a CUDA
    device is present) the candidates are the ``waves`` at the default
    pack and the bucket's own chunk (module docstring); each split plan
    runs through K3 on ``bucket_inputs`` on ``device``, is timed on CUDA
    events and ranked by its device time, with JAX's intensity
    cross-check on the winner (``suspect``). A candidate the kernel
    refuses is skipped and counted (``skipped`` in the entry). Otherwise
    JAX's model (``_model_score``'s head) ranks pack and chunk and the
    model's split term ``split_waves``, deterministically. Every trial
    lands in the cost catalog (when enabled) and on the ``tuning`` tracer
    span."""
    from ..observability import tracing as _tracing
    from ..observability.costs import get_cost_catalog
    from .paged_attention import (SPLIT_WAVES, build_ragged_work,
                                  default_pack, next_pow2,
                                  ragged_paged_attention)

    lens = np.asarray(context_lens, np.int64).reshape(-1)
    batch = int(lens.shape[0])
    itemsize = _torch_dtype(dtype).itemsize
    c_width = 1 if chunk is None else int(chunk)
    shape_cls = serve_shape_class(kv_heads, group_q, block_size, head_dim,
                                  dtype)
    # the bucket is keyed by the DEFAULT config's padded work length: the
    # same (t_total, c) pair the scheduler's _seen_buckets tracks
    max_nb = max(1, int(-(-int(lens.max(initial=1)) // block_size)))
    tables = np.arange(batch * max_nb, dtype=np.int32).reshape(batch, max_nb)
    dflt_pack = default_pack(batch, group_q)
    q_lens = None if chunk is None \
        else np.minimum(np.maximum(lens, 1), c_width).astype(np.int64)
    _, _, t_total, _ = build_ragged_work(
        tables, lens, block_size, dflt_pack, bucket_to=next_pow2,
        q_lens=q_lens)
    bucket = serve_bucket_key(t_total, next_pow2(c_width))

    if measure is None:
        measure = torch.cuda.is_available()
    if candidates is None and measure:
        candidates = [{"pack": dflt_pack, "prefill_chunk": c_width,
                       "split_waves": int(w)} for w in waves]
    elif candidates is None:
        candidates = ragged_candidates(batch, group_q, chunk=chunk,
                                       waves=waves)
    card = sms = None
    if measure:
        device = torch.device(device)
        card = card_of(device)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        inputs = bucket_inputs(kv_heads, group_q, head_dim, block_size,
                               lens, chunk, dtype, seed, device)
        timed = {}

        def wall_of(w):
            if w not in timed:
                q, kc, vc, tb, ln, ql = inputs
                try:
                    timed[w] = _timed(lambda _: ragged_paged_attention(
                        q, kc, vc, tb, ln, q_lens=ql, split_waves=w),
                        None, reps)
                except Exception:
                    timed[w] = None
            return timed[w]

    catalog = get_cost_catalog()
    trials = _metrics().autotune_trials().labels(kernel=_SERVE_KERNEL)
    records, skipped = [], 0
    with _tracing.get_tracer().span(
            "tuning", kernel=_SERVE_KERNEL, shape_class=shape_cls,
            bucket=bucket, candidates=len(candidates)):
        for cand in candidates:
            model = ragged_cost_model(
                cand["pack"], cand["prefill_chunk"], group_q, block_size,
                head_dim, t_total, kv_heads, batch, itemsize=itemsize)
            split = split_cost_model(
                batch, c_width, kv_heads, group_q, max_nb, block_size,
                head_dim, itemsize, cand["split_waves"],
                sms or NOMINAL_SMS)
            rec = dict(cand, **model, **split, measured=bool(measure))
            rec["_group_q"] = group_q
            rec["_batch"] = batch
            if measure:
                wall = wall_of(cand["split_waves"])
                if wall is None:
                    skipped += 1
                    continue        # a plan the kernel refused
                rec["wall_s"] = wall
            else:
                rec["wall_s"] = model["model_wall_s"] + split["split_s"]
            trials.inc()
            if catalog is not None and getattr(catalog, "enabled", False):
                catalog.record(
                    f"autotune/{_SERVE_KERNEL}",
                    flops=model["flops"], bytes_accessed=model["bytes"],
                    signature=f"{shape_cls}/{bucket}/pack{cand['pack']}"
                              f"_c{cand['prefill_chunk']}"
                              f"_waves{cand['split_waves']}")
            records.append(rec)
    _stats["skipped"] += skipped
    if not records:
        raise RuntimeError(f"sweep_ragged_serve: every candidate failed for "
                           f"{shape_cls}/{bucket}")

    base_intensity = min(
        (r["intensity"] for r in records
         if r["pack"] == dflt_pack and r["split_waves"] == SPLIT_WAVES),
        default=max(r["intensity"] for r in records))
    if measure:
        win = min(records, key=lambda r: _model_score(r)[:3] + (
            r["wall_s"], abs(r["split_waves"] - SPLIT_WAVES),
            r["split_waves"]))
        win = dict(win, suspect=win["intensity"] < 0.9 * base_intensity)
    else:
        win = dict(min(records, key=_model_score), suspect=False)

    entry = {k: win[k] for k in TUNABLES}
    entry.update(
        wall_us=round(win["wall_s"] * 1e6, 3),
        intensity=round(win["intensity"], 4),
        measured=win["measured"], suspect=win["suspect"],
        trials=len(records), skipped=skipped, card=card,
        splits=win["splits"], pages_per_split=win["pages_per_split"])
    if measure:
        # each plan's device time, for the record
        entry["plan_us"] = {str(w): None if t is None else round(t * 1e6, 3)
                            for w, t in sorted(timed.items())}
    g = _metrics().autotune_winner()
    for param in TUNABLES:
        g.labels(kernel=_SERVE_KERNEL, param=param).set(entry[param])

    if cache is None:
        cache = {"schema": SERVE_SCHEMA, "kernel": _SERVE_KERNEL,
                 "shapes": {}}
    sec = cache.setdefault("shapes", {}).setdefault(shape_cls, {})
    sec.setdefault("buckets", {})[bucket] = entry
    buckets = sec["buckets"]

    def vote(field, rows):
        tally = {}
        for b in rows:
            tally[b[field]] = tally.get(b[field], 0.0) \
                + float(b.get("wall_us", 1.0))
        return max(sorted(tally), key=lambda k: tally[k])

    # pack / split_waves vote across every bucket (weighted toward the
    # bucket that costs the most); prefill_chunk among the prefill buckets
    # only: a decode bucket's pinned chunk 1 never talks the scheduler
    # into one-token-at-a-time prefill
    prefill_rows = [b for b in buckets.values()
                    if b["prefill_chunk"] > 1] or list(buckets.values())
    sec["winner"] = {
        "pack": vote("pack", buckets.values()),
        "prefill_chunk": vote("prefill_chunk", prefill_rows),
        "split_waves": vote("split_waves", buckets.values()),
    }
    return cache


# -- the weight-only GEMM's plan knobs -----------------------------------

def _wo_entry(m, k, n, dtype):
    """The ``wo_gemm`` table's key of a GEMM: ``mc{class}_k{K}_n{N}_{dtype}``
    with ``quant_matmul.m_class(M)``."""
    from .quant_matmul import m_class
    return f"mc{m_class(m)}_k{int(k)}_n{int(n)}_{_dtype_name(dtype)}"


def wo_gemm_key(kind, m, k, n, dtype):
    """The autotune cache key of one K4 shape class:
    ``wo_gemm_{kind}:mc{class}_k{K}_n{N}_{dtype}`` (its family prefix is
    the metric label); every M of a class shares it."""
    return f"wo_gemm_{kind}:{_wo_entry(m, k, n, dtype)}"


def sweep_wo_gemm(shapes, kind, dtype="bfloat16", bns=(64, 128),
                  waves=(1, 2, 4), reps=20, cache=None, device="cuda",
                  seed=0, on_trial=None):
    """Sweep K4's plan knobs (``bn`` x ``waves``) for each (M, K, N) of
    ``shapes`` through ``autotune()`` on the card (a key already in the
    autotune cache is a hit: no trial runs). The weights are synthetic
    (seeded), quantized as ``kind`` ("int8" / "int4"), the activations
    ``dtype``. The winner at M stands for M's class
    (``quant_matmul.m_class``): give one M a class, since the last one
    swept wins its entry. Writes
    ``cache["wo_gemm"][kind]["mc{class}_k{K}_n{N}_{dtype}"] = {"bn",
    "waves", "m", "card"}`` (``m`` the M timed) into a serve cache (a new
    one when None) and returns it. ``on_trial(shape, (bn, waves), out,
    (x, w, scales, block_n, kind))``, when given, sees each candidate's
    first output and its inputs (the card's smoke holds each against the
    plain version)."""
    from . import quant_matmul as qm
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("sweep_wo_gemm: the plan knobs exist on the card "
                         f"only, got device {device}")
    card = card_of(device)
    tdt = _torch_dtype(dtype)
    rng = np.random.default_rng(seed)
    if cache is None:
        cache = {"schema": SERVE_SCHEMA, "kernel": _SERVE_KERNEL,
                 "shapes": {}}
    table = cache.setdefault("wo_gemm", {}).setdefault(kind, {})
    cands = [(int(b), int(w)) for b in bns for w in waves]
    for m, k, n in shapes:
        w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
        block_n = qm.kernel_block_n(n) if kind == "int4" \
            else qm.pick_block_n(n, "int8")
        if kind == "int4":
            pk, sc = qm.pack_int4_blocked(w, block_n)
        else:
            sc = (np.abs(w).max(0) / 127.0).astype(np.float32)
            pk = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
        wt = torch.as_tensor(pk).to(device)
        st = torch.as_tensor(sc).to(device)
        x = torch.as_tensor(rng.standard_normal((m, k), dtype=np.float32)
                            ).to(tdt).to(device)
        seen = set()

        def run(cand):
            out = qm.weight_only_matmul(x, wt, st, quant=kind,
                                        block_n=block_n, bn=cand[0],
                                        waves=cand[1])
            if on_trial is not None and cand not in seen:
                seen.add(cand)
                on_trial((m, k, n), cand, out, (x, wt, st, block_n, kind))
            return out
        bn, wv = autotune(wo_gemm_key(kind, m, k, n, dtype), cands, run,
                          reps=reps)
        table[_wo_entry(m, k, n, dtype)] = {
            "bn": int(bn), "waves": int(wv), "m": int(m), "card": card}
    return cache


def wo_gemm_plans(cache, kind, dtype):
    """{(M class, K, N): (bn, waves)} of a loaded serve cache's
    ``wo_gemm`` table for ``kind`` / ``dtype`` (empty when it has none):
    what a quantized engine closes into its GEMM calls at construction
    and looks up by ``quant_matmul.m_class`` of each call's M."""
    suffix = f"_{_dtype_name(dtype)}"
    out = {}
    for key, e in ((cache or {}).get("wo_gemm", {}).get(kind) or {}).items():
        if not key.endswith(suffix):
            continue
        m, k, n = (int(p.lstrip("mckn")) for p in
                   key[:-len(suffix)].split("_"))
        out[(m, k, n)] = (int(e["bn"]), int(e["waves"]))
    return out


# -- the saved serve cache -------------------------------------------------

def _valid_winner(w):
    return (isinstance(w, dict)
            and all(isinstance(w.get(k), int) and not isinstance(w[k], bool)
                    and w[k] >= 1 for k in TUNABLES))


def _valid_wo(key, e):
    """A ``wo_gemm`` entry with its knobs in range under a key of an M
    class (an earlier key by exact M is stale)."""
    from .quant_matmul import m_class
    parts = str(key).split("_")
    if len(parts) != 4 or not all(
            p[:len(t)] == t and p[len(t):].isdigit()
            for p, t in zip(parts, ("mc", "k", "n"))) \
            or m_class(int(parts[0][2:])) != int(parts[0][2:]):
        return False
    return (isinstance(e, dict) and e.get("bn") in (64, 128)
            and isinstance(e.get("waves"), int) and 1 <= e["waves"] <= 64)


def _measured_elsewhere(entry, card):
    """A measured entry from another card (or a card, read on the CPU)."""
    return bool(entry.get("measured", entry.get("card") is not None)) \
        and entry.get("card") != card


def load_serve_cache(path, card=None):
    """Read and validate a saved serve cache (a path, or a dict, which
    passes through). Returns the cache, or None when the file is missing
    or unparsable, the schema is not the port's (a JAX cache included),
    the structure is broken, or an entry was measured on another card
    than ``card`` (``card_of`` the engine's device; None on the CPU, where
    no measured entry applies): a bad cache leaves an engine at its
    defaults and never fails its constructor."""
    if isinstance(path, dict):
        cache = path
    else:
        try:
            with open(path) as f:
                cache = json.load(f)
        except Exception:
            return None
    if not isinstance(cache, dict) or cache.get("schema") != SERVE_SCHEMA:
        return None
    shapes = cache.get("shapes")
    if not isinstance(shapes, dict):
        return None
    for sec in shapes.values():
        if not isinstance(sec, dict) or not _valid_winner(sec.get("winner")):
            return None
        if not isinstance(sec.get("buckets"), dict):
            return None
        for b in sec["buckets"].values():
            if not _valid_winner(b) or _measured_elsewhere(b, card):
                return None
    wo = cache.get("wo_gemm", {})
    if not isinstance(wo, dict):
        return None
    for table in wo.values():
        if not isinstance(table, dict):
            return None
        for key, e in table.items():
            if not _valid_wo(key, e) or _measured_elsewhere(e, card):
                return None
    return cache


def save_serve_cache(cache, path):
    """Atomic, byte-stable (sorted keys, indented) write of a serve
    cache."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def serve_winner(cache, shape_class, bucket=None):
    """Winner lookup: the exact occupancy bucket when asked (and present),
    else the shape class's aggregate winner. Counts cache hits / misses,
    which move at engine construction only."""
    inst = _metrics()
    sec = (cache or {}).get("shapes", {}).get(shape_class)
    if sec is None:
        inst.autotune_cache_misses().inc()
        return None
    inst.autotune_cache_hits().inc()
    if bucket is not None:
        b = sec.get("buckets", {}).get(bucket)
        if b is not None:
            return dict(b)
    return dict(sec["winner"])


def serve_winner_for_engine(cache, kv_heads, group_q, head_dim, dtype):
    """Engine-constructor lookup while the paged block size is not known
    (it belongs to the scheduler): the first shape class, in sorted key
    order, matching (kv heads, group, head dim, dtype) at any block
    size."""
    if not cache:
        _metrics().autotune_cache_misses().inc()
        return None
    want_pre = f"kvh{int(kv_heads)}_g{int(group_q)}_bs"
    want_suf = f"_d{int(head_dim)}_{_dtype_name(dtype)}"
    for key in sorted(cache.get("shapes", {})):
        if key.startswith(want_pre) and key.endswith(want_suf):
            return serve_winner(cache, key)
    _metrics().autotune_cache_misses().inc()
    return None
