"""Tensor-parallel serving layout of the PyTorch port (counterpart of
``paddle_tpu/inference/tp_layout.py``): which axis of each serving
weight splits over the ranks of a ``torch.distributed`` group, and the
weight repacking that makes a contiguous split meaningful.

Megatron-style split, as in the JAX package:

  * QKV projection — COLUMN-parallel over attention heads: each rank
    computes `num_heads/tp` query heads and `kv_heads/tp` KV heads from
    the full hidden state. The paged KV cache splits over the SAME
    kv-head axis, so every rank appends into — and attends over —
    exactly the heads it projected: the ragged attention kernel runs
    unchanged on a `kv_heads/tp`-head local cache, and per-rank KV bytes
    drop by the TP factor.
  * attention out-projection — ROW-parallel: each rank contracts its
    local heads' context rows against its `[H*D/tp, E]` weight rows and
    the partial sums reduce with ONE all_reduce per layer.
  * FFN up (ffn1) — column-parallel; FFN down (ffn2) — row-parallel
    with the layer's second all_reduce.
  * embeddings / lm_head / norm scales and biases — replicated (the
    residual stream stays replicated, which is what keeps the scheduler
    on rank 0 alone: it broadcasts ONE slab and reads its own sampled
    tokens).

Packed layouts need ROW/COLUMN REORDERING before a contiguous split:

  * The GQA-packed qkv weight `[H + 2G, D, E]` lists q-heads, then
    k-heads, then v-heads. `repack_gqa_qkv` reorders rows so each rank's
    contiguous block is itself a valid GQA packing `[H/tp + 2G/tp, D, E]`.
  * A *glu ffn1 weight `[E, 2F]` pairs activation column j with gate
    column j+F. `repack_glu_ffn1` reorders columns so each rank's block
    is `[a_d | g_d]` — locally splittable, and its activation output
    lines up with ffn2's contiguous row shard.

Both repacks are pure permutations (`unpack_*` inverts them exactly).
The repack functions are numpy copies of the JAX package's; the catalog
names an axis (an int, or None for replicated) where the JAX package
names a PartitionSpec.
"""
import numpy as np
import torch

__all__ = ["SPLIT_AXIS", "validate_tp", "repack_gqa_qkv",
           "unpack_gqa_qkv", "repack_glu_ffn1", "shard_serving_weights",
           "serving_weight_specs"]


# The split axis of each weight family over the tp ranks. Keys absent
# here are replicated (every rank holds them whole): embeddings, lm_head,
# norm scales and biases, the out-projection's and ffn2's biases (added
# AFTER the all_reduce) and their per-output-channel ``*_wscales`` (a
# scale of a row split spans the whole K). The qkv axes are those of the
# GQA packing [H+2G, D, E] (rows, after repack_gqa_qkv); the MHA layout
# [3, H, D, E] splits its head axis, one further in. ffn1 splits its last
# axis (repacked for *glu), so the [1, F'] scales and the [F'] bias split
# alike. The paged KV cache [2, KVH, NB, BS, D] splits its kv-head axis:
# each rank builds it with KVH/tp heads.
SPLIT_AXIS = {"qkv_weights": 0, "qkv_wscales": 0, "qkv_biases": 0,
              "linear_weights": 0,
              "ffn1_weights": -1, "ffn1_wscales": -1, "ffn1_biases": -1,
              "ffn2_weights": 0}


def validate_tp(num_heads, kv_heads, dim_feedforward, tp):
    """The divisibility contract a head-sharded serving engine needs;
    raises with the exact failing axis so misconfiguration is a
    constructor error, not a mid-step reshape explosion."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    for what, n in (("num_heads", num_heads), ("kv_heads", kv_heads),
                    ("dim_feedforward", dim_feedforward)):
        if n % tp != 0:
            raise ValueError(
                f"tensor-parallel serving needs {what} ({n}) divisible "
                f"by tp ({tp}) — each device owns {what}/tp of them")
    return tp


def _gqa_row_order(num_q, num_kv, tp):
    """Row permutation for the [H+2G, D, E] packing: per-rank blocks
    [q_d | k_d | v_d] so a contiguous axis-0 split is a valid local
    GQA packing."""
    hq, hk = num_q // tp, num_kv // tp
    order = []
    for d in range(tp):
        order.extend(range(d * hq, (d + 1) * hq))                 # q rows
        order.extend(range(num_q + d * hk, num_q + (d + 1) * hk))  # k rows
        order.extend(range(num_q + num_kv + d * hk,                # v rows
                           num_q + num_kv + (d + 1) * hk))
    return np.asarray(order)


def repack_gqa_qkv(w, num_q, num_kv, tp):
    """Reorder a GQA-packed qkv weight [H+2G, D, E] (or bias [H+2G, D])
    so each of tp contiguous row blocks is itself GQA-packed over the
    rank's local heads."""
    order = _gqa_row_order(num_q, num_kv, tp)
    return np.asarray(w)[order]


def unpack_gqa_qkv(w, num_q, num_kv, tp):
    """Inverse permutation of repack_gqa_qkv (tests pin the round
    trip)."""
    order = _gqa_row_order(num_q, num_kv, tp)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return np.asarray(w)[inv]


def _glu_col_order(two_f, tp):
    f = two_f // 2
    fl = f // tp
    order = []
    for d in range(tp):
        order.extend(range(d * fl, (d + 1) * fl))          # a-columns
        order.extend(range(f + d * fl, f + (d + 1) * fl))  # g-columns
    return np.asarray(order)


def repack_glu_ffn1(w, tp, axis=-1):
    """Reorder a *glu ffn1 weight's [E, 2F] columns (or bias [2F]) into
    per-rank [a_d | g_d] blocks: the local `chunk(2, dim=-1)` then pairs
    activation column j with ITS gate column, and the local activation
    output is ffn2's contiguous row shard in order."""
    w = np.asarray(w)
    order = _glu_col_order(w.shape[axis], tp)
    return np.take(w, order, axis=axis)


def serving_weight_specs(weights):
    """The split axis (or None) of every entry of a
    FusedMultiTransformerEngine weight dict from ``SPLIT_AXIS``,
    MIRRORING it (same keys, lists stay lists). `weights` may hold
    arrays, tensors or shapes; only the key set, list lengths and the qkv
    rank matter (rank 4 is the MHA layout)."""
    sample = weights["qkv_weights"][0]
    mha = len(getattr(sample, "shape", np.shape(sample))) == 4
    specs = {}
    for k, v in weights.items():
        axis = SPLIT_AXIS.get(k)
        if mha and k.startswith("qkv_"):
            axis += 1
        specs[k] = [axis] * len(v) if isinstance(v, (list, tuple)) \
            else axis
    return specs


def _take(a, order, axis):
    """numpy take / torch index_select of `order` along `axis`."""
    if isinstance(a, torch.Tensor):
        idx = torch.as_tensor(order, dtype=torch.long, device=a.device)
        return torch.index_select(a, axis % a.dim(), idx)
    return np.take(np.asarray(a), order, axis=axis)


def _split(a, axis, rank, tp):
    """Rank `rank`'s contiguous 1/tp slice of `a` along `axis`."""
    n = a.shape[axis]
    if n % tp:
        raise ValueError(f"axis {axis} of length {n} does not split over "
                         f"tp={tp}")
    step = n // tp
    if isinstance(a, torch.Tensor):
        return a.narrow(axis % a.dim(), rank * step, step)
    return np.take(np.asarray(a), np.arange(rank * step, (rank + 1) * step),
                   axis=axis)


def shard_serving_weights(weights, rank, num_q, num_kv, glu, tp,
                          device=None):
    """This rank's shard of a FusedMultiTransformerEngine weight dict
    (numpy arrays or torch tensors, lists stay lists): GQA qkv rows and
    *glu ffn1 columns repacked (with their biases and ``*_wscales``),
    each entry split along its catalog axis, every shard a contiguous
    torch tensor on `device` (None keeps each where it is; numpy lands
    on the CPU). Returns (shards, specs)."""
    specs = serving_weight_specs(weights)
    sample = weights["qkv_weights"][0]
    gqa_packed = len(sample.shape) == 3
    tp = int(tp)
    rank = int(rank)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside [0, {tp})")

    def one(key, a, axis):
        if tp > 1 and gqa_packed and key in ("qkv_weights", "qkv_biases",
                                             "qkv_wscales"):
            a = _take(a, _gqa_row_order(num_q, num_kv, tp), 0)
        elif tp > 1 and glu and key in ("ffn1_weights", "ffn1_biases",
                                        "ffn1_wscales"):
            a = _take(a, _glu_col_order(a.shape[-1], tp), -1)
        if axis is not None and tp > 1:
            a = _split(a, axis, rank, tp)
        t = a if isinstance(a, torch.Tensor) \
            else torch.as_tensor(np.ascontiguousarray(a))
        if device is not None:
            t = t.to(device)
        return t.contiguous()

    shards = {}
    for k, v in weights.items():
        if isinstance(v, (list, tuple)):
            shards[k] = [one(k, a, s) for a, s in zip(v, specs[k])]
        else:
            shards[k] = one(k, v, specs[k])
    return shards, specs
