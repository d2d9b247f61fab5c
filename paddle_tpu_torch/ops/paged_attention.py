"""Paged KV-cache attention for the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``).

Host part, copied as is from the JAX module: ``next_pow2``,
``build_ragged_work``, ``RaggedWorkBuilder`` and ``default_pack``. Their
nine int32 arrays are identical to the JAX package's; the serving engine
keys its step buckets on the padded length and reads its host counters
from the builder.

Device part:

* the cache ops ``update_paged_kv_cache``, ``update_paged_kv_cache_chunk``,
  ``truncate_paged_kv_cache`` and ``copy_paged_kv_block``. The JAX
  versions are XLA scatters with ``mode="drop"``; torch has no dropping
  scatter and an out-of-range index faults, so the write set is filtered
  on the host (``paged_write_index``: a write whose position falls at or
  past the table capacity, past its row's valid count, or into a block id
  outside ``[0, NB)`` is dropped) and the surviving rows are copied into
  the cache IN PLACE. Each op returns the same cache tensors it was given.
* ``ragged_paged_attention``: the CUDA kernel
  (``csrc/ragged_paged_attention.cu``) for a CUDA tensor, with the launch
  plan of ``ragged_plan`` (page splits, row tiles, route, workspace; from
  shapes alone), the plain ``ragged_paged_attention_plain`` for a CPU
  tensor. ``ragged_split_plain`` is the kernel's split-and-combine
  arithmetic in plain PyTorch. The kernel walks the block tables
  directly; the work list keeps its host role.
* ``paged_attention``: the legacy one-token decode attention behind
  ``block_multihead_attention``, the CUDA kernel
  (``csrc/paged_decode_attention.cu``) for a CUDA tensor, with the plan
  of ``decode_plan`` (page splits and workspace, from shapes alone; the
  split rule ``split_pages`` is the ragged kernel's), and the plain
  ``paged_attention_plain`` for a CPU tensor.
  ``paged_attention_split_plain`` is the kernel's split-and-combine
  arithmetic in plain PyTorch.
"""
import ctypes
import functools
import math
import threading

import numpy as np
import torch

from . import work as _work

NEG_INF = -1e30
LOG2E = 1.4426950408889634

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# host part: the ragged work list (copied from the JAX package)
# ---------------------------------------------------------------------------

def next_pow2(n):
    """Work-list bucketing for serving: compile one program per power of
    two instead of one per distinct total block count."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def build_ragged_work(block_tables, context_lens, block_size, pack,
                      bucket_to=None, q_lens=None):
    """Flatten (sequence, block) pairs into the ragged kernel's work list.

    Host-side on purpose: the block tables live on the host in the serving
    allocator, and the list length must be static under jit. Entries are
    group-major (all blocks of the `pack` co-scheduled sequences of group
    0, then group 1, ...) so the kernel's accumulators live across exactly
    one contiguous span per group.

    Each entry carries its sequence's QUERY SPAN (q_start, q_len): the
    chunk of trailing context positions that act as queries this step.
    Decode is q_len == 1 (the default when `q_lens` is omitted: span =
    the last token); chunked prefill passes `q_lens` [B] with up to
    `chunk` new tokens per sequence. `context_lens` always counts the
    TOTAL context including the span, so q_start = len - q_len. A
    sequence whose q_len is 0 is skipped outright — zero work entries,
    zero grid steps (its output rows are masked off by the caller).

    Returns (arrays, t_real, t_total, pack): nine int32 [t_total] arrays
    (seq id, group id, row-in-group, cache block id, block position,
    group-first flag, group-last flag, query start, query len), the
    number of real entries, the padded length (== t_real unless
    bucket_to is given), and the (clamped) pack factor the list was
    built with — the kernel's query packing MUST use the same pack, so
    pass this whole tuple as `ragged_paged_attention(..., work=...)` and
    it travels together. Padding entries point their block position past
    every valid token (and carry q_len 0) so the kernel masks them to a
    no-op.

    A length past the table capacity (max_blocks * block_size) walks only
    the blocks that exist: this pairs with `update_paged_kv_cache`
    dropping the write a full row has no slot for — the row attends over
    its capacity tokens instead of indexing past its table row.
    """
    tables = np.asarray(block_tables)
    lens = np.asarray(context_lens)
    b = lens.shape[0]
    pack = max(1, min(int(pack), b))
    max_nb = tables.shape[1]
    if q_lens is None:
        ql_arr = np.ones(b, np.int64)
    else:
        ql_arr = np.asarray(q_lens).astype(np.int64).reshape(-1)
        if ql_arr.shape[0] != b:
            raise ValueError(
                f"q_lens must be shape [{b}], got {ql_arr.shape}")
    ws, wg, wr, wblk, wpos, wfirst, wlast, wqs, wql = (
        [] for _ in range(9))
    for grp in range(-(-b // pack)):
        start_t = len(ws)
        for s in range(grp * pack, min((grp + 1) * pack, b)):
            if q_lens is not None and ql_arr[s] <= 0:
                continue    # no queries this step: costs zero grid steps
            q_len = int(ql_arr[s])
            q_start = max(int(lens[s]) - q_len, 0)
            for j in range(min(-(-int(lens[s]) // block_size), max_nb)):
                ws.append(s)
                wg.append(grp)
                wr.append(s % pack)
                wblk.append(int(tables[s, j]))
                wpos.append(j)
                wfirst.append(0)
                wlast.append(0)
                wqs.append(q_start)
                wql.append(q_len)
        if len(ws) > start_t:
            wfirst[start_t] = 1
            wlast[-1] = 1
    t_real = len(ws)
    t_total = t_real
    if bucket_to is not None and t_real > 0:
        t_total = max(t_real, int(bucket_to(t_real)))
        last_grp = wg[-1]
        # sentinel block position far past any representable cache length
        # (NOT max_nb: an over-capacity len could still reach past that),
        # int32-safe in the kernel's pos = wpos*block_size + iota
        pad_pos = (1 << 30) // block_size
        for _ in range(t_total - t_real):
            ws.append(0)
            wg.append(last_grp)  # same q/out block: no pipeline flush
            wr.append(0)
            wblk.append(0)
            wpos.append(pad_pos)  # position >= every len: fully masked
            wfirst.append(0)
            wlast.append(0)
            wqs.append(0)
            wql.append(0)        # zero-length span: every row masked
    arrs = tuple(np.asarray(a, np.int32)
                 for a in (ws, wg, wr, wblk, wpos, wfirst, wlast, wqs, wql))
    return arrs, t_real, t_total, pack


class RaggedWorkBuilder:
    """Incremental `build_ragged_work`: same nine arrays, same padding,
    same bucket math — assembled into persistent per-bucket buffers
    instead of per-step Python lists.

    The serving invariant this exploits: a steady-state decode slot's
    (seq, block) entries are STRUCTURALLY constant step to step — its
    seq/group/row/position columns never change, and its block-id column
    only changes when the allocator touches the slot's table row
    (admit, grow, COW, rewind, preempt, retire). The engine marks
    exactly those sites dirty; everything else reuses the segment
    already sitting in the buffer. Only the per-entry query span
    (q_start, q_len) is refreshed every step — q_start advances with
    every committed token, so it can never be cached — as one scalar
    slice-fill per active slot.

    Two assembly modes, chosen per step:
      * incremental — the per-slot segment layout AND the padded bucket
        match the previous step: only dirtied slots' block columns are
        rewritten (at unchanged offsets), flags and padding stand.
      * full — layout or bucket changed: every active slot's segment is
        re-laid out (vectorized row-slice copies, still no Python entry
        lists), flags recomputed, the pad tail refreshed.

    Counters (`segments_reused` / `segments_rebuilt` / `assemblies_*`)
    count ACTIVE slots only, so a steady-state decode step scores 100%
    reuse — the number `serve_bench --host` pins.

    The returned arrays are views of the persistent bucket buffer that
    the NEXT build mutates. The port's CUDA kernel walks the block
    tables, so no step uploads these arrays; a caller that does must copy
    them before the next build."""

    def __init__(self, batch, max_blocks, block_size, pack,
                 bucket_to=next_pow2):
        self.batch = int(batch)
        self.max_blocks = int(max_blocks)
        self.block_size = int(block_size)
        self.pack = max(1, min(int(pack), self.batch))
        self.bucket_to = bucket_to
        b = self.batch
        # per-slot cached state: block-column validity (dirty flag) and
        # the segment length the buffer currently holds for the slot
        self._dirty = np.ones(b, bool)      # nothing cached yet
        self._seg_n = np.full(b, -1, np.int64)
        # scratch (size-b host math, reused every step)
        self._ncov = np.zeros(b, np.int64)
        self._seglen = np.zeros(b, np.int64)
        self._off = np.zeros(b + 1, np.int64)
        self._arange = np.arange(self.max_blocks, dtype=np.int32)
        self._pad_pos = (1 << 30) // self.block_size
        # bucket buffers: t_total -> (nine arrays, state dict). `state`
        # remembers the layout the buffer holds so a return to the same
        # bucket after a detour still re-lays out correctly.
        self._bufs = {}
        self._last_total = None     # bucket used by the previous build
        self._empty = tuple(np.zeros(0, np.int32) for _ in range(9))
        # counters — monotonic, read by the engine's host_stats
        self.segments_reused = 0
        self.segments_rebuilt = 0
        self.assemblies_full = 0
        self.assemblies_incremental = 0

    def mark_dirty(self, slot):
        """Invalidate slot's cached block column. Call from every site
        that writes the slot's block-table row."""
        self._dirty[slot] = True

    def mark_all_dirty(self):
        self._dirty[:] = True

    def _bucket_buf(self, t_total):
        ent = self._bufs.get(t_total)
        if ent is None:
            arrs = [np.zeros(t_total, np.int32) for _ in range(9)]
            arrs[4][:] = self._pad_pos     # wpos: fully-masked sentinel
            ent = (tuple(arrs), {"seglen": None, "t_real": 0,
                                 "last_grp": -1})
            self._bufs[t_total] = ent
        return ent

    def build(self, block_tables, context_lens, q_lens):
        """Drop-in for `build_ragged_work(tables, lens, block_size,
        pack, bucket_to=..., q_lens=...)` over the persistent engine
        arrays. `context_lens` counts the TOTAL span (len + q) exactly
        like the from-scratch builder."""
        b = self.batch
        bs = self.block_size
        ql = q_lens
        # n_cov per slot: blocks the attention span touches, clipped to
        # the table width (over-capacity lens walk only real blocks)
        np.floor_divide(
            np.asarray(context_lens, np.int64) + (bs - 1), bs,
            out=self._ncov)
        np.minimum(self._ncov, self.max_blocks, out=self._ncov)
        np.multiply(self._ncov, ql > 0, out=self._seglen)
        np.cumsum(self._seglen, out=self._off[1:])
        t_real = int(self._off[b])
        if t_real == 0:
            # no work entries at all (every active slot budget-starved):
            # the from-scratch builder skips bucketing and returns nine
            # empty arrays — reproduce that, and force a full re-layout
            # on the next nonempty step
            self._last_total = None
            return self._empty, 0, 0, self.pack
        t_total = t_real
        if self.bucket_to is not None:
            t_total = max(t_real, int(self.bucket_to(t_real)))
        arrs, state = self._bucket_buf(t_total)
        ws, wg, wr, wblk, wpos, wfirst, wlast, wqs, wql = arrs
        # incremental only when this very buffer was written by the
        # PREVIOUS build (dirty flags are global, not per-bucket: after
        # a detour through another bucket they no longer describe this
        # buffer's staleness) and the slot layout is unchanged
        incremental = (
            t_total == self._last_total
            and state["seglen"] is not None
            and np.array_equal(state["seglen"], self._seglen))
        reused = rebuilt = 0
        active = np.nonzero(self._seglen)[0]
        for s in active:
            off = int(self._off[s])
            n = int(self._seglen[s])
            fresh = bool(self._dirty[s]) or int(self._seg_n[s]) != n
            if fresh:
                rebuilt += 1
            else:
                reused += 1
            if not incremental or fresh:
                end = off + n
                if not incremental:
                    ws[off:end] = s
                    wg[off:end] = s // self.pack
                    wr[off:end] = s % self.pack
                    wpos[off:end] = self._arange[:n]
                wblk[off:end] = block_tables[s, :n]
                self._seg_n[s] = n
                self._dirty[s] = False
            # the query span changes every step a token commits: always
            # refreshed, never part of the cached segment
            q = int(ql[s])
            wqs[off:off + n] = max(int(context_lens[s]) - q, 0)
            wql[off:off + n] = q
        if not incremental:
            # group flags: one first/last pair per nonempty group, over
            # the contiguous span its packed slots occupy
            wfirst[:t_real] = 0
            wlast[:t_real] = 0
            for g in range(-(-b // self.pack)):
                lo = int(self._off[g * self.pack])
                hi = int(self._off[min((g + 1) * self.pack, b)])
                if hi > lo:
                    wfirst[lo] = 1
                    wlast[hi - 1] = 1
            # pad maintenance: entries the previous layout filled past
            # this one's t_real revert to the masked sentinel, and the
            # pad tail's group id tracks the last REAL group (same
            # q/out block: no pipeline flush)
            old_real = state["t_real"]
            if t_real < old_real:
                ws[t_real:old_real] = 0
                wr[t_real:old_real] = 0
                wblk[t_real:old_real] = 0
                wpos[t_real:old_real] = self._pad_pos
                wfirst[t_real:old_real] = 0
                wlast[t_real:old_real] = 0
                wqs[t_real:old_real] = 0
                wql[t_real:old_real] = 0
            last_grp = int(wg[t_real - 1])
            if t_real != old_real or last_grp != state["last_grp"]:
                wg[t_real:t_total] = last_grp
            state["t_real"] = t_real
            state["last_grp"] = last_grp
            if state["seglen"] is None:
                state["seglen"] = self._seglen.copy()
            else:
                np.copyto(state["seglen"], self._seglen)
            self.assemblies_full += 1
        else:
            self.assemblies_incremental += 1
        self.segments_reused += reused
        self.segments_rebuilt += rebuilt
        self._last_total = t_total
        return arrs, t_real, t_total, self.pack


def default_pack(batch, group_q):
    """Co-schedule enough sequences that the packed query tile fills at
    least one f32 sublane tile (8 rows) — the MXU minimum."""
    return max(1, min(batch, -(-8 // group_q)))


# ---------------------------------------------------------------------------
# device part: cache ops (in place, writes filtered on the host)
# ---------------------------------------------------------------------------

def _host_array(a, dtype=np.int64):
    """numpy view of a host array, a python scalar or a tensor (a device
    tensor is copied to the host, which waits for the device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(dtype, copy=False)


def paged_write_index(block_tables, context_lens, valid_counts, chunk,
                      num_blocks, block_size):
    """Host-side write set of a chunk append: sequence b's row j lands at
    position context_lens[b] + j for j < valid_counts[b].

    Returns (src, dst) int64 numpy arrays: ``src`` indexes the flattened
    [B * chunk] rows of the new K/V, ``dst`` the flattened
    [num_blocks * block_size] slots of one kv head's cache. Rows past
    their valid count, at or past the table capacity, or whose block id
    falls outside [0, num_blocks) are dropped (the JAX scatter's
    ``mode="drop"``); the table read itself is clamped to the row."""
    tables = _host_array(block_tables)
    lens = _host_array(context_lens).reshape(-1)
    counts = _host_array(valid_counts).reshape(-1)
    max_nb = tables.shape[1]
    j = np.arange(int(chunk))[None, :]
    pos = lens[:, None] + j                                       # [B, C]
    valid = (j < counts[:, None]) & (pos < max_nb * block_size)
    blk_col = np.minimum(pos // block_size, max_nb - 1)
    blk = np.take_along_axis(tables, blk_col, axis=1)
    valid &= (blk >= 0) & (blk < num_blocks)
    src = np.flatnonzero(valid)
    dst = (blk * block_size + pos % block_size).reshape(-1)[src]
    return src, dst


def write_paged_kv(cache, new, src, dst):
    """Copy rows ``src`` of ``new`` ([B, C, KVH, D]) into slots ``dst`` of
    ``cache`` ([KVH, NB, BS, D]) in place. ``src``/``dst`` are long tensors
    on the cache's device (``paged_write_index``). Slots are distinct per
    (sequence, position), so the writes never collide."""
    kvh, nb, bs, d = cache.shape
    if src.numel() == 0:
        return cache
    rows = new.reshape(-1, kvh, d).index_select(0, src)           # [n, KVH, D]
    cache.view(kvh, nb * bs, d).index_copy_(
        1, dst, rows.transpose(0, 1).to(cache.dtype))
    return cache


def _index_tensors(src, dst, device):
    return (_on_device(src, device, torch.long),
            _on_device(dst, device, torch.long))


def update_paged_kv_cache(k_cache, v_cache, k_new, v_new, block_tables,
                          context_lens):
    """Append one decode step's K/V ([B, KVH, D]) into the paged caches at
    position context_lens (the slot the new token occupies), in place.
    A row whose context_lens already equals the table capacity
    (max_blocks * block_size) has nowhere to append: its write is
    dropped. Returns (k_cache, v_cache)."""
    kvh, nb, bs, _ = k_cache.shape
    b = k_new.shape[0]
    src, dst = _index_tensors(*paged_write_index(
        block_tables, context_lens, np.ones(b, np.int64), 1, nb, bs),
        k_cache.device)
    write_paged_kv(k_cache, k_new[:, None], src, dst)
    write_paged_kv(v_cache, v_new[:, None], src, dst)
    return k_cache, v_cache


def update_paged_kv_cache_chunk(k_cache, v_cache, k_new, v_new,
                                block_tables, context_lens, valid_counts):
    """Append a CHUNK of new K/V rows ([B, C, KVH, D]) into the paged
    caches in place: sequence b's row j lands at position
    context_lens[b] + j for j < valid_counts[b]; the chunk may span block
    boundaries. Rows past valid_counts[b] and rows at or past the table
    capacity are dropped. Returns (k_cache, v_cache)."""
    kvh, nb, bs, _ = k_cache.shape
    src, dst = _index_tensors(*paged_write_index(
        block_tables, context_lens, valid_counts, k_new.shape[1], nb, bs),
        k_cache.device)
    write_paged_kv(k_cache, k_new, src, dst)
    write_paged_kv(v_cache, v_new, src, dst)
    return k_cache, v_cache


def truncate_index(block_tables, new_lens, old_lens, max_span, num_blocks,
                   block_size):
    """Host-side slot set of a rewind: flat slots of positions
    new_lens[b] .. old_lens[b]-1 (at most ``max_span`` per row), dropping
    positions past old_lens, at or past the table capacity, or in a block
    id outside [0, num_blocks)."""
    new = _host_array(new_lens).reshape(-1)
    old = _host_array(old_lens).reshape(-1)
    counts = np.clip(old - new, 0, int(max_span))
    _, dst = paged_write_index(block_tables, new, counts, int(max_span),
                               num_blocks, block_size)
    return dst


def truncate_paged_kv_cache(k_cache, v_cache, block_tables, new_lens,
                            old_lens, max_span):
    """Rewind a paged cache in place: ZERO positions new_lens[b] ..
    old_lens[b]-1 of every sequence (the KV a rejected speculative draft
    span left behind), so a speculated-then-rewound cache is
    bit-identical to one that never speculated. ``max_span`` bounds
    old_lens - new_lens. Returns (k_cache, v_cache)."""
    kvh, nb, bs, d = k_cache.shape
    dst = truncate_index(block_tables, new_lens, old_lens, max_span, nb, bs)
    if dst.size:
        idx = _on_device(dst, k_cache.device, torch.long)
        k_cache.view(kvh, nb * bs, d).index_fill_(1, idx, 0)
        v_cache.view(kvh, nb * bs, d).index_fill_(1, idx, 0)
    return k_cache, v_cache


def copy_paged_kv_block(k_cache, v_cache, src_block, dst_block):
    """Duplicate ONE physical cache block in place: every (kv_head, slot,
    d) row of ``src_block`` into ``dst_block``, the device half of the
    serving engine's copy-on-write. Block ids are host data: the source is
    clamped into the pool and an out-of-pool destination drops the copy.
    Returns (k_cache, v_cache)."""
    nb = k_cache.shape[1]
    src = min(max(int(src_block), 0), nb - 1)
    dst = int(dst_block)
    if 0 <= dst < nb and dst != src:
        k_cache[:, dst].copy_(k_cache[:, src])
        v_cache[:, dst].copy_(v_cache[:, src])
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# ragged paged attention: plain PyTorch version and the CUDA kernel
# ---------------------------------------------------------------------------

def _on_device(a, device, dtype):
    """A host array or tensor as a contiguous `dtype` tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def ragged_paged_attention_plain(q, k_cache, v_cache, block_tables,
                                 context_lens, scale=None, q_lens=None):
    """Dense masked PyTorch version of the ragged algorithm, on any
    device. Each sequence's table blocks are gathered into one dense
    [KVH, MAXNB*BS, D] span and attended with the kernel's mask: key
    position pos is visible to query position j when pos lies in the
    first min(ceil(len/BS), MAXNB) blocks, j < q_len and
    pos <= q_start + j (q_start = max(len - q_len, 0)). Softmax in f32
    with NEG_INF = -1e30 and a zero denominator read as one; rows with no
    query (j >= q_len, len 0) are zero. Shapes as in
    ``ragged_paged_attention``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, c, h, d = q.shape
    kvh, nb, bs, _ = k_cache.shape
    g = h // kvh
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tables = _on_device(block_tables, dev, torch.long).clamp(0, nb - 1)
    max_nb = tables.shape[1]
    lens = _on_device(context_lens, dev, torch.long).reshape(-1)
    ql = torch.ones_like(lens) if q_lens is None \
        else _on_device(q_lens, dev, torch.long).reshape(-1)
    qstart = (lens - ql).clamp(min=0)
    nblk = torch.where((lens > 0) & (ql > 0),
                       torch.clamp((lens + bs - 1) // bs, max=max_nb), 0)
    span = max_nb * bs
    kg = k_cache[:, tables].reshape(kvh, b, span, d).float()
    vg = v_cache[:, tables].reshape(kvh, b, span, d).float()
    pos = torch.arange(span, device=dev)
    j = torch.arange(c, device=dev)
    live = j[None, :] < ql[:, None]                               # [B, C]
    vis = ((pos[None, None, :] < (nblk * bs)[:, None, None])
           & (pos[None, None, :]
              <= (qstart[:, None] + j[None, :])[:, :, None])
           & live[:, :, None])                                    # [B, C, S]
    qf = q.float().reshape(b, c, kvh, g, d)
    s = torch.einsum("bcngd,nbsd->bcngs", qf, kg) * scale
    mask = vis[:, :, None, None, :]
    m = torch.where(mask, s, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bcngs,nbsd->bcngd", p, vg) / l
    o = torch.where((live & (lens[:, None] > 0))[:, :, None, None, None],
                    o, 0.0)
    out = o.reshape(b, c, h, d).to(q.dtype)
    return out[:, 0] if squeeze else out


ROW_TILE = 64           # query rows of a kernel tile (16 per warp on mma)
MMA_MIN_ROWS = 16       # live rows from which a 16-bit tile takes mma.sync
SPLIT_WAVES = 2         # a split grid covers the SMs at least this often
MAX_SPLITS = 32         # most splits of a plan (the kernel's combine)
PLAN_KEYS = ("route", "splits", "pages_per_split", "tiles", "blocks",
             "workspace_bytes")


def split_pages(unsplit, max_nb, sms):
    """(splits S, pages per split P) of a page walk of ``max_nb`` pages
    whose unsplit grid has ``unsplit`` blocks, on a card of ``sms`` SMs:
    one split (P = max_nb) when the unsplit grid already covers the SMs
    ``SPLIT_WAVES`` times; else P is the largest power of two that lets
    the grid reach that many waves, at least ceil(max_nb / MAX_SPLITS),
    and S = ceil(max_nb / P). The rule of both paged-attention plans."""
    max_nb = max(int(max_nb), 1)
    target = SPLIT_WAVES * int(sms)
    pps = max_nb
    if 0 < unsplit < target:
        fit = max(1, max_nb // -(-target // unsplit))
        pps = 1 << (fit.bit_length() - 1)
    pps = max(pps, -(-max_nb // MAX_SPLITS))
    return -(-max_nb // pps), pps


def ragged_plan(b, c, h, kvh, max_nb, bs, d, dtype=torch.bfloat16,
                sms=None):
    """The kernel's launch plan for q [B, C, H, D] against caches of block
    size ``bs`` and tables of ``max_nb`` columns, from shapes alone (never
    from the lengths on the device, so a CUDA graph could capture the
    call). ``sms`` is the card's SM count (default: the current card's).

    * ``tiles``: row tiles of 64 per (kv head, sequence): ceil(C*G / 64);
    * ``splits`` S and ``pages_per_split`` P: the page walk cut into S
      pieces of P pages by ``split_pages`` over the unsplit grid of
      B x KVH x tiles blocks (two waves, 32 splits at most);
    * ``blocks``: S x B x KVH x tiles;
    * ``workspace_bytes``: the f32 partials of a split plan, S x B x KVH x
      tiles x min(64, C*G) x (D + 2) x 4 (0 at one split);
    * ``route``: "mma" for bf16 / fp16 when a tile can hold 16 live rows
      (C*G >= 16): such a tile runs on the tensor cores and every other
      tile on the warp-shuffle route, each block choosing from its own
      q_len on the device; else "decode", every tile on the warp-shuffle
      route."""
    if sms is None:
        sms = _sms(torch.device("cuda", torch.cuda.current_device()))
    g = h // kvh
    span = c * g
    tiles = -(-span // ROW_TILE)
    unsplit = b * kvh * tiles
    splits, pps = split_pages(unsplit, max_nb, sms)
    route = "mma" if dtype in (torch.bfloat16, torch.float16) \
        and span >= MMA_MIN_ROWS else "decode"
    ws = splits * unsplit * min(ROW_TILE, span) * (d + 2) * 4 \
        if splits > 1 else 0
    return dict(zip(PLAN_KEYS, (route, splits, pps, tiles,
                                splits * unsplit, ws)))


def ragged_split_plain(q, k_cache, v_cache, block_tables, context_lens,
                       splits, pages_per_split, scale=None, q_lens=None):
    """The kernel's split-and-combine arithmetic in plain PyTorch, on any
    device: split s attends over pages [s*P, (s+1)*P) of each sequence's
    walk and leaves a partial (m, l, acc) per row, scores in log2 units
    (an empty split: m = -1e30, l = 0, acc = 0); the partials are then
    summed in split order 0 .. S-1 with weights 2^(m_s - max m), and
    acc / l (l == 0 read as one) is the output. Masks, clamps and dead
    rows as in ``ragged_paged_attention_plain``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, c, h, d = q.shape
    kvh, nb, bs, _ = k_cache.shape
    g = h // kvh
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tables = _on_device(block_tables, dev, torch.long).clamp(0, nb - 1)
    max_nb = tables.shape[1]
    lens = _on_device(context_lens, dev, torch.long).reshape(-1)
    ql = torch.ones_like(lens) if q_lens is None \
        else _on_device(q_lens, dev, torch.long).reshape(-1)
    qstart = (lens - ql).clamp(min=0)
    nblk = torch.where((lens > 0) & (ql > 0),
                       torch.clamp((lens + bs - 1) // bs, max=max_nb), 0)
    span = max_nb * bs
    kg = k_cache[:, tables].reshape(kvh, b, span, d).float()
    vg = v_cache[:, tables].reshape(kvh, b, span, d).float()
    pos = torch.arange(span, device=dev)
    j = torch.arange(c, device=dev)
    live = j[None, :] < ql[:, None]                               # [B, C]
    vis = ((pos[None, None, :] < (nblk * bs)[:, None, None])
           & (pos[None, None, :]
              <= (qstart[:, None] + j[None, :])[:, :, None])
           & live[:, :, None])                                    # [B, C, S]
    qf = q.float().reshape(b, c, kvh, g, d)
    s = torch.einsum("bcngd,nbsd->bcngs", qf, kg) * (scale * LOG2E)
    page = pos // bs
    parts = []
    for sp in range(int(splits)):
        inside = (page >= sp * pages_per_split) \
            & (page < (sp + 1) * pages_per_split)
        mask = (vis & inside)[:, :, None, None, :]
        m = torch.where(mask, s, NEG_INF).amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp2(s - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bcngs,nbsd->bcngd", p, vg)))
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                     # split order
        f = torch.exp2(m - big)
        l_sum = l_sum + l * f
        acc = acc + a * f
    o = acc / torch.where(l_sum == 0.0, 1.0, l_sum)
    o = torch.where((live & (lens[:, None] > 0))[:, :, None, None, None],
                    o, 0.0)
    out = o.reshape(b, c, h, d).to(q.dtype)
    return out[:, 0] if squeeze else out


def ragged_paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                           scale=None, q_lens=None):
    """Mixed decode/prefill attention over a paged KV cache.

    q:            [B, H, D] (one query per sequence) or [B, C, H, D] (a
                  chunk of up to C queries per sequence)
    k/v_cache:    [KVH, num_blocks, block_size, D]
    block_tables: [B, max_blocks_per_seq] int cache-block ids
    context_lens: [B] valid cache length per sequence INCLUDING this
                  call's query span (0 allowed: the row returns zeros)
    q_lens:       [B] valid query count per sequence ([B, C, H, D] mode;
                  None means one query per sequence). Sequence b's queries
                  sit at positions context_lens[b]-q_lens[b] ..
                  context_lens[b]-1, each causally masked to its prefix.
    returns       [B, H, D] or [B, C, H, D], matching q

    A CPU tensor runs ``ragged_paged_attention_plain``. A CUDA tensor
    launches the kernel of ``csrc/ragged_paged_attention.cu`` once, with
    the plan of ``ragged_plan`` (counted in
    ``ragged_paged_attention.launches``, the plan's route in
    ``ragged_paged_attention.route``), or raises. A split plan takes its
    f32 workspace from ``torch.empty`` and its counters from a zeroed
    buffer kept per card and stream, which the kernel leaves zeroed.
    Nothing here reads the lengths back to the host."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, block_tables, context_lens, scale=scale,
            q_lens=q_lens)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device "
                         f"{q.device}")
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    if q4.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"ragged_paged_attention: q {tuple(q.shape)} must be [B, H, D] "
            f"or [B, C, H, D] and k/v caches one [KVH, NB, BS, D] shape, got "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    b, c, h, d = q4.shape
    kvh, nb, bs, dk = k_cache.shape
    if dk != d or h % kvh:
        raise ValueError(f"ragged_paged_attention: head dim {d} vs cache "
                         f"{dk}, heads {h} vs kv heads {kvh}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"ragged_paged_attention: q/k/v dtypes {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype} must agree and "
                         "be float32, bfloat16 or float16")
    if d not in (32, 64, 128):
        raise ValueError(f"ragged_paged_attention: head dim {d} not in "
                         "(32, 64, 128)")
    for name, t in (("q", q4), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"ragged_paged_attention: {name} must be a "
                             f"contiguous 16-byte aligned tensor on "
                             f"{q.device}")
    tables = _on_device(block_tables, q.device, torch.int32)
    lens = _on_device(context_lens, q.device, torch.int32).reshape(-1)
    qls = None if q_lens is None \
        else _on_device(q_lens, q.device, torch.int32).reshape(-1)
    if tables.dim() != 2 or tables.shape[0] != b or lens.shape[0] != b \
            or (qls is not None and qls.shape[0] != b):
        raise ValueError("ragged_paged_attention: block_tables must be "
                         "[B, max_blocks] and context_lens/q_lens [B]")
    out = torch.empty_like(q4)
    if b == 0 or c == 0:
        return out[:, 0] if squeeze else out
    fn, max_bs = _launcher()
    if bs > max_bs:
        raise ValueError(f"ragged_paged_attention: block size {bs} too large")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    plan = ragged_plan(b, c, h, kvh, tables.shape[1], bs, d, q.dtype,
                       _sms(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32,
                         device=q.device)
        counters = _counters(q.device, stream,
                             plan["blocks"] // plan["splits"])
    rc = fn(_DTYPE_CODE[q.dtype], q4.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            None if qls is None else qls.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, c, h, kvh, nb, bs, tables.shape[1], d, plan["splits"],
            plan["pages_per_split"], float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    with _LAUNCH_LOCK:
        ragged_paged_attention.launches += 1
        ragged_paged_attention.route = plan["route"]
    if _work.counting():
        _work.note("ragged_paged_attention", *_work.ragged_attention(
            lens.cpu().numpy(), None if qls is None else qls.cpu().numpy(),
            c, tables.shape[1], bs, h, kvh, d, q.element_size(),
            tables.numel() * 4))
    return out[:, 0] if squeeze else out


ragged_paged_attention.launches = 0
ragged_paged_attention.route = None     # the last launch's plan route
# serving replicas step from threads of their own (serving/router.py): the
# count is a read-modify-write, so it is taken under a lock
_LAUNCH_LOCK = threading.Lock()

# (card, stream) -> zeroed int32 counters of split plans. Threads that
# launch on one stream (serving replicas on the card's default stream)
# share its buffer: launches on one stream run in order, so two never use
# the counters at once. A replica given a stream of its own gets its own.
_COUNTERS = {}


def _counters(device, stream, n):
    """At least ``n`` zeroed int32 counters on ``device`` for launches on
    ``stream``, kept between calls: every launch leaves the counters it
    used at zero, so they are zeroed once, when allocated (anew only for a
    larger grid), and launches on one stream never share them at once."""
    key = (device.index, stream)
    with _LAUNCH_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32,
                              device=device)
            _COUNTERS[key] = buf
    return buf


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _launcher():
    """(the kernel's C entry point with its prototype bound, the largest
    cache block size it takes), built and loaded on the first launch."""
    from . import _build
    lib = _build.load("ragged_paged_attention")
    fn = lib.ragged_paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    return fn, int(lib.ragged_paged_attention_max_block_size())


# ---------------------------------------------------------------------------
# legacy paged decode attention: plain PyTorch version and the CUDA kernel
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_cache, v_cache, block_tables, context_lens,
                          scale=None):
    """The Pallas decode kernel's body step by step in PyTorch, on any
    device. The [G, BS] scores of every (sequence, kv head, block-table
    column) are taken in f32 up front, positions at or past ctx set to
    NEG_INF; then, column by column, the running max, the running sum and
    acc = acc * corr + p @ v. A sequence skips the columns with
    i * BS >= ctx (its state stands), so a row with ctx 0 keeps l = 0,
    read as 1, and returns zeros. Block ids are clamped into [0, NB).
    Shapes as in ``paged_attention``."""
    b, h, d = q.shape
    kvh, nb, bs, _ = k_cache.shape
    g = h // kvh
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tables = _on_device(block_tables, dev, torch.long).clamp(0, nb - 1)
    lens = _on_device(context_lens, dev, torch.long).reshape(-1)
    ncol = tables.shape[1]
    qf = q.float().reshape(b, kvh, g, d)
    k = k_cache[:, tables].float()                  # [KVH, B, NC, BS, D]
    v = v_cache[:, tables].float()
    s = torch.einsum("bngd,nbcsd->bngcs", qf, k) * scale
    pos = torch.arange(ncol * bs, device=dev).reshape(ncol, bs)
    s = torch.where((pos[None] < lens[:, None, None])[:, None, None], s,
                    NEG_INF)
    m = torch.full((b, kvh, g, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kvh, g, 1), device=dev)
    acc = torch.zeros((b, kvh, g, d), device=dev)
    for i in range(ncol):
        si = s[:, :, :, i]
        m_new = torch.maximum(m, si.amax(-1, keepdim=True))
        p = torch.exp(si - m_new)
        corr = torch.exp(m - m_new)
        live = (i * bs < lens)[:, None, None, None]
        l = torch.where(live, corr * l + p.sum(-1, keepdim=True), l)
        acc = torch.where(live, acc * corr + torch.einsum(
            "bngs,nbsd->bngd", p, v[:, :, i]), acc)
        m = torch.where(live, m_new, m)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(b, h, d).to(q.dtype)


DECODE_PLAN_KEYS = ("splits", "pages_per_split", "blocks", "workspace_bytes")


def decode_plan(b, h, kvh, max_nb, bs, d, dtype=torch.bfloat16, sms=None):
    """The decode kernel's launch plan for q [B, H, D] against caches of
    block size ``bs`` and tables of ``max_nb`` columns, from shapes alone
    (never from the lengths on the device, so a CUDA graph could capture
    the call). ``sms`` is the card's SM count (default: the current
    card's).

    * ``splits`` S and ``pages_per_split`` P: ``split_pages`` over the
      unsplit grid of B x KVH blocks, the ragged kernel's rule (B=8,
      KVH=8, 32 pages: 8 splits of 4 pages);
    * ``blocks``: S x B x KVH;
    * ``workspace_bytes``: the f32 partials of a split plan,
      S x B x H x (D + 2) x 4 (0 at one split).

    The block size and dtype do not enter the rule: the kernel streams a
    page in chunks whose shared memory does not grow with either."""
    if sms is None:
        sms = _sms(torch.device("cuda", torch.cuda.current_device()))
    unsplit = b * kvh
    splits, pps = split_pages(unsplit, max_nb, sms)
    ws = splits * b * h * (d + 2) * 4 if splits > 1 else 0
    return dict(zip(DECODE_PLAN_KEYS, (splits, pps, splits * unsplit, ws)))


def paged_attention_split_plain(q, k_cache, v_cache, block_tables,
                                context_lens, splits, pages_per_split,
                                scale=None):
    """The decode kernel's split-and-combine arithmetic in plain PyTorch,
    on any device: split s attends over pages [s*P, (s+1)*P) of each
    sequence's walk and leaves a partial (m, l, acc) per query row,
    scores in log2 units (an empty split: m = -1e30, l = 0, acc = 0); the
    partials are summed in split order 0 .. S-1 with weights
    2^(m_s - max m), and acc / l (l == 0 read as one) is the output.
    One query per sequence sees the positions below its ctx: the ragged
    kernel's decode rows, so this is ``ragged_split_plain`` with one
    query a sequence. Shapes as in ``paged_attention``."""
    return ragged_split_plain(q, k_cache, v_cache, block_tables,
                              context_lens, splits, pages_per_split,
                              scale=scale)


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    scale=None):
    """Decode-step attention over a paged KV cache.

    q:            [B, H, D] one query token per sequence; query heads
                  h*G .. h*G+G-1 (G = H / KVH) read kv head h
    k/v_cache:    [KVH, num_blocks, block_size, D]
    block_tables: [B, max_blocks_per_seq] int cache-block ids (int64 is
                  cast to int32, as the JAX wrapper does)
    context_lens: [B] valid cache length per sequence (0: the row returns
                  zeros; past max_blocks * block_size: the table's blocks)
    returns       [B, H, D] in q's dtype

    A CPU tensor runs ``paged_attention_plain``. A CUDA tensor launches
    the kernel of ``csrc/paged_decode_attention.cu`` once, with the plan
    of ``decode_plan`` (counted in ``paged_attention.launches``), or
    raises. A split plan takes its f32 workspace from ``torch.empty`` and
    its counters from the zeroed buffer kept per card and stream, which
    the kernel leaves zeroed. Nothing here reads the lengths back to the
    host."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, block_tables,
                                     context_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} must be [B, H, D] and k/v "
            f"caches one [KVH, NB, BS, D] shape, got {tuple(k_cache.shape)} "
            f"/ {tuple(v_cache.shape)}")
    b, h, d = q.shape
    kvh, nb, bs, dk = k_cache.shape
    if dk != d or h % kvh:
        raise ValueError(f"paged_attention: head dim {d} vs cache {dk}, "
                         f"heads {h} vs kv heads {kvh}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"paged_attention: q/k/v dtypes {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype} must agree and be "
                         "float32, bfloat16 or float16")
    if d not in (32, 64, 128):
        raise ValueError(f"paged_attention: head dim {d} not in "
                         "(32, 64, 128)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"16-byte aligned tensor on {q.device}")
    tables = _on_device(block_tables, q.device, torch.int32)
    lens = _on_device(context_lens, q.device, torch.int32).reshape(-1)
    if tables.dim() != 2 or tables.shape[0] != b or tables.shape[1] < 1 \
            or lens.shape[0] != b:
        raise ValueError("paged_attention: block_tables must be [B, "
                         "max_blocks] and context_lens [B]")
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn, max_bs = _decode_launcher()
    if bs > max_bs:
        raise ValueError(f"paged_attention: block size {bs} above the "
                         f"kernel's {max_bs}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    plan = decode_plan(b, h, kvh, tables.shape[1], bs, d, q.dtype,
                       _sms(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32,
                         device=q.device)
        counters = _counters(q.device, stream, b * kvh)
    rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, h, kvh, nb, bs, tables.shape[1], d, plan["splits"],
            plan["pages_per_split"], float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    if _work.counting():
        _work.note("paged_decode_attention", *_work.paged_decode(
            lens.cpu().numpy(), bs, tables.shape[1], b, h, kvh, d,
            q.element_size()))
    return out


paged_attention.launches = 0


@functools.cache
def _decode_launcher():
    """(the decode kernel's C entry point with its prototype bound, the
    largest cache block size it takes), built and loaded on the first
    launch."""
    from . import _build
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    return fn, int(lib.paged_decode_attention_max_block_size())
