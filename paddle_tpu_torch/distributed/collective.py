"""Collectives of the PyTorch port (counterpart of
``paddle_tpu/distributed/collective.py``; Paddle's names), as thin
functions over ``torch.distributed`` on an EXPLICIT group.

The JAX package drives every device from one controller, so its
collectives are mesh-axis reductions inside a program. Here each rank is
a process (or, in tests, a thread) holding a ``torch.distributed``
process group, and a collective is that group's operation on a tensor.
The caller owns the group: ``new_group`` builds a gloo group over a
store the caller names, and any other ``torch.distributed`` group works
as well; nothing here calls ``init_process_group``. The operations go through the
group object's own methods (``allreduce`` / ``broadcast`` / ``barrier``),
so a group built directly (``dist.ProcessGroupGloo(store, rank, size,
timeout)``, which ``torch.distributed``'s registry does not know) works
as well as one from ``dist.new_group``.

Every call waits for its work, bounded by the group's timeout (or the
call's own ``timeout``): a peer that died or stopped answering makes the
call raise, never hang. Each call is counted in the
function's ``calls``. ``all_reduce``, ``all_gather`` and
``reduce_scatter`` take the mesh axis they run on (``axis``: "dp",
"fsdp", "mp", "data" or "world") and an optional per-rank ``stats``
dict: a call with an axis goes through the comm watchdog's
``task_scope`` under that label (a call without one is a part of a
step that the caller scopes itself, as tensor-parallel serving's paged
step), and adds its count and payload bytes to ``stats`` under
"op,axis" (the sharded training step's per-rank tally; "world" when no
axis is named). gloo takes CUDA tensors for all four operations (it
copies them through pinned host memory on streams of its own; checked
on torch 2.11 with CUDA 12.8 on the H100 in f32, bf16 and f64), so the
computation stays on the card and no operation is staged here.
"""
import contextlib
import datetime
import os
import threading
import weakref

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "new_group", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "barrier", "group_store",
           "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 60.0


class ReduceOp:
    SUM = "sum"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM}


def _timedelta(seconds):
    return datetime.timedelta(seconds=float(seconds))


def new_group(rank, world_size, store, timeout=DEFAULT_TIMEOUT_S):
    """A gloo process group of `world_size` ranks with this caller as
    `rank`, rendezvousing through `store`: a ``torch.distributed`` Store
    (``HashStore`` for ranks that are threads of one process), or a path,
    which becomes a ``FileStore`` of `world_size` ranks (ranks that are
    processes of one host; the file must not exist before the first rank
    opens it). gloo takes CPU tensors, and CUDA tensors through the host,
    so ranks may share one card; a caller with one card a rank may bring
    an NCCL group of its own instead. `timeout` (seconds) bounds every
    operation of the group."""
    if isinstance(store, (str, os.PathLike)):
        store = dist.FileStore(os.fspath(store), int(world_size))
    g = dist.ProcessGroupGloo(store, int(rank), int(world_size),
                              _timedelta(timeout))
    _STORES[g] = (store, float(timeout))
    return g


_STORES = weakref.WeakKeyDictionary()   # group -> (store, timeout s)


def group_store(group):
    """(store, timeout in seconds) of a group: the store ``new_group``
    was given, or the default group's store for a group of
    ``torch.distributed``'s registry. Sub-groups (a mesh's axes) are
    built over it with prefixes."""
    got = _STORES.get(group)
    if got is not None:
        return got
    try:
        from torch.distributed import distributed_c10d as c10d
        _, store = c10d._world.pg_map[group]
        return store, DEFAULT_TIMEOUT_S
    except Exception:
        raise ValueError("group_store: the group was not made by new_group "
                         "and is not in torch.distributed's registry; pass "
                         "the store") from None


def _group(group):
    if group is None:
        raise ValueError("the port's collectives need an explicit group "
                         "(new_group or a torch.distributed ProcessGroup)")
    return group


def _count(fn):
    with _COUNT_LOCK:
        fn.calls += 1


_COUNT_LOCK = threading.Lock()

def _tally(stats, op, axis, nbytes):
    """One call of `op` on `axis` moving `nbytes` into the caller's
    per-rank ``stats``: {"op,axis": {"calls", "bytes"}}."""
    if stats is None:
        return
    row = stats.setdefault(f"{op},{axis or 'world'}",
                           {"calls": 0, "bytes": 0})
    row["calls"] += 1
    row["bytes"] += int(nbytes)


def _nbytes(t):
    return t.numel() * t.element_size()


def _scope(op, axis, nbytes):
    from . import comm_watchdog
    if axis is None:
        return contextlib.nullcontext()
    return comm_watchdog.task_scope(op, axis, nbytes)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               axis=None, stats=None):
    """Reduce `tensor` over the group's ranks IN PLACE (every rank gets
    the result) and return it. Counted in ``all_reduce.calls``."""
    g = _group(group)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    with _scope("all_reduce", axis, _nbytes(tensor)):
        work = g.allreduce([tensor], opts)
        _count(all_reduce)
        if sync_op:
            work.wait()
    _tally(stats, "all_reduce", axis, _nbytes(tensor))
    return tensor


all_reduce.calls = 0


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               axis=None, stats=None):
    """Every rank's `tensor` (one shape and dtype on all ranks) into
    `tensor_list` in rank order, Paddle's signature: an empty list is
    filled with new tensors on `tensor`'s device, a full one written
    in place. Returns the list. Payload bytes: the gathered whole (the
    group's size times `tensor`'s). Counted in ``all_gather.calls``."""
    g = _group(group)
    n = g.size()
    if not tensor_list:
        tensor_list.extend(torch.empty_like(tensor) for _ in range(n))
    if len(tensor_list) != n:
        raise ValueError(f"all_gather: {len(tensor_list)} outputs for a "
                         f"group of {n}")
    nbytes = n * _nbytes(tensor)
    with _scope("all_gather", axis, nbytes):
        work = g.allgather([tensor_list], [tensor.contiguous()])
        _count(all_gather)
        if sync_op:
            work.wait()
    _tally(stats, "all_gather", axis, nbytes)
    return tensor_list


all_gather.calls = 0


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True, axis=None, stats=None):
    """Reduce `tensor_list` (one tensor per rank, in rank order) over the
    group and write this rank's reduced piece into `tensor`, Paddle's
    signature; returns `tensor`. Payload bytes: the whole list. Counted
    in ``reduce_scatter.calls``."""
    g = _group(group)
    if len(tensor_list) != g.size():
        raise ValueError(f"reduce_scatter: {len(tensor_list)} inputs for "
                         f"a group of {g.size()}")
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = _TORCH_OPS[op]
    nbytes = sum(_nbytes(t) for t in tensor_list)
    with _scope("reduce_scatter", axis, nbytes):
        work = g.reduce_scatter([tensor], [[t.contiguous()
                                            for t in tensor_list]], opts)
        _count(reduce_scatter)
        if sync_op:
            work.wait()
    _tally(stats, "reduce_scatter", axis, nbytes)
    return tensor


reduce_scatter.calls = 0


def broadcast(tensor, src=0, group=None, sync_op=True, timeout=None):
    """Copy rank `src`'s `tensor` into every rank's `tensor` IN PLACE and
    return it. `timeout` (seconds) replaces the group's bound for this
    call alone: a rank that waits for work to arrive (a follower between
    requests) may wait longer than an exchange inside a step may take."""
    g = _group(group)
    opts = dist.BroadcastOptions()
    opts.rootRank = int(src)
    opts.rootTensor = 0
    if timeout is not None:
        opts.timeout = _timedelta(timeout)
    work = g.broadcast([tensor], opts)
    _count(broadcast)
    if sync_op:
        work.wait()
    return tensor


broadcast.calls = 0


def barrier(group=None):
    """Wait until every rank of the group reaches the barrier (an
    all_reduce of one element, which every backend takes on the CPU for
    gloo and on the rank's card for nccl)."""
    g = _group(group)
    dev = "cuda" if g.name() == "nccl" else "cpu"
    t = torch.zeros(1, device=dev)
    work = g.allreduce([t], dist.AllreduceOptions())
    work.wait()
