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
function's ``calls`` (and tallied into ``stats``, and its payload bytes
into the comm watchdog's ``collective_bytes_total``) BEFORE it is
dispatched: with ranks that are threads of one process, a peer's call
is on the count by the time any rank's call of the same collective can
return. ``all_reduce``, ``all_gather`` and
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
computation stays on the card and none of them is staged here.

The exchanges of context parallelism take the same bookkeeping:
``all_to_all`` / ``alltoall`` (a list a rank) and ``all_to_all_single``
/ ``alltoall_single`` (one tensor split along dim 0), tallied as
"all_to_all" with the bytes this rank sends (its whole input), and the
point-to-point ``send`` / ``recv`` / ``isend`` / ``irecv`` with
``P2POp`` and ``batch_isend_irecv`` (peers are ranks of the group),
tallied as "send" and "recv". Every one is a real operation on the
group: where the JAX package's single controller makes eager send / recv
a no-op pair, a rank here waits for its peer, within the group's
timeout. gloo's send and recv read and write the tensor's memory from
the host, so a CUDA tensor goes through a pinned host buffer for them on
a gloo group (``GLOO_STAGED``; the card computes, the copies are the
only host work, and their bytes are counted in each function's
``staged_bytes``). ``tools/gloo_cuda_probe.py`` checks each operation
with CUDA tensors on the card: on torch 2.11 with CUDA 12.8 on the
H100, in f32 and bf16, allreduce, allgather, reduce_scatter, broadcast
and alltoall_base took them; send / recv aborted the process; the list
alltoall is not in gloo there at all, so ``all_to_all`` runs on
alltoall_base.
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
           "all_to_all", "all_to_all_single", "alltoall", "alltoall_single",
           "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "DEFAULT_TIMEOUT_S", "GLOO_STAGED"]

DEFAULT_TIMEOUT_S = 60.0
# operations that take a CUDA tensor through pinned host memory on a gloo
# group (tools/gloo_cuda_probe.py on the H100)
GLOO_STAGED = frozenset({"send", "recv"})


class ReduceOp:
    SUM = "sum"
    MAX = "max"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX}


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
    the result) and return it; with ``sync_op=False`` return the
    operation's work instead, not waited for (Paddle's task: ``wait()``
    it before reading `tensor`). Counted in ``all_reduce.calls``."""
    g = _group(group)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    _count(all_reduce)
    _tally(stats, "all_reduce", axis, _nbytes(tensor))
    with _scope("all_reduce", axis, _nbytes(tensor)):
        work = g.allreduce([tensor], opts)
        if not sync_op:
            return work
        work.wait()
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
    _count(all_gather)
    _tally(stats, "all_gather", axis, nbytes)
    with _scope("all_gather", axis, nbytes):
        work = g.allgather([tensor_list], [tensor.contiguous()])
        if sync_op:
            work.wait()
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
    _count(reduce_scatter)
    _tally(stats, "reduce_scatter", axis, nbytes)
    with _scope("reduce_scatter", axis, nbytes):
        work = g.reduce_scatter([tensor], [[t.contiguous()
                                            for t in tensor_list]], opts)
        if sync_op:
            work.wait()
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
    _count(broadcast)
    work = g.broadcast([tensor], opts)
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


# -- all_to_all and point-to-point ------------------------------------------

def _staged(g, op, t):
    """Whether `op` takes `t` through a pinned host buffer on `g`."""
    return t.is_cuda and op in GLOO_STAGED and g.name() == "gloo"


def _host_like(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class _Staged:
    """The work of an operation, with what staging through host memory
    adds: ``wait`` waits for it and then copies each received host
    buffer to its tensor on the card (``copies``: (dest, host) pairs);
    ``keep`` holds a sent host buffer until then; ``scope``, the comm
    watchdog's task of a point-to-point operation, ends there (its
    collective_seconds run from dispatch to the result)."""

    def __init__(self, work, copies=(), keep=None, scope=None):
        self.work, self.copies, self.keep = work, list(copies), keep
        self.scope = scope

    def wait(self, timeout=None):
        if timeout is None:
            self.work.wait()
        elif isinstance(self.work, _Staged):
            self.work.wait(timeout)
        else:
            self.work.wait(_timedelta(timeout))
        for dest, host in self.copies:
            dest.copy_(host)
        self.copies, self.keep = [], None
        if self.scope is not None:
            self.scope.__exit__(None, None, None)
            self.scope = None
        return True

    def is_completed(self):
        return self.work.is_completed() and not self.copies


def all_to_all_single(out_tensor, in_tensor, in_split_sizes=None,
                      out_split_sizes=None, group=None, sync_op=True,
                      axis=None, stats=None):
    """Split `in_tensor` along dim 0 (evenly, or by ``in_split_sizes``),
    send part j to rank j and write the parts received, in rank order,
    into `out_tensor` (split by ``out_split_sizes``); Paddle's signature.
    Returns `out_tensor`, or the work with ``sync_op=False``. Payload
    bytes: `in_tensor`'s. Counted in ``all_to_all_single.calls``."""
    g = _group(group)
    x = in_tensor.contiguous()
    nbytes = _nbytes(x)
    _count(all_to_all_single)
    _tally(stats, "all_to_all", axis, nbytes)
    dst, src = out_tensor, x
    if _staged(g, "all_to_all", x):
        dst, src = _host_like(out_tensor), _host_like(x).copy_(x)
        all_to_all_single.staged_bytes += 2 * nbytes
    with _scope("all_to_all", axis, nbytes):
        work = g.alltoall_base(dst, src, list(out_split_sizes or []),
                               list(in_split_sizes or []),
                               dist.AllToAllOptions())
        if dst is not out_tensor:
            work = _Staged(work, [(out_tensor, dst)])
        if not sync_op:
            return work
        work.wait()
    return out_tensor


all_to_all_single.calls = 0
all_to_all_single.staged_bytes = 0


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True,
               axis=None, stats=None):
    """Send ``in_tensor_list[j]`` to rank j and receive rank j's tensor
    for this rank into ``out_tensor_list[j]`` (an empty list is filled
    with tensors shaped like the inputs), Paddle's signature; one dtype
    for all. One exchange of the flattened tensors with split sizes
    (gloo has no list form on every torch: "Backend gloo does not
    support alltoall" on 2.11). Returns the list, or the work with
    ``sync_op=False``. Payload bytes: the inputs'. Counted in
    ``all_to_all.calls``."""
    g = _group(group)
    n = g.size()
    ins = [t.contiguous() for t in in_tensor_list]
    if len(ins) != n:
        raise ValueError(f"all_to_all: {len(ins)} inputs for a group of {n}")
    if not out_tensor_list:
        out_tensor_list.extend(torch.empty_like(t) for t in ins)
    src = torch.cat([t.reshape(-1) for t in ins])
    dst = torch.empty(sum(t.numel() for t in out_tensor_list),
                      dtype=src.dtype, device=src.device)
    _count(all_to_all)
    work = all_to_all_single(
        dst, src, in_split_sizes=[t.numel() for t in ins],
        out_split_sizes=[t.numel() for t in out_tensor_list], group=g,
        sync_op=False, axis=axis, stats=stats)
    parts, off = [], 0
    for t in out_tensor_list:
        parts.append((t, dst[off:off + t.numel()].view(t.shape)))
        off += t.numel()
    work = _Staged(work, parts, keep=src)
    if not sync_op:
        return work
    work.wait()
    return out_tensor_list


all_to_all.calls = 0


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             axis=None, stats=None):
    """``all_to_all`` under Paddle's other name."""
    return all_to_all(out_tensor_list, in_tensor_list, group=group,
                      sync_op=sync_op, axis=axis, stats=stats)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    axis=None, stats=None):
    """``all_to_all_single`` under Paddle's other name."""
    return all_to_all_single(out_tensor, in_tensor, in_split_sizes,
                             out_split_sizes, group=group, sync_op=sync_op,
                             axis=axis, stats=stats)


def _p2p(dispatch, op, axis, nbytes, copies=(), keep=None):
    """The work of a point-to-point ``dispatch()``, its watchdog task
    open from here to the work's ``wait``."""
    scope = _scope(op, axis, nbytes)
    scope.__enter__()
    try:
        return _Staged(dispatch(), copies, keep, scope)
    except BaseException:
        scope.__exit__(None, None, None)
        raise


def isend(tensor, dst=0, group=None, axis=None, stats=None, tag=0):
    """Start sending `tensor` to rank `dst` of the group and return the
    work (``wait()`` before writing `tensor`). Counted in
    ``isend.calls``; tallied as "send". Messages between two ranks with
    one ``tag`` arrive in the order they were sent; a receive matches a
    send of its own tag only."""
    g = _group(group)
    x = tensor.contiguous()
    nbytes = _nbytes(x)
    _count(isend)
    _tally(stats, "send", axis, nbytes)
    if _staged(g, "send", x):
        x = _host_like(x).copy_(x)
        isend.staged_bytes += nbytes
    return _p2p(lambda: g.send([x], int(dst), int(tag)), "send", axis,
                nbytes, keep=x)


isend.calls = 0
isend.staged_bytes = 0


def irecv(tensor, src=0, group=None, axis=None, stats=None, tag=0):
    """Start receiving rank `src`'s tensor into `tensor` (contiguous, of
    the sender's shape and dtype) and return the work: `tensor` holds
    the data once ``wait()`` returns. Counted in ``irecv.calls``; tallied
    as "recv"."""
    g = _group(group)
    if not tensor.is_contiguous():
        raise ValueError("irecv: the receiving tensor must be contiguous")
    nbytes = _nbytes(tensor)
    _count(irecv)
    _tally(stats, "recv", axis, nbytes)
    if _staged(g, "recv", tensor):
        host = _host_like(tensor)
        irecv.staged_bytes += nbytes
        return _p2p(lambda: g.recv([host], int(src), int(tag)), "recv",
                    axis, nbytes, copies=[(tensor, host)])
    return _p2p(lambda: g.recv([tensor], int(src), int(tag)), "recv", axis,
                nbytes)


irecv.calls = 0
irecv.staged_bytes = 0


def send(tensor, dst=0, group=None, sync_op=True, axis=None, stats=None,
         tag=0):
    """Send `tensor` to rank `dst` of the group; returns `tensor` once
    sent, or the work with ``sync_op=False``. A real transfer: the peer
    must ``recv`` it, within the group's timeout."""
    work = isend(tensor, dst, group, axis=axis, stats=stats, tag=tag)
    if not sync_op:
        return work
    work.wait()
    return tensor


def recv(tensor, src=0, group=None, sync_op=True, axis=None, stats=None,
         tag=0):
    """Receive rank `src`'s tensor into `tensor` and return it, or the
    work with ``sync_op=False``; raises when the peer sends nothing
    within the group's timeout."""
    work = irecv(tensor, src, group, axis=axis, stats=stats, tag=tag)
    if not sync_op:
        return work
    work.wait()
    return tensor


class P2POp:
    """One point-to-point operation of ``batch_isend_irecv``: ``op`` is
    ``isend`` or ``irecv``, ``peer`` a rank of ``group``, ``tag`` the
    message's tag."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        if op not in (isend, irecv):
            raise ValueError("P2POp: op must be isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        self.tag = tag


def batch_isend_irecv(p2p_op_list, axis=None, stats=None):
    """Start every operation of the list (sends and receives together,
    so a ring shift cannot deadlock) and return their works in list
    order. Counted in ``batch_isend_irecv.calls``."""
    _count(batch_isend_irecv)
    return [op.op(op.tensor, op.peer, op.group, axis=axis, stats=stats,
                  tag=op.tag) for op in p2p_op_list]


batch_isend_irecv.calls = 0
