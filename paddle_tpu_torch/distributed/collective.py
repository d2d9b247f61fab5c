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
call raise, never hang. Only what tensor-parallel serving calls is here:
``all_reduce``, ``broadcast``, ``barrier``, ``new_group``; the rest
(all_gather, reduce_scatter, ...) belongs to the sharded training mesh.
"""
import datetime
import os
import threading

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "new_group", "all_reduce", "broadcast", "barrier",
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
    return dist.ProcessGroupGloo(store, int(rank), int(world_size),
                                 _timedelta(timeout))


def _group(group):
    if group is None:
        raise ValueError("the port's collectives need an explicit group "
                         "(new_group or a torch.distributed ProcessGroup)")
    return group


def _count(fn):
    with _COUNT_LOCK:
        fn.calls += 1


_COUNT_LOCK = threading.Lock()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce `tensor` over the group's ranks IN PLACE (every rank gets
    the result) and return it. Counted in ``all_reduce.calls``."""
    g = _group(group)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _TORCH_OPS[op]
    work = g.allreduce([tensor], opts)
    _count(all_reduce)
    if sync_op:
        work.wait()
    return tensor


all_reduce.calls = 0


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
