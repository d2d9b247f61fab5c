"""The process-level parallel environment and ``DataParallel`` of the
PyTorch port (counterpart of ``paddle_tpu/distributed/parallel.py``;
reference python/paddle/distributed/parallel.py:219, :978).

The JAX package drives every device from one controller: its
``DataParallel`` shards one global batch over the mesh and XLA reduces the
gradients of the global loss inside the program. In the port every rank
is a process (or, in tests, a thread) with its own batch, and
``DataParallel`` averages the ranks' gradients during the backward
(``fleet.reducer.EagerReducer``, one flat all_reduce a bucket), as the
reference's EagerReducer does. Two cases give the JAX gradients: a mean
loss over equal local batches, and every rank holding the same whole
batch. A sum loss over split batches gives 1 / nranks of the JAX gradient
(ROADMAP Queue 3, contract differences). Building ``DataParallel`` copies
rank 0's parameters and buffers to every rank of the group (the
reference's ``sync_params_buffers``), so replicas that were initialised
apart start equal.

``init_parallel_env(group=, device=)`` takes the caller's
``torch.distributed`` group, as ``fleet.init`` takes it; nothing here
calls ``init_process_group``. The environment is kept per thread, because
ranks may be threads of one process."""
import itertools
import threading

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from . import collective
from .fleet.reducer import EagerReducer

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "ParallelEnv", "ParallelMode", "DataParallel", "is_initialized",
           "destroy_process_group", "is_available", "get_backend"]

_local = threading.local()


def _env():
    return getattr(_local, "env", None)


def init_parallel_env(group=None, device="cuda"):
    """Make ``group`` (the caller's ``torch.distributed`` group, e.g.
    ``collective.new_group``'s; None for a world of one rank) and
    ``device`` this thread's parallel environment; returns
    ``ParallelEnv()``."""
    _local.env = {"group": group, "device": resolve_device(device)}
    return ParallelEnv()


def _group(group):
    if group is not None:
        return group
    env = _env()
    return env["group"] if env is not None else None


def get_rank(group=None):
    g = _group(group)
    return g.rank() if g is not None else 0


def get_world_size(group=None):
    g = _group(group)
    return g.size() if g is not None else 1


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device(self):
        env = _env()
        return env["device"] if env is not None else None

    @property
    def dev_id(self):
        dev = self.device
        return dev.index or 0 if dev is not None else 0

    local_rank = rank
    nranks = world_size


class ParallelMode:
    """Parallelism kind enum (reference base/topology.py:61)."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


def is_initialized():
    """True once ``init_parallel_env`` ran on this thread."""
    return _env() is not None


def destroy_process_group(group=None):
    """Drop this thread's parallel environment (for ``group`` None or the
    environment's own group). The caller owns its groups and closes
    them."""
    env = _env()
    if env is not None and (group is None or group is env["group"]):
        _local.env = None


def is_available():
    return dist.is_available()


def get_backend(group=None):
    """The backend of ``group`` (or of the environment's): "gloo" or
    "nccl"."""
    g = _group(group)
    if g is None:
        raise ValueError("get_backend: no group (pass one, or "
                         "init_parallel_env(group=) first)")
    return g.name()


def _data_group():
    """The data-parallel group: fleet's hybrid group's, else the parallel
    environment's (None: one rank)."""
    from .fleet.topology import get_hcg
    hcg = get_hcg()
    if hcg is not None:
        return hcg.get_data_parallel_group()
    return _group(None)


@torch.no_grad()
def _sync_params_buffers(layers, group):
    """Copy the group's rank 0's parameters and buffers into every rank's,
    one broadcast a tensor."""
    for t in itertools.chain(layers.parameters(), layers.buffers()):
        x = t.detach()
        y = x if x.is_contiguous() else x.contiguous()
        collective.broadcast(y, src=0, group=group)
        if y is not x:
            x.copy_(y)


class DataParallel(torch.nn.Module):
    """``layers`` whose gradients are averaged over the data-parallel
    ``group`` (default: fleet's data-parallel group, else the parallel
    environment's) during each backward (``EagerReducer``: buckets of
    ``comm_buffer_size`` MB, ``find_unused_parameters``). Each rank feeds
    its own batch; ``forward`` calls ``layers`` as it is. Building it
    broadcasts rank 0's parameters and buffers over ``group`` (every rank
    builds it: a collective). Each layer inside that defines
    ``adopt_data_group`` (``SyncBatchNorm``) is handed ``group``.
    ``state_dict`` and ``set_state_dict`` are
    the wrapped module's, without a prefix."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group if group is not None else _data_group()
        if self.group is not None and self.group.size() > 1:
            _sync_params_buffers(layers, self.group)
        for m in layers.modules():
            adopt = getattr(m, "adopt_data_group", None)
            if adopt is not None:
                adopt(self.group)
        self._reducer = EagerReducer(
            layers.parameters(), self.group,
            comm_buffer_size_mb=comm_buffer_size,
            find_unused_parameters=find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def no_sync(self):
        """A context: backwards inside accumulate local gradients without
        communication; the next synchronised backward reduces the sum."""
        return self._reducer.no_sync()

    def cleanup(self):
        """Remove the reducer's hooks."""
        if self._reducer is not None:
            self._reducer.remove()
            self._reducer = None

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def scale_loss(self, loss):
        """The loss as it is: the reducer averages the gradients."""
        return loss

    def apply_collective_grads(self):
        """Nothing to do: the reducer reduced the gradients inside the
        backward."""
