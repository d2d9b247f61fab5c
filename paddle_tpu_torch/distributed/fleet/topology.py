"""The hybrid topology of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/topology.py``; reference
python/paddle/distributed/fleet/base/topology.py).

Paddle names five axes, ``[data, pipe, sharding, sep, model]``, and
builds one communicator per axis. The JAX package makes them the axes
of one device mesh. In the port every rank is a process (or, in tests,
a thread) with a ``torch.distributed`` world group, and the topology is
that rank's ``distributed.mesh.Mesh``: Paddle's "data" is the mesh's
``dp``, "sharding" its ``fsdp``, "sep" its ``sp`` (context parallelism:
``fleet.context_parallel``) and "model" its ``mp``; each axis's group is
the mesh's group of that axis (one group a rank for an axis of size 1,
so that every getter hands back a group), and
``get_dp_sep_parallel_group`` the mesh's group over dp and sp. "pipe" is
the mesh's ``pp`` (pipeline parallelism: ``fleet.pipeline_parallel``),
and a rank's stage is its coordinate there (``get_stage_id``,
``is_first_stage`` / ``is_last_stage``, the previous and next stage's
rank in the pp group: ``get_p2p_prev_rank`` / ``get_p2p_next_rank``).

The rank order is the port mesh's, row-major over ``(pp, dp, fsdp, sp,
mp)`` (``distributed.mesh.AXES``, the order ``make_mesh(pp=)`` of both
packages uses), where the JAX package's topology lays Paddle's axes out
as ``[data, pipe, sharding, sep, model]``. The two agree while dp is 1 or
pp is 1; with both above 1 world rank r sits at other coordinates (with
pp 2 x dp 2 x mp 2, rank 2 is pp 0, dp 1 here and dp 0, pp 1 there).
``topology()`` gives the ranks in Paddle's axis order, each at its
coordinates here.

The caller passes its world group and its device, as ``Mesh`` takes
them; nothing here calls ``init_process_group``. ``set_hcg`` /
``get_hcg`` keep the group per thread, as ``mesh.set_mesh`` does,
because ranks may be threads of one process.
"""
import threading

import numpy as np

from .. import collective
from ..mesh import Mesh, ProcessMesh

__all__ = ["AXES", "CommunicateTopology", "HybridCommunicateGroup",
           "set_hcg", "get_hcg"]

AXES = ["data", "pipe", "sharding", "sep", "model"]
_MESH_AXIS = {"data": "dp", "pipe": "pp", "sharding": "fsdp", "sep": "sp",
              "model": "mp", "dp_sep": "dp_sp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._names = hybrid_group_names or AXES
        self._dims = dims or [1] * len(self._names)

    def get_hybrid_group_names(self):
        return list(self._names)

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    def world_size(self):
        return int(np.prod(self._dims))


class HybridCommunicateGroup:
    """One rank's view of the hybrid topology over a port ``Mesh``
    (``mesh``). ``group`` is the caller's world group (None for a world
    of one rank), ``device`` the rank's device (the card unless the
    caller names the CPU)."""

    def __init__(self, topology=None, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, sep_degree=1, order=None, group=None,
                 device="cuda"):
        if topology is not None:
            dims = dict(zip(topology._names, topology._dims))
            dp_degree = dims.get("data", dp_degree)
            pp_degree = dims.get("pipe", pp_degree)
            sharding_degree = dims.get("sharding", sharding_degree)
            sep_degree = dims.get("sep", sep_degree)
            mp_degree = dims.get("model", mp_degree)
        self._dp_degree = int(dp_degree)
        self._mp_degree = int(mp_degree)
        self._pp_degree = int(pp_degree)
        self._sharding_degree = int(sharding_degree)
        self._sep_degree = int(sep_degree)
        world = self._pp_degree * self._dp_degree * \
            self._sharding_degree * self._sep_degree * self._mp_degree
        if group is None and world > 1:
            raise ValueError(
                f"HybridCommunicateGroup: a world of {world} ranks needs "
                "the caller's world group (group=)")
        self.mesh = Mesh({"pp": self._pp_degree, "dp": self._dp_degree,
                          "fsdp": self._sharding_degree,
                          "sp": self._sep_degree,
                          "mp": self._mp_degree}, group=group,
                         device=device)
        self._groups = {}
        self._lock = threading.Lock()

    # -- degrees ---------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # -- ranks: this rank's coordinate on each axis ---------------------
    def get_data_parallel_rank(self):
        return self.mesh.coords["dp"]

    def get_model_parallel_rank(self):
        return self.mesh.coords["mp"]

    def get_stage_id(self):
        return self.mesh.coords["pp"]

    def get_pipe_parallel_rank(self):
        return self.mesh.coords["pp"]

    def is_first_stage(self):
        return self.mesh.coords["pp"] == 0

    def is_last_stage(self):
        return self.mesh.coords["pp"] == self._pp_degree - 1

    def get_p2p_prev_rank(self):
        """The previous stage's rank in the pp group (the last stage's
        for the first stage: the ring's wrap)."""
        return (self.mesh.coords["pp"] - 1) % self._pp_degree

    def get_p2p_next_rank(self):
        """The next stage's rank in the pp group (the first stage's for
        the last stage)."""
        return (self.mesh.coords["pp"] + 1) % self._pp_degree

    def get_rank_from_stage(self, stage_id):
        """The world rank of stage `stage_id` with this rank's other
        coordinates."""
        return self.mesh._members(("pp",))[stage_id]

    def get_sharding_parallel_rank(self):
        return self.mesh.coords["fsdp"]

    def get_sep_parallel_rank(self):
        return self.mesh.coords["sp"]

    def get_global_rank(self):
        return self.mesh.rank

    # -- groups ----------------------------------------------------------
    def _group(self, name):
        """The mesh's group of Paddle axis ``name``; a group of this rank
        alone for an axis of size 1."""
        g = self.mesh.groups.get(_MESH_AXIS.get(name))
        if g is not None:
            return g
        with self._lock:
            if name not in self._groups:
                import torch.distributed as dist
                self._groups[name] = collective.new_group(
                    0, 1, dist.HashStore())
            return self._groups[name]

    def get_data_parallel_group(self):
        return self._group("data")

    def get_model_parallel_group(self):
        return self._group("model")

    def get_pipe_parallel_group(self):
        return self._group("pipe")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_dp_sep_parallel_group(self):
        """The group over the data and sep axes: the ranks whose
        gradients of a replicated parameter are averaged under context
        parallelism (the dp group when sep is 1, the sep group when dp
        is)."""
        if self._sep_degree == 1:
            return self._group("data")
        if self._dp_degree == 1:
            return self._group("sep")
        return self._group("dp_sep")

    def get_check_parallel_group(self, *a):
        return self._group("data")

    def get_model_parallel_group_src_rank(self):
        """The world rank of the first rank of this rank's model-parallel
        group."""
        return self.mesh._members(("mp",))[0]

    def topology(self):
        """The ranks as a ``ProcessMesh`` over Paddle's five axes (the JAX
        package's topology): the entry at (data, pipe, sharding, sep,
        model) is the world rank at those coordinates of this mesh."""
        grid = np.arange(self.mesh.size).reshape(
            [self._pp_degree, self._dp_degree, self._sharding_degree,
             self._sep_degree, self._mp_degree])
        return ProcessMesh(grid.transpose(1, 0, 2, 3, 4), dim_names=AXES)


_local = threading.local()


def set_hcg(hcg):
    _local.hcg = hcg


def get_hcg():
    return getattr(_local, "hcg", None)
