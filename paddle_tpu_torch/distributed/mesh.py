"""The training mesh of the PyTorch port (counterpart of the mesh that
``paddle_tpu/models/pretrain.py`` builds with ``make_mesh``, and of
``paddle_tpu/distributed/mesh.py``'s ``ProcessMesh``).

The JAX package lays devices out in a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. In the port every rank is a process (or,
in tests, a thread) with a ``torch.distributed`` world group, and the
mesh is that rank's view of the layout: the axis sizes in the order
``(pp, dp, fsdp, sp, mp)``, this rank's coordinates (the world rank in
row-major order over the axes, the JAX mesh's device order), and one
process group per axis of size > 1 plus the data group over
``(dp, fsdp)``, built over the world group's store with prefixes, as
``collective.new_group`` builds a group. A mesh of one rank has no
groups and needs none.

``ProcessMesh`` / ``get_mesh`` / ``set_mesh`` are the JAX package's; the
mesh set by a training step's ``run()`` is kept per thread, because
ranks may be threads of one process.
"""
import threading

import numpy as np
import torch.distributed as dist

from ..core.device import resolve_device
from . import collective

__all__ = ["AXES", "DATA_AXES", "Mesh", "ProcessMesh", "get_mesh",
           "set_mesh"]

AXES = ("pp", "dp", "fsdp", "sp", "mp")
DATA_AXES = ("dp", "fsdp")    # the batch's axes (JAX's ("dp", "fsdp"))

_builds = {}                  # (id(store), world rank) -> meshes built
_builds_lock = threading.Lock()


class Mesh:
    """One rank's view of a ``(pp, dp, fsdp, sp, mp)`` mesh.

    ``shape`` {axis: size}, ``axis_names`` AXES, ``size`` the rank count,
    ``rank`` this rank in the world group, ``coords`` {axis: index},
    ``device`` the rank's torch.device, ``world`` the caller's group,
    ``groups`` {axis or "data": group} for the axes of size > 1 (an axis
    of size 1 maps to None: its collectives are the identity).
    ``data_index`` / ``data_size``: this rank's place in the batch split
    over (dp, fsdp), row-major as JAX's combined axis. A mesh built
    without a world group (``group`` None) and more than one rank is a
    layout only: ``spec_for_param`` reads it, a training step refuses
    it."""

    axis_names = AXES

    def __init__(self, shape, group=None, device="cuda", timeout=None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.size = int(np.prod([self.shape[a] for a in AXES]))
        self.device = resolve_device(device)
        self.world = group
        self.layout_only = group is None and self.size > 1
        if group is not None and group.size() != self.size:
            raise ValueError(f"make_mesh: the world group has "
                             f"{group.size()} ranks, the mesh {self.size}")
        self.rank = group.rank() if group is not None else 0
        idx = np.unravel_index(self.rank, [self.shape[a] for a in AXES])
        self.coords = {a: int(i) for a, i in zip(AXES, idx)}
        self.data_size = self.shape["dp"] * self.shape["fsdp"]
        self.data_index = (self.coords["dp"] * self.shape["fsdp"]
                           + self.coords["fsdp"])
        self.groups = {a: None for a in AXES + ("data",)}
        if group is not None and self.size > 1:
            self._build_groups(group, timeout)

    def _members(self, axes):
        """World ranks sharing every coordinate but those on `axes`, in
        row-major order over `axes`."""
        grid = np.arange(self.size).reshape([self.shape[a] for a in AXES])
        sel = tuple(slice(None) if a in axes else self.coords[a]
                    for a in AXES)
        return grid[sel].reshape(-1).tolist()

    def _build_groups(self, world, timeout):
        store, world_timeout = collective.group_store(world)
        timeout = world_timeout if timeout is None else timeout
        with _builds_lock:
            key = (id(store), self.rank)
            n = _builds[key] = _builds.get(key, 0) + 1
        for name, axes in [(a, (a,)) for a in AXES] + [("data", DATA_AXES)]:
            members = self._members(axes)
            if len(members) < 2:
                continue
            tag = "-".join(map(str, members))
            sub = dist.PrefixStore(f"mesh{n}/{name}/{tag}", store)
            self.groups[name] = collective.new_group(
                members.index(self.rank), len(members), sub,
                timeout=timeout)
        self.groups["world"] = world

    def __repr__(self):
        dims = ", ".join(f"{a}={self.shape[a]}" for a in AXES)
        return f"Mesh({dims}; rank {self.rank} at {self.coords})"


class ProcessMesh:
    """The JAX package's ``ProcessMesh`` surface (shape, dim_names,
    process_ids) over a port ``Mesh``, a nested list of ranks, or
    another ProcessMesh."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        if isinstance(mesh, ProcessMesh):
            self._shape = mesh.shape
            self._dim_names = list(mesh.dim_names)
            self._process_ids = list(mesh.process_ids)
        elif isinstance(mesh, Mesh):
            self._shape = [mesh.shape[a] for a in AXES]
            self._dim_names = list(AXES)
            self._process_ids = list(range(mesh.size))
        else:
            arr = np.asarray(mesh)
            self._shape = list(arr.shape)
            self._process_ids = arr.ravel().tolist()
            if dim_names is None:
                dim_names = [f"d{i}" for i in range(arr.ndim)]
            self._dim_names = list(dim_names)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return list(self._process_ids)

    @property
    def size(self):
        return int(np.prod(self._shape))

    def get_dim_size(self, dim_name):
        return self._shape[self._dim_names.index(dim_name)]

    def dim_index(self, dim_name):
        return self._dim_names.index(dim_name)

    def get_mesh_with_dim(self, dim_name):
        """Sub-mesh along one axis (parity with reference API)."""
        idx = self.dim_index(dim_name)
        arr = np.asarray(self._process_ids).reshape(self._shape)
        moved = np.moveaxis(arr, idx, 0)
        names = [dim_name] + [n for n in self._dim_names if n != dim_name]
        return ProcessMesh(moved, dim_names=names)

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._dim_names == other._dim_names
                and self._process_ids == other._process_ids)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names),
                     tuple(self._process_ids)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")


_local = threading.local()


def set_mesh(mesh):
    _local.mesh = mesh


def get_mesh():
    return getattr(_local, "mesh", None)
