"""The sharded compute of the training mesh (the port's counterpart of what
GSPMD inserts into the JAX package's jitted pretraining step,
``paddle_tpu/models/pretrain.py``): ZeRO-3 over ``fsdp`` and Megatron
tensor parallelism over ``mp``, as ``torch.autograd.Function``s on the
mesh's explicit groups.

Storage. Each rank holds the float32 shard of every parameter that the
JAX spec (``pretrain.spec_for_param``) gives the device at its mesh
coordinates, and AdamW's two moments of the same shape: the bytes at
rest are the JAX device's ``addressable_shards`` bytes. One difference of
order: a fused column-parallel weight whose heads (or FFN columns) split
over mp holds its own heads together, ``[q_r | k_r | v_r]`` for
``qkv_proj`` and ``[gate_r | up_r]`` for ``gate_up_fused_proj``, where a
contiguous split of the JAX layout would give rank 0 every q head. It is
a permutation of the JAX shard's columns (``ParamLayout``), with the same
bytes.

Compute. A weight that is split over the mesh is cast to the compute
dtype (bf16 under AMP-O2) and all-gathered just before its layer uses it
(``bound``), over its
data axes (dp / fsdp: ZeRO-3; backward reduce-scatters the float32
gradient back to the shard, summing the ranks' tokens) and, where its
module runs whole, over mp (backward takes the rank's slice: every mp
rank computes the same whole gradient). A module whose heads (or columns)
split evenly over mp runs Megatron-style on its local part, between the
two operators of its ``_tp`` binding: ``enter`` before it (identity
forward, all_reduce of the input's gradient backward) and ``leave``
after its row-parallel projection (all_reduce forward, identity
backward). The embedding and
the LM head run whole. Under recompute a layer's weights are gathered
again in the backward.

Gradients left after the backward (a weight replicated over a data axis)
are summed over the data axes that remain, one flat all_reduce a set of
axes (``reduce_grads``); the mp axis is never summed: a weight computed
whole on every mp rank has the same gradient on each of them.
``owned`` marks the shards a rank counts in the clip norm and the
telemetry, so that a tensor replicated over ranks counts once.
"""
import contextlib
import re

import numpy as np
import torch

from .. import collective
from ..mesh import AXES, DATA_AXES

__all__ = ["ParamLayout", "ParamPlan", "plan_params", "bound",
           "reduce_grads", "owned", "step_comm"]

# Megatron roles of the Llama projections: column-parallel ones split
# their output dim (1) over mp, the row-parallel o_proj / down_proj their
# input dim (0)
_COLUMN = ("q_proj", "k_proj", "v_proj", "qkv_proj", "gate_proj", "up_proj",
           "gate_up_fused_proj")
_ATTN = ("q_proj", "k_proj", "v_proj", "qkv_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "gate_up_fused_proj", "down_proj")


class ParamLayout:
    """Where one parameter's shard lies in the whole tensor: ``shape`` the
    whole shape, ``spec`` a tuple of axis names or None per dim,
    ``groups`` the column groups of a fused weight whose mp split is
    taken group by group (None for a contiguous split)."""

    def __init__(self, shape, spec, mesh_shape, groups=None):
        self.shape = tuple(int(d) for d in shape)
        self.spec = tuple(spec)
        self.mesh_shape = dict(mesh_shape)
        self.groups = groups
        self.local_shape = tuple(
            d if a is None else d // self.mesh_shape[a]
            for d, a in zip(self.shape, self.spec))

    def indices(self, coords):
        """Per dim, the whole tensor's indices of this shard (None for a
        dim that is not split)."""
        out = []
        for d, (size, ax) in enumerate(zip(self.shape, self.spec)):
            if ax is None:
                out.append(None)
                continue
            n, c = self.mesh_shape[ax], coords[ax]
            if self.groups is not None and ax == "mp":
                idx, off = [], 0
                for g in self.groups:
                    k = g // n
                    idx.append(np.arange(off + c * k, off + (c + 1) * k))
                    off += g
                out.append(np.concatenate(idx))
            else:
                k = size // n
                out.append(np.arange(c * k, (c + 1) * k))
        return out

    def take(self, whole, coords):
        """This shard of the whole tensor, contiguous."""
        x = whole
        for d, idx in enumerate(self.indices(coords)):
            if idx is not None:
                x = x.index_select(d, torch.as_tensor(idx, device=x.device))
        return x.contiguous()

    def put(self, whole, shard, coords):
        """Write a shard into a whole numpy array."""
        sel = tuple(slice(None) if i is None else i
                    for i in self.indices(coords))
        whole[np.ix_(*[np.arange(s) if isinstance(i, slice) else i
                       for s, i in zip(self.shape, sel)])] = shard


class ParamPlan:
    """One parameter on the mesh: its ``layout``, the ``steps`` of its
    forward gather in order, each (dim, axis, reduce: the backward
    reduce-scatters over a data axis, or else takes the mp slice), and
    the data axes its gradient is still summed over after the backward
    (``remaining``)."""

    def __init__(self, layout, steps, remaining):
        self.layout = layout
        self.steps = steps
        self.remaining = remaining


def _leaf(name):
    m = re.match(r"(.*)\.(\w+)\.weight$", name)
    return (m.group(1), m.group(2)) if m else (None, None)


def _mp_split(config, specs, prefix, kind, mp):
    """Whether the attention (or MLP) module at `prefix` runs Megatron
    style: its heads (or FFN columns) split evenly over mp and the specs
    of all its projections put mp on their split dim."""
    if mp < 2:
        return False
    if kind == "attn":
        if config.num_attention_heads % mp or \
                config.num_key_value_heads % mp:
            return False
        names = _ATTN
    else:
        if config.intermediate_size % mp:
            return False
        names = _MLP
    seen = False
    for leaf in names:
        spec = specs.get(f"{prefix}.{leaf}.weight")
        if spec is None:
            continue
        seen = True
        dim = 1 if leaf in _COLUMN else 0
        if len(spec) <= dim or spec[dim] != "mp":
            return False
    return seen


def plan_params(config, shapes, specs, mesh_shape):
    """{name: ParamPlan} for a Llama model's parameters (``shapes`` and
    ``specs`` by name) on a mesh of ``mesh_shape``, and the set of module
    prefixes that run Megatron style."""
    split = set()
    for name in shapes:
        prefix, leaf = _leaf(name)
        if leaf in _ATTN or leaf in _MLP:
            kind = "attn" if leaf in _ATTN else "mlp"
            if _mp_split(config, specs, prefix, kind, mesh_shape["mp"]):
                split.add(prefix)
    plans = {}
    h, kvh = config.num_attention_heads, config.num_key_value_heads
    d = config.hidden_size // h
    for name, shape in shapes.items():
        spec = specs[name]
        prefix, leaf = _leaf(name)
        in_split = prefix in split
        groups = None
        if in_split and leaf == "qkv_proj":
            groups = (h * d, kvh * d, kvh * d)
        elif in_split and leaf == "gate_up_fused_proj":
            groups = (config.intermediate_size,) * 2
        layout = ParamLayout(shape, spec, mesh_shape, groups)
        data, model = [], []
        for dim, ax in enumerate(spec):
            if ax is None or (ax == "mp" and in_split):
                continue
            (data if ax in DATA_AXES else model).append(
                (dim, ax, ax in DATA_AXES))
        steps = data + model       # the gradient is reduce-scattered on
        #                            the smaller, mp-sliced tensor
        reduced = {ax for _, ax, r in steps if r}
        remaining = tuple(a for a in DATA_AXES
                          if mesh_shape[a] > 1 and a not in reduced
                          and a not in spec)
        plans[name] = ParamPlan(layout, steps, remaining)
    return plans, split


def owned(plan, mesh):
    """Whether this rank counts the parameter's shard once in a sum over
    the world: its coordinate is 0 on every axis the shard is
    replicated over."""
    return all(mesh.coords[a] == 0 for a in AXES
               if mesh.shape[a] > 1 and a not in plan.layout.spec)


# -- the autograd operators ------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, steps, dtype, stats):
        x = w if dtype is None else w.to(dtype)
        for dim, ax, _ in steps:
            parts = collective.all_gather([], x.contiguous(),
                                          group=mesh.groups[ax], axis=ax,
                                          stats=stats)
            x = torch.cat(parts, dim)
        ctx.args = (mesh, steps, w.dtype, stats)
        return x

    @staticmethod
    def backward(ctx, gy):
        mesh, steps, wdtype, stats = ctx.args
        g = gy.to(wdtype)
        for dim, ax, reduce in reversed(steps):
            n = mesh.shape[ax]
            if reduce:
                parts = [p.contiguous() for p in g.chunk(n, dim)]
                out = torch.empty_like(parts[0])
                g = collective.reduce_scatter(out, parts,
                                              group=mesh.groups[ax],
                                              axis=ax, stats=stats)
            else:
                g = g.chunk(n, dim)[mesh.coords[ax]].contiguous()
        return g, None, None, None, None


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, stats):
        ctx.args = (mesh, stats)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, stats = ctx.args
        g = g.contiguous().clone()
        collective.all_reduce(g, group=mesh.groups["mp"], axis="mp",
                              stats=stats)
        return g, None, None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, stats):
        y = x.contiguous().clone()
        return collective.all_reduce(y, group=mesh.groups["mp"], axis="mp",
                                     stats=stats)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MpRegion:
    """The Megatron operators of one module, bound to the mesh's mp
    group and the step's collective tally."""

    def __init__(self, mesh, stats):
        self.mesh, self.stats = mesh, stats

    def enter(self, x):
        return _CopyToMp.apply(x, self.mesh, self.stats)

    def leave(self, y):
        return _ReduceFromMp.apply(y, self.mesh, self.stats)


class _WeightBinding:
    """``module._shard_weight(w)``: the tensor a layer computes with, its
    float32 shard ``w`` cast to ``dtype`` (None keeps it) and gathered
    over the plan's steps."""

    def __init__(self, mesh, plan, dtype, stats):
        self.mesh, self.plan, self.dtype, self.stats = mesh, plan, dtype, \
            stats

    def __call__(self, w):
        return _Gather.apply(w, self.mesh, self.plan.steps, self.dtype,
                             self.stats)


@contextlib.contextmanager
def bound(model, mesh, plans, split, dtype, stats):
    """Within the block, every module of `model` whose weight's plan
    gathers it computes with the gathered weight (``_shard_weight``) and
    each module of `split` runs its Megatron operators (``_tp``); with no
    plans (one rank) nothing is bound. The model is left as it was after
    the block."""
    set_attrs = []
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            plan = plans.get(full)
            if pname == "weight" and plan is not None and plan.steps:
                mod._shard_weight = _WeightBinding(mesh, plan, dtype, stats)
                set_attrs.append((mod, "_shard_weight"))
        if mname in split:
            mod._tp = _MpRegion(mesh, stats)
            set_attrs.append((mod, "_tp"))
    try:
        yield
    finally:
        for mod, attr in set_attrs:
            mod.__dict__.pop(attr, None)


def reduce_grads(names, grads, plans, mesh, stats):
    """Sum each gradient over the data axes its plan leaves
    (``remaining``), one flat float32 all_reduce for each set of axes, in
    name order. Returns the list of gradients."""
    grads = list(grads)
    buckets = {}
    for i, n in enumerate(names):
        rem = plans[n].remaining if n in plans else ()
        if rem:
            buckets.setdefault(rem, []).append(i)
    for rem in sorted(buckets):
        axis = "data" if len(rem) == 2 else rem[0]
        idx = buckets[rem]
        flat = torch.cat([grads[i].reshape(-1).to(torch.float32)
                          for i in idx])
        collective.all_reduce(flat, group=mesh.groups[axis], axis=axis,
                              stats=stats)
        off = 0
        for i in idx:
            k = grads[i].numel()
            grads[i] = flat[off:off + k].view_as(grads[i])
            off += k
    return grads


def step_comm(plans, split, mesh_shape, tokens_local, hidden, act_bytes,
              compute_bytes, telemetry_groups=0):
    """The collectives of one training step on a rank, in closed form:
    {"op,axis": {"calls", "bytes"}} (payload bytes as the collectives
    count them: the whole gathered / scattered tensor, the all_reduced
    tensor). ``tokens_local`` the rank's B*S, ``act_bytes`` the
    activations' element size, ``compute_bytes`` the gathered weights'
    (2 under AMP-O2, else 4); the step runs without recompute."""
    out = {}

    def add(op, ax, calls, nbytes):
        row = out.setdefault(f"{op},{ax}", {"calls": 0, "bytes": 0})
        row["calls"] += calls
        row["bytes"] += int(nbytes)

    data = mesh_shape["dp"] * mesh_shape["fsdp"]
    world = int(np.prod([mesh_shape[a] for a in AXES]))
    if data > 1:
        add("all_reduce", "data", 2, 2 * 4)       # label count, loss
    for name, plan in plans.items():
        numel = int(np.prod(plan.layout.local_shape))
        for dim, ax, reduce in plan.steps:
            numel *= mesh_shape[ax]
            add("all_gather", ax, 1, numel * compute_bytes)
            if reduce:
                add("reduce_scatter", ax, 1, numel * 4)
    if mesh_shape["mp"] > 1:
        act = tokens_local * hidden * act_bytes
        add("all_reduce", "mp", 2 * len(split), 2 * len(split) * act)
    buckets = {}
    for plan in plans.values():
        if plan.remaining:
            buckets[plan.remaining] = buckets.get(plan.remaining, 0) + \
                int(np.prod(plan.layout.local_shape))
    for rem, numel in buckets.items():
        add("all_reduce", "data" if len(rem) == 2 else rem[0], 1, numel * 4)
    if world > 1:
        add("all_reduce", "world", 1, 8)           # the clip norm's sum
        if telemetry_groups:
            add("all_reduce", "world", 1, telemetry_groups * 4 * 8)
    return out
