"""The MoE layer of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``; reference
python/paddle/incubate/distributed/models/moe/moe_layer.py:261).

Routing is the gate's index form (``gate.topk_capacity_route``): each
(token, choice) has an expert, a slot and a weight. The layer copies the
dispatched tokens into an [E, C, d] buffer (one ``index_copy``; a slot
nobody took stays zero), runs the experts on it, gathers each choice's
output row back and sums the k rows a token, weighted: the weights cast
to x's dtype, the products and their sum in f32, one rounding to x's
dtype (the JAX layer's dense ``combine`` einsum with f32 accumulation).
No [T, E, C] tensor is built.

Experts are an ``ExpertMLP`` (weights [E, d, F] / [E, F, d], one batched
matmul over the experts) or a ``torch.nn.ModuleList`` of per-expert
modules (``experts[e](buffer[e])``); the load-balance loss of the last
forward is ``.l_aux``, on the autograd graph.

Expert parallelism. The JAX layer is one program over every device: it
routes the whole batch and lets GSPMD split the [E, C, d] buffer over
the expert axis (or spells the exchange out in ``global_scatter`` /
``global_gather``). In the port every rank is a process (or, in tests, a
thread) with its own tokens: ``MoELayer(moe_group=g)`` (a
``torch.distributed`` group of P ranks) or ``MoELayer(mesh=m,
axis_name=a)`` (an axis of the port's ``Mesh``) holds E / P experts a
rank, routes the rank's own tokens over all E experts, sends each
expert's slots to the rank that holds it (``global_scatter``: [E, C, d]
-> [E / P, P * C, d], one ``all_to_all_single``), runs its experts over
every rank's slots and sends the outputs back (``global_gather``). Both
exchanges are ``autograd.Function``s whose backward is the inverse
exchange: 2 forward and 2 backward all_to_alls of E * C * d elements a
rank a step, tallied in ``stats`` as "all_to_all,<axis>". A rank's
output and input gradient equal the JAX layer's on that rank's tokens
alone; an expert's weight gradient is the sum over the ranks of the JAX
layer's gradients on each rank's tokens; with the same batch on every
rank each rank equals the JAX layer. E must divide by P. The experts
may be given whole (E of them: the layer keeps its rank's E / P, as the
JAX layer's ExpertMLP holds every expert) or as this rank's E / P
(the reference's local experts, with the gate's ``world_size``).

``moe_state_from_numpy`` loads the JAX layer's arrays (``gate.weight``,
``experts.w1`` ... or ``experts.{e}.{name}``), slicing the experts a
rank holds.
"""
import numpy as np
import torch

from .....distributed.fleet.context_parallel import _Axis, _exchange
from ....nn.functional import _gelu
from ....nn.layers import _Init
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, \
    _xavier_normal

__all__ = ["ExpertMLP", "MoELayer", "global_scatter", "global_gather",
           "moe_state_from_numpy"]

_ACTS = {"gelu": _gelu, "relu": torch.relu,
         "silu": torch.nn.functional.silu}


def _ep_axis(group=None, mesh=None, axis_name=None):
    """The axis from a ``torch.distributed`` group, or from an axis of a
    port ``Mesh`` (or a ProcessMesh over one); None without either."""
    if group is not None:
        return _Axis(group, group.size(), group.rank(), "ep")
    if mesh is None and axis_name is None:
        return None
    port = getattr(mesh, "mesh", None)
    if port is None and hasattr(mesh, "groups"):
        port = mesh
    if port is None or axis_name not in port.shape:
        raise ValueError(f"expert parallelism: axis {axis_name!r} needs a "
                         "port Mesh (make_mesh(..., group=)) or a "
                         "ProcessMesh over one")
    return _Axis(port.groups.get(axis_name), port.shape[axis_name],
                 port.coords[axis_name], axis_name)


def _scatter(x, axis, stats):
    e, c, d = x.shape
    p = axis.size
    out = _exchange(x.contiguous().reshape(p, e // p, c, d), axis, stats)
    return out.permute(1, 0, 2, 3).reshape(e // p, p * c, d)


def _gather(x, axis, stats):
    el, pc, d = x.shape
    p = axis.size
    parts = x.reshape(el, p, pc // p, d).permute(1, 0, 2, 3).contiguous()
    return _exchange(parts, axis, stats).reshape(el * p, pc // p, d)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, stats):
        ctx.args = (axis, stats)
        return _scatter(x, axis, stats)

    @staticmethod
    def backward(ctx, g):
        axis, stats = ctx.args
        return _gather(g, axis, stats), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, stats):
        ctx.args = (axis, stats)
        return _gather(x, axis, stats)

    @staticmethod
    def backward(ctx, g):
        axis, stats = ctx.args
        return _scatter(g, axis, stats), None, None


def _check_split(e, p):
    if e % p:
        raise ValueError(f"expert parallelism: {e} experts do not divide "
                         f"over {p} ranks")


def _exchange_axis(name, group, mesh, axis_name):
    axis = _ep_axis(group, mesh, axis_name)
    if axis is None:
        raise ValueError(f"{name} needs a group, or mesh and axis_name")
    return axis


def global_scatter(x, group=None, mesh=None, axis_name=None, stats=None):
    """Expert dispatch over the expert-parallel axis of P ranks: this
    rank's [E, C, d] slots -> [E / P, P * C, d], the slots of every rank
    (in rank order) for this rank's E / P experts. The JAX function's
    per-device block (its input is the [E, P * C, d] whole sharded on the
    capacity axis). Differentiable; one ``all_to_all_single`` (none on
    an axis of one rank)."""
    axis = _exchange_axis("global_scatter", group, mesh, axis_name)
    _check_split(x.shape[0], axis.size)
    return x if axis.size == 1 else _Scatter.apply(x, axis, stats)


def global_gather(x, group=None, mesh=None, axis_name=None, stats=None):
    """The inverse of ``global_scatter``: [E / P, P * C, d] -> this rank's
    [E, C, d]."""
    axis = _exchange_axis("global_gather", group, mesh, axis_name)
    return x if axis.size == 1 else _Gather.apply(x, axis, stats)


class ExpertMLP(torch.nn.Module):
    """Batched expert FFN: w1 [E, d, F], b1 [E, 1, F], w2 [E, F, d], b2
    [E, 1, d] (Xavier normal / zeros on ``device``), act(x @ w1 + b1) @ w2
    + b2 for each expert's rows of an [E, N, d] buffer; ``activation``
    gelu (the tanh form, as jax.nn.gelu), relu or silu."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 device="cuda", generator=None):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"ExpertMLP: activation {activation!r} not in "
                             f"{sorted(_ACTS)}")
        init = _Init(device, generator)
        self.num_experts = num_experts
        self.activation = activation
        self.w1 = _xavier_normal(init, [num_experts, d_model, d_hidden])
        self.b1 = init.const([num_experts, 1, d_hidden], 0.0)
        self.w2 = _xavier_normal(init, [num_experts, d_hidden, d_model])
        self.b2 = init.const([num_experts, 1, d_model], 0.0)

    def forward(self, buf):
        h = _ACTS[self.activation](torch.bmm(buf, self.w1) + self.b1)
        return torch.bmm(h, self.w2) + self.b2

    def _keep_local(self, start, count):
        """Keep experts [start, start + count) (this rank's)."""
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(self, name)
            setattr(self, name, torch.nn.Parameter(
                p.detach()[start:start + count].clone()))
        self.num_experts = count


def _count_experts(experts):
    return experts.num_experts if isinstance(experts, ExpertMLP) \
        else len(experts)


class MoELayer(torch.nn.Module):
    """Mixture-of-experts layer (reference moe_layer.py:261; module
    docstring). ``gate`` is a gate module, None (a NaiveGate of top_k)
    or the reference's config dict ({"type": "gshard" | "switch" |
    "naive", "top_k": k}); ``experts`` an ``ExpertMLP`` or a ModuleList.
    ``moe_group`` / ``mesh`` + ``axis_name`` switch on expert
    parallelism; ``stats`` (a dict) collects its exchanges.
    ``num_experts`` is the total count when the gate is built here and
    the experts given are a rank's share; a gate built here goes on
    ``device`` (default: the experts'). ``mp_group`` and
    ``recompute_interval`` are accepted as the JAX layer accepts them,
    without effect."""

    def __init__(self, d_model=None, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2,
                 num_experts=None, capacity_factor=1.25, mesh=None,
                 axis_name=None, device=None, generator=None, stats=None,
                 **kwargs):
        super().__init__()
        if isinstance(gate, dict):
            top_k = gate.get("top_k", top_k)
            gate_type = gate.get("type", "gshard")
            gate = None
        else:
            gate_type = "naive"
        if experts is None:
            raise ValueError("experts required (ExpertMLP or ModuleList)")
        if not isinstance(experts, (ExpertMLP, torch.nn.Module)):
            experts = torch.nn.ModuleList(experts)
        self.axis = _ep_axis(moe_group, mesh, axis_name)
        p = 1 if self.axis is None else self.axis.size
        given = _count_experts(experts)
        if gate is not None:
            total = gate.num_experts
        else:
            total = num_experts if num_experts is not None else given
        _check_split(total, p)
        local = total // p
        if given == total and p > 1:
            start = self.axis.index * local
            if isinstance(experts, ExpertMLP):
                experts._keep_local(start, local)
            else:
                experts = torch.nn.ModuleList(
                    list(experts)[start:start + local])
        elif given != local:
            raise ValueError(f"MoELayer: {given} experts given for {total} "
                             f"over {p} ranks (give all {total} or this "
                             f"rank's {local})")
        self.experts = experts
        self.num_experts = total
        self.num_local_experts = local
        self.recompute_interval = recompute_interval
        if d_model is None:
            if isinstance(experts, ExpertMLP):
                d_model = experts.w1.shape[1]
            elif gate is None:
                raise ValueError(
                    "d_model is required to build a gate when experts is a "
                    "ModuleList (it cannot be inferred)")
        if gate is None:
            cls = {"naive": NaiveGate, "switch": SwitchGate,
                   "gshard": GShardGate}[gate_type]
            if device is None:
                device = next(experts.parameters()).device
            gate = cls(d_model, total, top_k=top_k,
                       capacity_factor=capacity_factor, device=device,
                       generator=generator)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"MoELayer: gate {type(gate).__name__} is not a "
                            "BaseGate")
        self.gate = gate
        self.stats = stats
        self.l_aux = None

    def _experts(self, buf):
        if isinstance(self.experts, ExpertMLP):
            return self.experts(buf)
        return torch.stack([self.experts[j](buf[j])
                            for j in range(self.num_local_experts)])

    def forward(self, x):
        d = x.shape[-1]
        t = x.reshape(-1, d)
        n, e = t.shape[0], self.num_experts
        (expert, slot, weight, aux), cap = self.gate.route(t)
        k = expert.shape[1]
        # each choice's row of the [E * C] buffer; the undispatched ones
        # go to one spare row past the end, dropped before the experts
        row = torch.where(slot >= 0, expert * cap + slot,
                          torch.full_like(slot, e * cap)).reshape(-1)
        src = t[:, None, :].expand(n, k, d).reshape(n * k, d)
        buf = t.new_zeros(e * cap + 1, d).index_copy(0, row, src)
        buf = buf[:e * cap].reshape(e, cap, d)
        if self.axis is not None and self.axis.size > 1:
            out = _Gather.apply(
                self._experts(_Scatter.apply(buf, self.axis, self.stats)),
                self.axis, self.stats)
        else:
            out = self._experts(buf)
        out = torch.cat([out.reshape(e * cap, d), out.new_zeros(1, d)])
        picked = out.index_select(0, row).reshape(n, k, d)
        w = weight.to(x.dtype).to(torch.float32)
        y = (picked.to(torch.float32) * w[..., None]).sum(1)
        self.l_aux = aux.to(x.dtype)
        return y.to(x.dtype).reshape(x.shape)


def moe_state_from_numpy(layer, state):
    """Load the JAX MoE layer's arrays ({name: numpy array or object with
    ``.numpy()``}: "gate.weight" and "experts.w1" / "b1" / "w2" / "b2",
    or "experts.{e}.{param}" for ModuleList experts, the JAX layer's
    ``named_parameters`` names) into the port layer, in place, keeping
    each parameter's dtype and device. Under expert parallelism the
    rank's experts are sliced from the whole arrays. A
    ``torch.nn.Linear`` expert's weight is [out, in], Paddle's [in, out]:
    it takes the array transposed. Returns the layer."""
    def arr(key):
        v = state[key]
        return np.asarray(v.numpy() if hasattr(v, "numpy") else v)

    def put(p, a, transpose=False):
        a = torch.as_tensor(np.array(a.T if transpose else a))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"moe_state_from_numpy: shape "
                             f"{tuple(a.shape)} for {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(a.to(dtype=p.dtype, device=p.device))

    start = 0 if layer.axis is None else \
        layer.axis.index * layer.num_local_experts
    local = layer.num_local_experts
    put(layer.gate.weight, arr("gate.weight"))
    if isinstance(layer.experts, ExpertMLP):
        for name in ("w1", "b1", "w2", "b2"):
            put(getattr(layer.experts, name),
                arr(f"experts.{name}")[start:start + local])
    else:
        for j, mod in enumerate(layer.experts):
            for name, p in mod.named_parameters():
                put(p, arr(f"experts.{start + j}.{name}"),
                    isinstance(mod, torch.nn.Linear) and name == "weight")
    return layer
