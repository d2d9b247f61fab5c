"""The ZeRO sharding stages of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/sharding.py``; reference
DygraphShardingOptimizer, meta_parallel/sharding/group_sharded_stage{2,3}.py
and python/paddle/distributed/sharding/group_sharded.py:50), on the
sharding group of ``fleet.init``'s hybrid group (or a group the caller
passes).

The JAX package's rule splits a tensor on dim 0 over the sharding axis
when the axis divides it, and keeps it whole otherwise. The JAX arrays
are global; here each rank of the group holds its chunk:

- stage 1 (``DygraphShardingOptimizer``): the optimizer's state is
  created for this rank's dim-0 chunk of each splittable parameter. A
  step averages the gradients over the group (one flat all_reduce a
  dtype), the inner optimizer updates the rank's chunk of every
  parameter (a whole tensor where the rule keeps it whole, on every
  rank), and each split parameter is all_gathered back to whole;
- stage 2 (``GroupShardedStage2``): the gradients of split parameters
  are reduce_scattered (averaged) instead, so a rank reduces only its
  chunk;
- stage 3 (``GroupShardedStage3``): a split parameter holds only its
  chunk at rest. Before a module runs, its parameters are gathered
  through ``sharded._Gather`` (all_gather forward, reduce_scatter of the
  gradient backward, which autograd keeps for the backward), and the
  module gets its chunks back after; the port's Llama reads a weight
  through ``_weight`` (``_shard_weight``), which gathers it the same way.
  The optimizer (stage 2's) updates the chunks in place and gathers
  nothing.

Gradients are averaged over the group (each rank's batch is its own), as
``DataParallel`` averages over the data-parallel group. The clip norm and
the whole-tensor sums of ``Lamb`` / ``LarsMomentum`` / ``LBFGS`` count each
element once: a chunk on its rank, a whole tensor on rank 0 of the group,
the sum all_reduced over the group. ``state_dict`` returns whole tensors
(each state all_gathered), equal to the JAX optimizer's;
``set_state_dict`` takes whole ones. Every rank calls each of these: they
are collectives."""
import torch

from .. import collective
from .sharded import _Gather
from .topology import get_hcg

__all__ = ["DygraphShardingOptimizer", "GroupShardedStage2",
           "GroupShardedStage3", "group_sharded_parallel"]


def _sharding_group(hcg, group):
    if group is not None:
        return group
    hcg = hcg or get_hcg()
    if hcg is None:
        raise RuntimeError("call fleet.init first (or pass group=)")
    return hcg.get_sharding_parallel_group()


def _splits(shape, n):
    """The JAX rule: dim 0 split over n ranks when n divides it."""
    return len(shape) >= 1 and shape[0] % n == 0


def _stage3(p):
    return getattr(p, "_stage3", False)


class _AxisView:
    """The sharding group as a one-axis mesh for ``sharded._Gather``."""

    def __init__(self, group):
        self.groups = {"fsdp": group}
        self.shape = {"fsdp": group.size()}
        self.coords = {"fsdp": group.rank()}


class DygraphShardingOptimizer:
    """Stage 1 (or 2) of ZeRO around a port ``Optimizer``."""

    def __init__(self, optimizer, hcg=None, stage=1, group=None):
        self._inner = optimizer
        self._stage = stage
        self._group = _sharding_group(hcg, group)
        self._n, self._r = self._group.size(), self._group.rank()
        self.comm = {}          # the last step's collectives, "op,axis"

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _split(self, p):
        return not _stage3(p) and _splits(p.shape, self._n)

    def _sum(self, t):
        return collective.all_reduce(t, group=self._group, axis="fsdp",
                                     stats=self.comm)

    def _chunk(self, t):
        return t.chunk(self._n, 0)[self._r]

    def _averaged(self, pgs):
        """{id(p): this rank's averaged gradient of the tensor it
        updates}."""
        out, flat = {}, {}
        for p, g in pgs:
            if _stage3(p):                       # reduce_scattered sums
                out[id(p)] = g / self._n
            elif self._stage >= 2 and self._split(p):
                part = torch.empty_like(self._chunk(g))
                collective.reduce_scatter(
                    part, [c.contiguous() for c in g.chunk(self._n, 0)],
                    group=self._group, axis="fsdp", stats=self.comm)
                out[id(p)] = part.div_(self._n)
            else:
                flat.setdefault(g.dtype, []).append((p, g))
        for pairs in flat.values():
            buf = self._sum(torch.cat([g.reshape(-1) for _, g in pairs]))
            buf.div_(self._n)
            off = 0
            for p, g in pairs:
                whole = buf[off:off + g.numel()].view(g.shape)
                off += g.numel()
                out[id(p)] = self._chunk(whole) if self._split(p) else whole
        return out

    @torch.no_grad()
    def step(self):
        from ...optimizer.optimizer import _Item
        self.comm.clear()
        pgs = self._inner._params_grads()
        grads = self._averaged(pgs)
        items = []
        for p, _ in pgs:
            if self._split(p):
                items.append(_Item(p, self._chunk(p.detach()), grads[id(p)],
                                   True, self._sum))
            elif _stage3(p):
                items.append(_Item(p, p.detach(), grads[id(p)], True,
                                   self._sum))
            else:
                items.append(_Item(p, p.detach(), grads[id(p)],
                                   self._r == 0))
        self._inner._step_items(items, reduce=self._sum)
        for p, _ in pgs:
            if self._split(p):
                x = p.detach()
                collective.all_gather(list(x.chunk(self._n, 0)),
                                      self._chunk(x).clone(),
                                      group=self._group, axis="fsdp",
                                      stats=self.comm)

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def _sharded_params(self):
        return [(i, p) for i, p in enumerate(self._inner._parameter_list)
                if self._split(p) or _stage3(p)]

    def state_dict(self):
        """The inner optimizer's state with every chunk all_gathered to
        the whole tensor."""
        sd = self._inner.state_dict()
        for i, p in self._sharded_params():
            key = self._inner._key(i, p)
            for k, v in (self._inner._accumulators.get(id(p)) or {}).items():
                if isinstance(v, torch.Tensor) and v.dim() >= 1:
                    parts = collective.all_gather([], v.contiguous(),
                                                  group=self._group)
                    sd[f"{key}.{k}"] = torch.cat(parts, 0)
        return sd

    def set_state_dict(self, state):
        """Load whole tensors (``state_dict``'s form): each rank keeps its
        chunks."""
        state = dict(state)
        for i, p in self._sharded_params():
            x = p.detach() if _stage3(p) else self._chunk(p.detach())
            st = self._inner._state(p, x)
            key = self._inner._key(i, p)
            for k in st:
                v = state.get(f"{key}.{k}")
                if isinstance(v, torch.Tensor) and v.dim() >= 1:
                    state[f"{key}.{k}"] = self._chunk(v)
        return self._inner.set_state_dict(state)


class GroupShardedStage2(DygraphShardingOptimizer):
    def __init__(self, optimizer, hcg=None, group=None):
        super().__init__(optimizer, hcg, stage=2, group=group)


class GroupShardedStage3(torch.nn.Module):
    """``layer`` with its splittable parameters held as this rank's dim-0
    chunks, gathered for each module's forward (module docstring).
    ``state_dict`` / ``set_state_dict`` take whole tensors (collectives:
    every rank calls them)."""

    def __init__(self, layer, optimizer=None, hcg=None, sync_comm=False,
                 segment_size=2 ** 20, group=None):
        super().__init__()
        self._layer = layer
        self._optimizer = optimizer
        self._group = _sharding_group(hcg, group)
        self._n, self._r = self._group.size(), self._group.rank()
        self._axis = _AxisView(self._group)
        self.comm = {}
        self._whole = {}                   # id(param) -> whole shape
        with torch.no_grad():
            for _, p in layer.named_parameters():
                if _splits(p.shape, self._n) and not _stage3(p):
                    self._whole[id(p)] = tuple(p.shape)
                    p.data = p.data.chunk(self._n, 0)[self._r].clone()
                    p._stage3 = True
        for mod in layer.modules():
            names = [k for k, v in mod._parameters.items()
                     if v is not None and _stage3(v)]
            if not names:
                continue
            mod.register_forward_pre_hook(self._gather_hook(names))
            mod.register_forward_hook(self._release_hook(names),
                                      always_call=True)
            if "weight" in names:
                mod.__dict__["_shard_weight"] = self._bind

    def _gather(self, p):
        return _Gather.apply(p, self._axis, [(0, "fsdp", True)], None,
                             self.comm)

    def _bind(self, w):
        # a weight read outside its module's forward (``_weight``); one
        # the pre-hook swapped in is whole already
        return self._gather(w) if _stage3(w) else w

    def _gather_hook(self, names):
        def hook(mod, args):
            for k in names:
                p = mod._parameters[k]
                if _stage3(p):
                    mod._parameters[k] = self._gather(p)
                    mod.__dict__.setdefault("_stage3_params", {})[k] = p
        return hook

    def _release_hook(self, names):
        def hook(mod, args, out):
            held = mod.__dict__.pop("_stage3_params", {})
            for k, p in held.items():
                mod._parameters[k] = p
        return hook

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        sd = self._layer.state_dict(*args, **kwargs)
        params = dict(self._layer.named_parameters())
        for name, p in params.items():
            if id(p) in self._whole:
                parts = collective.all_gather([], p.detach().contiguous(),
                                              group=self._group)
                sd[name] = torch.cat(parts, 0)
        return sd

    def set_state_dict(self, state_dict, *args, **kwargs):
        params = dict(self._layer.named_parameters())
        sd = {k: (v.chunk(self._n, 0)[self._r]
                  if k in params and id(params[k]) in self._whole else v)
              for k, v in state_dict.items()}
        return self._layer.load_state_dict(sd, *args, **kwargs)

    load_state_dict = set_state_dict


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm=False):
    """The public API (reference group_sharded.py:50): ``level`` "os",
    "os_g" or "p_g_os" for stages 1 / 2 / 3 over ``group`` (default the
    hybrid group's sharding group); returns (model, optimizer, scaler).
    ``offload`` and the buffer sizes are accepted and change nothing, as
    in the JAX package. A ``scaler`` (``amp.GradScaler``) is made
    group-aware: its found-inf flag is all-reduced (MAX) over the
    sharding group before it is read, since each rank's gradients are its
    own before the step (the reference's ``GroupShardedScaler``)."""
    if level == "os":
        optimizer = DygraphShardingOptimizer(optimizer, stage=1, group=group)
    elif level == "os_g":
        optimizer = GroupShardedStage2(optimizer, group=group)
    elif level == "p_g_os":
        model = GroupShardedStage3(model, optimizer, group=group)
        optimizer = DygraphShardingOptimizer(optimizer, stage=2, group=group)
    else:
        raise ValueError(f"unknown level {level}")
    if scaler is not None:
        scaler._group = optimizer._group
    return model, optimizer, scaler
