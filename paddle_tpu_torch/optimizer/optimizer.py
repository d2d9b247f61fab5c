"""The optimizer base of the PyTorch port (counterpart of
``paddle_tpu/optimizer/optimizer.py``; reference
python/paddle/optimizer/optimizer.py:128), over torch Parameters and
their ``.grad``.

``parameters`` is ``module.parameters()``, ``module.named_parameters()``
(which names them) or a list of groups, dicts with ``"params"`` and
optionally ``"learning_rate"`` (a scale of the optimizer's rate) and
``"weight_decay"`` (the group's coefficient). A parameter's name is its
``named_parameters`` name, else its ``name`` attribute, else
``param_{i}`` by its place in the list, as the JAX package keys it.
Attributes the JAX Parameter carries are read when set on the torch
Parameter: ``optimize_attr["learning_rate"]`` scales its rate and
``need_clip`` False keeps it out of the clip.

State is created at a parameter's first update: the optimizer's
accumulators (float32, the shape of the tensor it updates) and, under
``multi_precision``, a float32 ``master`` copy of a bf16 / fp16
parameter; the update runs on the master and writes the parameter back
as round(master). ``step`` clips (``grad_clip``), counts the step and
updates every parameter with a gradient, in place.

The step's unit is an item: the parameter, the tensor it updates (the
parameter's data, or under the ZeRO stages this rank's dim-0 chunk of
it), its gradient of that shape and whether this rank counts it once in
a sum over ranks. ``_step_items(items, reduce)`` is what
``step`` runs and what ``distributed.fleet.sharding`` calls with the
chunks; ``reduce`` (an in-place all_reduce over the ranks holding the
chunks) makes norms and dot products whole-tensor ones.

``optimizer_state_from_numpy`` / ``optimizer_state_to_numpy`` carry the
state across from and to the JAX optimizer's ``state_dict``.
"""
import numpy as np
import torch

from ..nn.clip import ClipGradByGlobalNorm
from .lr import LRScheduler

__all__ = ["Optimizer", "optimizer_state_from_numpy",
           "optimizer_state_to_numpy"]


def f32(x):
    """x rounded to float32, as a Python float (a torch op takes it as
    that f32 value exactly)."""
    return float(np.float32(x))


class _Item:
    """One tensor of a step: ``p`` the parameter (its name and
    attributes), ``x`` the tensor updated in place, ``g`` its gradient,
    ``owned`` whether this rank counts it in a sum over ranks, ``reduce``
    the in-place all_reduce making a sum over ``x`` a whole-tensor one
    (None where ``x`` is the whole tensor)."""

    __slots__ = ("p", "x", "g", "owned", "reduce")

    def __init__(self, p, x, g, owned=True, reduce=None):
        self.p, self.x, self.g = p, x, g
        self.owned, self.reduce = owned, reduce

    def total(self, t):
        """The sum of ``t`` (``x``'s shape) over the whole tensor, a 0-dim
        f32 tensor."""
        s = t.sum().reshape(1)
        if self.reduce is not None:
            s = self.reduce(s)
        return s[0]


def _refuse_sparse(g):
    if g.is_sparse or g.layout != torch.strided:
        raise NotImplementedError(
            "optimizer: sparse (SelectedRows) gradients come with the "
            "port's sparse package (ROADMAP Queue 1 item 10)")
    return g


class Optimizer:
    # Adam / AdamW: the update (and a global-norm clip) on kernel D's eager
    # form, ``_update`` overridden
    _kernel_update = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph mode)")
        self._parameter_list, self._names, self._groups = [], {}, {}
        self._parse_parameters(parameters)
        self._lr = learning_rate
        self._lr_scheduler = (learning_rate
                              if isinstance(learning_rate, LRScheduler)
                              else None)
        self.regularization = weight_decay
        self._weight_decay = _coeff(weight_decay, 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators = {}       # id(param) -> {state name: tensor}
        self._step_count = 0
        self._last_grad_norm = None   # kernel D's gnorm of the last step

    def _parse_parameters(self, parameters):
        entries = list(parameters)
        groups = entries if entries and isinstance(entries[0], dict) \
            else [{"params": entries}]
        for group in groups:
            for e in group["params"]:
                if isinstance(e, tuple) and len(e) == 2 \
                        and isinstance(e[0], str):
                    name, p = e
                else:
                    name, p = getattr(e, "name", None), e
                if id(p) in self._groups:
                    continue
                self._parameter_list.append(p)
                self._names[id(p)] = name
                self._groups[id(p)] = group

    # -- lr --------------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._lr)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler

    def _lr_scale(self, p):
        """optimize_attr's rate times the parameter group's."""
        attr = getattr(p, "optimize_attr", None) or {}
        return attr.get("learning_rate", 1.0) * self._groups.get(
            id(p), {}).get("learning_rate", 1.0)

    def _wd_of(self, p, default):
        group = self._groups.get(id(p), {})
        return _coeff(group["weight_decay"], default) \
            if "weight_decay" in group else default

    def _key(self, i, p):
        return self._names.get(id(p)) or f"param_{i}"

    # -- state -----------------------------------------------------------
    def _state(self, p, like=None):
        """p's state, created at first use in the shape of ``like`` (the
        tensor the update writes; p itself by default)."""
        st = self._accumulators.get(id(p))
        if st is None:
            like = p.detach() if like is None else like
            st = self._create_state(like)
            if self._multi_precision and like.dtype in (torch.bfloat16,
                                                        torch.float16):
                st["master"] = like.to(torch.float32, copy=True)
            self._accumulators[id(p)] = st
        return st

    def _create_state(self, x):
        return {}

    def state_dict(self):
        out = {"@step": self._step_count}
        if self._lr_scheduler is not None:
            out["@lr"] = self._lr_scheduler.state_dict()
        for i, p in enumerate(self._parameter_list):
            st = self._accumulators.get(id(p))
            if st:
                key = self._key(i, p)
                for k, v in st.items():
                    out[f"{key}.{k}"] = v
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        if self._lr_scheduler is not None and "@lr" in state:
            self._lr_scheduler.set_state_dict(dict(state["@lr"]))
        for i, p in enumerate(self._parameter_list):
            key = self._key(i, p)
            st = self._state(p)
            for k in list(st):
                full = f"{key}.{k}"
                if full in state:
                    st[k] = _like(state[full], st[k])

    # -- stepping --------------------------------------------------------
    def _params_grads(self):
        return [(p, _refuse_sparse(p.grad)) for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self):
        self._step_items([_Item(p, p.detach(), g)
                          for p, g in self._params_grads()])

    def _step_items(self, items, reduce=None):
        """Clip, count the step and update ``items`` (``_Item``s);
        ``reduce`` the all_reduce over the ranks holding chunks."""
        clip = self._grad_clip
        in_kernel = self._kernel_update and isinstance(
            clip, ClipGradByGlobalNorm)
        if clip is not None and not in_kernel:
            clipped = clip._clip([(it.p, it.g) for it in items],
                                 [it.owned for it in items], reduce)
            for it, (_, g) in zip(items, clipped):
                it.g = g
        self._step_count += 1
        self._update(items, self.get_lr(), clip if in_kernel else None,
                     reduce)

    def _update(self, items, lr, clip, reduce):
        for it in items:
            self._apply_one(it, self._state(it.p, it.x),
                            lr * self._lr_scale(it.p))

    def _apply_one(self, it, st, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, self._params_grads()

    # -- helpers of the updates -------------------------------------------
    @staticmethod
    def _base(it, st):
        """The f32 values the update starts from: the master, or x."""
        m = st.get("master")
        return m if m is not None else it.x.to(torch.float32)

    def _l2(self, it, g, st):
        """The coupled L2 term of the SGD family: g + wd * base in f32."""
        wd = self._wd_of(it.p, self._weight_decay)
        if wd:
            return g.to(torch.float32) + f32(wd) * self._base(it, st)
        return g

    @staticmethod
    def _write_back(it, st, new):
        if "master" in st:
            st["master"].copy_(new)
        it.x.copy_(new)


def _coeff(weight_decay, default):
    """A float coefficient, or an L2Decay-style object's ``coeff``."""
    if weight_decay is None:
        return default
    if isinstance(weight_decay, (int, float)) \
            and not isinstance(weight_decay, bool):
        return float(weight_decay)
    return float(getattr(weight_decay, "coeff", default))


def _like(value, ref):
    """``value`` (a tensor, numpy array or list) as a tensor of ``ref``'s
    dtype and device; non-tensor state (LBFGS's history) as it is."""
    if not isinstance(ref, torch.Tensor):
        return value
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(
            value.numpy() if hasattr(value, "numpy") else value))
    return value.to(device=ref.device, dtype=ref.dtype).clone()


def optimizer_state_from_numpy(optimizer, state, names=None):
    """Load the JAX optimizer's ``state_dict()`` (values numpy arrays or
    objects with ``.numpy()``) into ``optimizer``, matched by parameter
    order: the JAX key of the port's parameter i is ``names[i]`` when
    given, else ``param_{i}`` (the JAX package's key of an unnamed
    parameter). ``@step`` and ``@lr`` carry over as they are."""
    out = {k: state[k] for k in ("@step", "@lr") if k in state}
    for i, p in enumerate(optimizer._parameter_list):
        jkey = names[i] if names is not None else f"param_{i}"
        key = optimizer._key(i, p)
        for full, v in state.items():
            if full.startswith(jkey + "."):
                out[f"{key}.{full[len(jkey) + 1:]}"] = v
    optimizer.set_state_dict(out)
    return optimizer


def optimizer_state_to_numpy(optimizer):
    """The optimizer's ``state_dict()`` with every tensor as a float32 or
    integer numpy array (the JAX state_dict's keys)."""
    out = {}
    for k, v in optimizer.state_dict().items():
        out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else v
    return out
