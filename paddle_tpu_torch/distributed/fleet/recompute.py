"""Activation recompute for the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/recompute.py``).

The JAX package wraps the region in ``jax.checkpoint``; the port wraps it
in ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
region's activations are dropped after the forward and the region runs
again in the backward to rebuild them. The JAX package's named policies
map onto selective checkpointing
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``), which
keeps the outputs of the ATen ops a policy names and recomputes the rest:

  "dots", "dots_saveable"     keep aten.mm, addmm, bmm and _scaled_mm
  "dots_with_no_batch_dims"   the same without bmm
  "nothing", True, None       keep nothing (full recompute)
  "everything"                keep all: the region runs once, as without
                              recompute
A callable policy is taken as a selective-checkpoint policy function
``(ctx, op, *args, **kwargs) -> CheckpointPolicy``.

Selective checkpointing sees ATen ops only: the port's hand-written
kernels (launched through ctypes into buffers that ATen allocates) run
again in the recompute whatever the policy, and none of them writes into
a tensor that a policy keeps.

Three things the region must carry itself. A module is called with its
parameters as explicit inputs (``torch.func.functional_call``), so that
the recompute sees the tensors of the forward even when the forward ran
under another ``functional_call`` (the pretraining step's bf16 casts)
that has ended by the time the backward runs. And the port's default
seed chain (``core.random``), which ``torch.utils.checkpoint`` does not
stash, is replayed: the recompute starts from the chain's state at the
forward, so a dropout mask drawn in the region is drawn again the same.
And the amp context (``amp.auto_cast``, per thread, which the backward's
thread does not have) is replayed: the recompute runs under the
auto_cast stack of the forward, so it casts as the forward did.
"""
import functools

import torch
from torch.utils import checkpoint as _cp

from ...amp import _hook as _amp
from ...core import random as _random

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid",
           "policy_fn"]

_DOTS = ("mm", "addmm", "bmm", "_scaled_mm")
_NAMED = {
    "dots": _DOTS,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims": ("mm", "addmm", "_scaled_mm"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm", "_scaled_mm"),
    "nothing": (),
    "nothing_saveable": (),
}


def _ops(names):
    ops = set()
    for n in names:
        packet = getattr(torch.ops.aten, n, None)
        if packet is not None:
            ops.update(getattr(packet, o) for o in packet.overloads())
    return frozenset(ops)


def policy_fn(policy):
    """The selective-checkpoint policy function for ``policy`` (a name of
    the table above or a callable); None for full recompute.
    "everything" takes no checkpoint at all, so ``recompute`` returns
    before it asks for a policy."""
    if policy is None or policy is True or policy in ("nothing",
                                                      "nothing_saveable"):
        return None
    if callable(policy):
        return policy
    if policy not in _NAMED:
        raise ValueError(f"recompute: unknown policy {policy!r} (have "
                         f"{sorted(_NAMED) + ['everything']} or a "
                         "callable)")
    save = _ops(_NAMED[policy])

    def keep_dots(ctx, op, *args, **kwargs):
        return (_cp.CheckpointPolicy.MUST_SAVE if op in save
                else _cp.CheckpointPolicy.PREFER_RECOMPUTE)
    return keep_dots


def _replaying(fn):
    """``fn`` that, called a second time (the recompute), runs from the
    default seed chain's state at its first call, under the auto_cast
    stack of its first call, and then puts back the chain's state of that
    moment."""
    state = {}

    def run(*args, **kwargs):
        if "chain" not in state:
            state["chain"] = _random.get_state()
            state["amp"] = _amp.snapshot()
            return fn(*args, **kwargs)
        now = _random.get_state()
        _random.set_state(state["chain"])
        try:
            with _amp.restored(state["amp"]):
                return fn(*args, **kwargs)
        finally:
            _random.set_state(now)
    return run


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its activations;
    the backward runs it again to rebuild them. ``function`` may be a
    ``torch.nn.Module`` (its parameters get gradients) or a function of
    its tensor arguments. ``policy=`` names what to keep (module
    docstring); ``preserve_rng_state`` (default True) goes to
    ``torch.utils.checkpoint``, ``use_reentrant`` is taken and ignored
    (always False)."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    policy = kwargs.pop("policy", None)
    if policy in ("everything", "everything_saveable"):
        return function(*args, **kwargs)
    pol = policy_fn(policy)
    extra = {}
    if pol is not None:
        extra["context_fn"] = functools.partial(
            _cp.create_selective_checkpoint_contexts, pol)
    if isinstance(function, torch.nn.Module):
        names, tensors = [], []
        for n, p in function.named_parameters():
            names.append(n)
            tensors.append(p)
        module = function

        def region(params, *a, **kw):
            return torch.func.functional_call(
                module, dict(zip(names, params)), a, kw)
        return _cp.checkpoint(_replaying(region), tuple(tensors), *args,
                              use_reentrant=False,
                              preserve_rng_state=preserve, **extra,
                              **kwargs)
    return _cp.checkpoint(_replaying(function), *args, use_reentrant=False,
                          preserve_rng_state=preserve, **extra, **kwargs)


class _Chunk(torch.nn.Module):
    """A run of sublayers checkpointed as one unit: each takes the
    previous one's output (a tuple spreads into its arguments)."""

    def __init__(self, mods):
        super().__init__()
        self.mods = torch.nn.ModuleList(mods)

    def forward(self, *xs):
        for m in self.mods:
            xs = m(*xs) if isinstance(xs, tuple) else m(xs)
            if not isinstance(xs, tuple):
                xs = (xs,)
        return xs if len(xs) > 1 else xs[0]


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Segmented recompute over a sequence of layers: ``functions`` (a
    ``torch.nn.Sequential`` or a list of modules) is cut into
    ``ctx['segments']`` runs of ``len // segments`` layers, each run
    checkpointed as one unit."""
    segments = (ctx or {}).get("segments", 1)
    if isinstance(functions, torch.nn.Module):
        functions = list(functions.children())
    n = len(functions)
    seg_len = max(1, n // max(1, segments))
    out = args
    for i in range(0, n, seg_len):
        out = recompute(_Chunk(functions[i:i + seg_len]),
                        *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """Hybrid-parallel recompute: ``ctx['offload']`` would keep the
    region's inputs in host memory; like the JAX package where its
    runtime cannot offload, the port falls back to recompute with the
    caller's policy (full recompute by default), which also frees the
    device memory. ``ctx['partition']`` needs a model-parallel group,
    which one device does not have: the region runs as ``recompute``."""
    return recompute(function, *args, **kwargs)
