"""MoE gates of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``; reference
python/paddle/incubate/distributed/models/moe/gate/ — naive_gate.py,
switch_gate.py, gshard_gate.py).

The JAX package routes into dense capacity-bucketed one-hot tensors
([tokens, experts, capacity]) because its traced graph needs static
shapes. The port routes into an INDEX form: for each (token, choice) its
expert, its slot in that expert's buffer (-1 where nothing was
dispatched) and its combine weight. ``topk_capacity_route`` computes it,
with the JAX package's order: the i-th choice of a token lands at its
position among the tokens that chose that expert as their i-th choice,
after every earlier choice's slots; a choice past the capacity is
dropped; a token whose every choice was dropped gets a zero combine row.
``topk_capacity_dispatch`` builds JAX's dense (combine, dispatch,
aux_loss) from it, for parity and for small shapes: at T = 16384, E = 8,
top-2 and capacity factor 1.25 the dense combine alone is 2.7 GB in f32,
which the MoE layer never holds.

The gates are ``torch.nn.Module``s with the JAX constructors' arguments
and the port's explicit ``device`` and ``generator`` (the weight's
Xavier-normal draw). ``SwitchGate``'s training jitter draws from the
gate's ``generator`` (or, when None, from the port's seed chain,
``core.random``): the JAX package draws it from its key chain, so the
two give different noise; parity holds with the jitter off (eval mode or
``switch_eps=0``).
"""
import math

import torch

from ....nn.layers import _Init
from .....core import random as _random
from .....core.random import make_generator
from .....nn.initializer import fan_in_out

__all__ = ["BaseGate", "NaiveGate", "SwitchGate", "GShardGate",
           "topk_capacity_route", "topk_capacity_dispatch"]


def _capacity(num_tokens, num_experts, top_k, capacity_factor):
    cap = int(capacity_factor * num_tokens * top_k / num_experts)
    return max(cap, 1)


def topk_capacity_route(probs, top_k, capacity):
    """The index form of the capacity-bucketed top-k routing of router
    probabilities ``probs`` [T, E]: (expert [T, k] int64, slot [T, k]
    int64, weight [T, k] in probs' dtype, aux_loss).

    ``slot`` is the choice's row in its expert's [capacity] buffer, -1
    where the choice was not dispatched (dropped past the capacity, or
    kept with a zero weight, as JAX's ``dispatch = combine > 0``);
    ``weight`` is the choice's gate probability over the sum of the
    token's kept ones (0 where dropped; a token with none kept has a
    zero row). ``aux_loss`` = E * sum_e f_e * P_e with f the share of
    first choices before the capacity drop and P the mean probability
    (GShard eq. (4)). Differentiable in ``probs``."""
    t, e = probs.shape
    dev = probs.device
    remaining = probs
    base = torch.zeros(e, dtype=torch.int64, device=dev)
    experts, positions, gates = [], [], []
    first = None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=1)                  # [T]
        onehot = torch.nn.functional.one_hot(idx, e)          # [T, E] int64
        if first is None:
            first = idx
        pos = onehot.cumsum(0).gather(1, idx[:, None])[:, 0] - 1 + base[idx]
        keep = pos < capacity
        base = base + (onehot * keep[:, None]).sum(0)
        g = probs.gather(1, idx[:, None])[:, 0] * keep.to(probs.dtype)
        experts.append(idx)
        positions.append(pos)
        gates.append(g)
        remaining = remaining * (1.0 - onehot.to(probs.dtype))
    denom = gates[0]
    for g in gates[1:]:
        denom = denom + g
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    weight = torch.stack([g / denom for g in gates], dim=1)
    expert = torch.stack(experts, dim=1)
    slot = torch.where(weight > 0, torch.stack(positions, dim=1),
                       torch.full_like(expert, -1))
    f = torch.bincount(first, minlength=e).to(probs.dtype) / t
    aux = e * torch.sum(f * probs.mean(dim=0))
    return expert, slot, weight, aux


def topk_capacity_dispatch(probs, top_k, capacity):
    """JAX's (combine [T, E, C], dispatch [T, E, C] bool, aux_loss) from
    router probabilities [T, E], built from ``topk_capacity_route``:
    combine[t, e, c] is the weight of token t's choice that went to slot
    c of expert e."""
    t, e = probs.shape
    expert, slot, weight, aux = topk_capacity_route(probs, top_k, capacity)
    live = slot >= 0
    rows = torch.arange(t, device=probs.device)[:, None].expand_as(slot)
    flat = (expert * capacity + slot.clamp_min(0))[live]
    combine = torch.zeros(t, e * capacity, dtype=probs.dtype,
                          device=probs.device)
    combine = combine.index_put((rows[live], flat), weight[live])
    combine = combine.reshape(t, e, capacity)
    return combine, combine > 0, aux


def _xavier_normal(init, shape):
    fi, fo = fan_in_out(shape)
    w = torch.empty(shape, dtype=torch.float32, device=init.device)
    return torch.nn.Parameter(w.normal_(0.0, math.sqrt(2.0 / (fi + fo)),
                                        generator=init.generator))


class BaseGate(torch.nn.Module):
    """A router's weight [d_model, num_experts] (Xavier normal on
    ``device`` from ``generator``, or from the seed chain when None) and
    its routing. ``route(x)`` gives the index form (``topk_capacity_route``
    at this gate's capacity for x's token count) and the capacity;
    ``routing(x, w=None)`` JAX's dense form."""

    def __init__(self, d_model, num_experts, top_k, capacity_factor=1.25,
                 device="cuda", generator=None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = _xavier_normal(_Init(device, generator),
                                     [d_model, num_experts])

    def capacity(self, num_tokens):
        return _capacity(num_tokens, self.num_experts, self.top_k,
                         self.capacity_factor)

    def probs(self, x, w=None):
        """Router probabilities [T, E] in f32 of tokens x [T, d]: the
        logits in x's dtype (x @ w), the softmax in f32."""
        logits = x @ (self.weight if w is None else w)
        return torch.softmax(logits.to(torch.float32), dim=-1)

    def route(self, x, w=None):
        """x [T, d] -> ((expert, slot, weight, aux_loss), capacity)."""
        cap = self.capacity(x.shape[0])
        return topk_capacity_route(self.probs(x, w), self.top_k, cap), cap

    def routing(self, x, w=None):
        """x [T, d] -> (combine [T, E, C], dispatch [T, E, C], aux_loss)."""
        return topk_capacity_dispatch(self.probs(x, w), self.top_k,
                                      self.capacity(x.shape[0]))


class NaiveGate(BaseGate):
    """Top-k softmax routing, no jitter (reference naive_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity_factor=1.25, device="cuda", generator=None):
        super().__init__(d_model, num_expert * world_size, top_k,
                         capacity_factor, device, generator)


class SwitchGate(BaseGate):
    """Top-1 routing with multiplicative jitter U(1 - eps, 1 + eps) on the
    logits in training (reference switch_gate.py; Switch Transformer
    §2.2), drawn from ``jitter_generator`` when set, else from the seed
    chain."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity_factor=1.25, device="cuda",
                 generator=None, jitter_generator=None):
        super().__init__(d_model, num_expert * world_size, 1,
                         capacity_factor, device, generator)
        self.switch_eps = switch_eps
        self.jitter_generator = jitter_generator

    def probs(self, x, w=None):
        logits = x @ (self.weight if w is None else w)
        if self.training and self.switch_eps > 0:
            gen = self.jitter_generator or make_generator(
                _random.fresh_seed(logits.device), logits.device)
            u = torch.rand(logits.shape, generator=gen,
                           device=logits.device, dtype=torch.float32)
            eps = self.switch_eps
            noise = (1.0 - eps) + u * (2.0 * eps)
            logits = logits * noise.to(logits.dtype)
        return torch.softmax(logits.to(torch.float32), dim=-1)


class GShardGate(BaseGate):
    """Top-k (default 2) routing with capacity and the load-balance loss
    (reference gshard_gate.py; GShard §3.2). The capacity factor is
    ``capacity_factor`` when given, else ``capacity[0]``."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), group=None, capacity_factor=None,
                 device="cuda", generator=None):
        cf = capacity_factor if capacity_factor is not None else capacity[0]
        super().__init__(d_model, num_expert * world_size, top_k, cf,
                         device, generator)
