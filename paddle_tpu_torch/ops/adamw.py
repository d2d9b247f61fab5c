"""AdamW with the global-norm clip over a list of tensors (kernel D of the
training step's fused tier, ``csrc/adamw.cu``).

The JAX package computes the update inside its jitted step, where XLA
fuses it (``paddle_tpu/models/pretrain.py:176-200``): no ``pallas_call``
stands behind it. Kernel contract, for T tensors:
  p, m, v   float32, updated in place
  g         float32, bfloat16 or float16, p's shape (upcast in registers)
  decay     the tensors that take weight decay (ndim >= 2 in the step)
  returns   gnorm, a 0-dim f32 on the card: sqrt of the sum of the
            tensors' squared f32 norms, each norm from an f64 sum
Launch 1 writes per-chunk sums of squares into a fixed workspace and its
last block reduces them in chunk order to gnorm and the clip scale
min(1, clip / (gnorm + 1e-6)) on the card (no host sync); launch 2
updates p, m and v with the plain version's op order and roundings
(``adamw_step_plain``, the foreach passes, as PyTorch's CUDA foreach
kernels round them: a fused multiply-add for each ``a + alpha * b``, a
product with the reciprocal for each division by a scalar). Up to 256
tensors take one launch of each.

``adamw_step`` launches the kernels for CUDA tensors (every kernel launch
counted in ``adamw_step.launches``: 2 a step up to 256 tensors) and runs
``adamw_step_plain`` for CPU tensors.

With ``groups`` (each tensor's telemetry group) and ``loss``, the same two
launches also compute the training step's packed telemetry vector (the
JAX package's ``_pack_telemetry``, ``paddle_tpu/models/pretrain.py:205-229``):
[loss, gnorm, then (grad_norm, param_norm, update_norm, nonfinite) per
group], the norms of the unclipped grads, of the parameters before the
update and of the update itself, summed in f64 on the card; those
launches also count in ``adamw_step.telemetry_launches``. p, m, v and
gnorm are bit-equal with and without it. ``pack_telemetry_plain`` is its
plain version: the CPU's route, and what the card is held against.
"""
import ctypes

import torch

from . import _launch as L

__all__ = ["adamw_step", "adamw_step_plain", "pack_telemetry_plain"]


def adamw_step_plain(ps, gs, ms, vs, decay, lr, b1, b2, eps, wd, clip,
                     count):
    """The update in plain PyTorch (``torch._foreach_*`` passes), the JAX
    package's math: grads scaled by min(1, clip / (gnorm + 1e-6)),
    bias-corrected moments with eps outside the square root, decoupled
    decay on the tensors flagged in ``decay``. ``count`` is the step's
    number (1 for the first). Updates ps, ms and vs in place; returns
    gnorm, a 0-dim f32 tensor."""
    gs = [g.to(torch.float32) for g in gs]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    if clip:
        scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        gs = torch._foreach_mul(gs, scale)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    denom = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(ms, c1)
    torch._foreach_div_(step, denom)
    if wd:
        idx = [i for i, d in enumerate(decay) if d]
        torch._foreach_add_([step[i] for i in idx], [ps[i] for i in idx],
                            alpha=wd)
    torch._foreach_add_(ps, step, alpha=-lr)
    return gnorm


def pack_telemetry_plain(loss, gnorm, gs, ps_old, ps_new, groups):
    """The packed telemetry vector in plain PyTorch: f32 [2 + 4 G] =
    [loss, gnorm, then per group (sqrt of the sum of g^2, of p_old^2, of
    (p_new - p_old)^2, the count of non-finite g)], each sum in f64 over
    the group's tensors in order (the difference rounded to f32 first);
    ``groups[i]`` is tensor i's group in [0, G), G = max(groups) + 1."""
    dev = gnorm.device
    acc = torch.zeros(max(groups) + 1, 4, dtype=torch.float64, device=dev)
    for j, g, p0, p1 in zip(groups, gs, ps_old, ps_new):
        g = g.to(torch.float32)
        acc[j, 0] += g.double().square().sum()
        acc[j, 1] += p0.double().square().sum()
        acc[j, 2] += (p1 - p0).double().square().sum()
        acc[j, 3] += (~torch.isfinite(g)).sum()
    rows = torch.cat([acc[:, :3].sqrt(), acc[:, 3:]], 1).to(torch.float32)
    head = torch.stack([loss.detach().reshape(()).to(torch.float32),
                        gnorm.reshape(()).to(torch.float32)])
    return torch.cat([head, rows.reshape(-1)])


_counters = {}    # device -> one zeroed uint32 the kernel leaves zeroed


def _counter(device):
    c = _counters.get(device)
    if c is None:
        c = _counters[device] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return c


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def adamw_step(ps, gs, ms, vs, decay, lr, b1, b2, eps, wd, clip, count,
               groups=None, loss=None):
    """``adamw_step_plain``'s update through kernel D for CUDA tensors (or
    the plain version for CPU ones); returns gnorm, a 0-dim f32 tensor, or
    (gnorm, the packed telemetry vector) when ``groups`` (tensor i's group;
    the vector has max(groups) + 1 of them) and ``loss`` (a 0-dim f32
    tensor) are given."""
    tel = groups is not None
    if tel:
        n_groups = max(groups) + 1 if groups else 0
        if len(groups) != len(ps) or loss is None:
            raise ValueError("adamw_step: telemetry needs a group for every "
                             "tensor and the loss")
    if not ps or not L.on_cuda("adamw_step", ps[0]):
        old = [p.clone() for p in ps] if tel else None
        gnorm = adamw_step_plain(ps, gs, ms, vs, decay, lr, b1, b2, eps, wd,
                                 clip, count)
        if not tel:
            return gnorm
        return gnorm, pack_telemetry_plain(loss, gnorm, gs, old, ps, groups)
    dev = ps[0].device
    gs = [g.contiguous() for g in gs]
    for p, g, m, v in zip(ps, gs, ms, vs):
        if p.dtype != torch.float32 or m.dtype != torch.float32 \
                or v.dtype != torch.float32 or g.dtype not in L.DTYPE_CODE \
                or not (p.shape == g.shape == m.shape == v.shape) \
                or any(t.device != dev or not t.is_contiguous()
                       for t in (p, g, m, v)):
            raise ValueError("adamw_step: p, m, v must be contiguous f32 "
                             "and g contiguous f32 / bf16 / f16 of p's "
                             f"shape, all on {dev}")
    if tel:
        most = L.entry("adamw", "adamw_max_groups")()
        if n_groups > most or min(groups) < 0:
            raise ValueError(f"adamw_step: telemetry groups must be ids in "
                             f"[0, {most}), got {sorted(set(groups))}")
        loss = loss.detach().reshape(1).to(device=dev, dtype=torch.float32)
    t = len(ps)
    n = (ctypes.c_longlong * t)(*(p.numel() for p in ps))
    gtype = (ctypes.c_int * t)(*(L.DTYPE_CODE[g.dtype] for g in gs))
    out = torch.empty(2, dtype=torch.float32, device=dev)
    chunk = L.entry("adamw", "adamw_chunk_elems")()
    chunks = sum(-(-p.numel() // chunk) for p in ps)
    if chunks == 0:
        gnorm = out.zero_()[0]
        if not tel:
            return gnorm
        return gnorm, pack_telemetry_plain(loss, gnorm, gs, ps, ps, groups)
    slots = L.entry("adamw", "adamw_ws_slots")() if tel else 2
    ws = torch.empty(slots * chunks, dtype=torch.float64, device=dev)
    stream = L.stream(ps[0])
    gp = _ptrs(gs)
    rc = L.entry("adamw", "adamw_sumsq")(
        t, gp, n, gtype, ws.data_ptr(), _counter(dev).data_ptr(),
        out.data_ptr(), float(clip or 0.0), int(tel), stream)
    L.raise_on("adamw_sumsq", rc)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    args = (t, _ptrs(ps), gp, _ptrs(ms), _ptrs(vs), n, gtype,
            (ctypes.c_int * t)(*(int(bool(d) and bool(wd)) for d in decay)))
    hyper = (float(b1), float(1 - b1), float(b2), float(1 - b2), 1.0 / c1,
             1.0 / c2, float(eps), float(wd or 0.0), float(-lr),
             int(bool(clip)))
    batches = -(-t // L.entry("adamw", "adamw_max_tensors")())
    vec = (torch.empty(2 + 4 * n_groups, dtype=torch.float32, device=dev)
           if tel else None)
    rc = L.entry("adamw", "adamw_update")(
        *args, (ctypes.c_int * t)(*groups) if tel else None, out.data_ptr(),
        *hyper, ws.data_ptr(), _counter(dev).data_ptr(),
        loss.data_ptr() if tel else None, vec.data_ptr() if tel else None,
        n_groups if tel else 0, stream)
    L.raise_on("adamw_update", rc)
    adamw_step.launches += 2 * batches
    if not tel:
        return out[0]
    adamw_step.telemetry_launches += 2 * batches
    return out[0], vec


adamw_step.launches = 0
adamw_step.telemetry_launches = 0
