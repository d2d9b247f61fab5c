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

The eager form (``adamw_eager``; its plain version ``adamw_eager_plain``)
is the step of the eager optimizer (``optimizer.Adam`` / ``AdamW``): the
JAX package's ``paddle_tpu/optimizer/optimizers.py`` ``_adamw_update`` /
``_adam_update`` (Adam with ``_l2``'s coupled term) after
``nn/clip.py`` ``ClipGradByGlobalNorm``, in two launches counted in
``adamw_eager.launches``: the parameter in f32 / bf16 / f16 or its f32
master with the parameter written as round(master), grads of any of the
three dtypes (the clipped grad rounded back to its dtype), a rate and a
decay a tensor, need_clip flags, and the clip scale
min(clip / max(gnorm, 1e-12), 1). Its ``owned`` / ``reduce`` split is the
mesh form's.

On the training mesh (``owned`` and ``reduce`` given) each rank holds
shards and the norm is global: launch 1 writes the sum of squares of the
grads of the tensors this rank ``owned`` (a shard replicated over ranks
is owned by one of them), ``reduce`` all_reduces it over the ranks in
place, and launch 2 takes gnorm = sqrt(global sum) and the clip scale
from it. With the telemetry, launch 2 leaves the groups' raw f64 sums,
``reduce`` sums them over the ranks, and the square roots are taken
after. The plain versions take the same split.
"""
import ctypes

import numpy as np
import torch

from . import _launch as L
from . import work as _work

__all__ = ["adamw_step", "adamw_step_plain", "pack_telemetry_plain",
           "adamw_eager", "adamw_eager_plain"]


def adamw_step_plain(ps, gs, ms, vs, decay, lr, b1, b2, eps, wd, clip,
                     count, owned=None, reduce=None):
    """The update in plain PyTorch (``torch._foreach_*`` passes), the JAX
    package's math: grads scaled by min(1, clip / (gnorm + 1e-6)),
    bias-corrected moments with eps outside the square root, decoupled
    decay on the tensors flagged in ``decay``. ``count`` is the step's
    number (1 for the first). Updates ps, ms and vs in place; returns
    gnorm, a 0-dim f32 tensor. The mesh form (``reduce`` given): gnorm is
    the square root of the f64 sum of squares of the ``owned`` tensors,
    all_reduced by ``reduce`` (in place) first."""
    gs = [g.to(torch.float32) for g in gs]
    if reduce is None:
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(gs)))
    else:
        gnorm = reduce(_owned_sumsq(gs, owned)).sqrt().to(torch.float32)[0]
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


def _owned_sumsq(gs, owned):
    """[1] f64: the sum of squares of the owned tensors."""
    acc = torch.zeros(1, dtype=torch.float64, device=gs[0].device)
    for g, own in zip(gs, owned):
        if own:
            acc += g.double().square().sum()
    return acc


def pack_telemetry_plain(loss, gnorm, gs, ps_old, ps_new, groups,
                         owned=None, reduce=None):
    """The packed telemetry vector in plain PyTorch: f32 [2 + 4 G] =
    [loss, gnorm, then per group (sqrt of the sum of g^2, of p_old^2, of
    (p_new - p_old)^2, the count of non-finite g)], each sum in f64 over
    the group's tensors in order (the difference rounded to f32 first);
    ``groups[i]`` is tensor i's group in [0, G), G = max(groups) + 1. The
    mesh form: only the ``owned`` tensors count, and ``reduce`` sums the
    [G, 4] f64 sums over the ranks before the square roots."""
    dev = gnorm.device
    acc = torch.zeros(max(groups) + 1, 4, dtype=torch.float64, device=dev)
    for i, (j, g, p0, p1) in enumerate(zip(groups, gs, ps_old, ps_new)):
        if owned is not None and not owned[i]:
            continue
        g = g.to(torch.float32)
        acc[j, 0] += g.double().square().sum()
        acc[j, 1] += p0.double().square().sum()
        acc[j, 2] += (p1 - p0).double().square().sum()
        acc[j, 3] += (~torch.isfinite(g)).sum()
    if reduce is not None:
        reduce(acc)
    return _pack(loss, gnorm, acc)


def _pack(loss, gnorm, acc):
    """The packed vector from the groups' [G, 4] f64 sums."""
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
               groups=None, loss=None, owned=None, reduce=None):
    """``adamw_step_plain``'s update through kernel D for CUDA tensors (or
    the plain version for CPU ones); returns gnorm, a 0-dim f32 tensor, or
    (gnorm, the packed telemetry vector) when ``groups`` (tensor i's group;
    the vector has max(groups) + 1 of them) and ``loss`` (a 0-dim f32
    tensor) are given. ``owned`` (a flag a tensor) and ``reduce`` (an
    in-place all_reduce over the ranks) run the mesh form."""
    tel = groups is not None
    mesh = reduce is not None
    if mesh and (owned is None or len(owned) != len(ps)):
        raise ValueError("adamw_step: the mesh form needs an owned flag for "
                         "every tensor")
    if tel:
        n_groups = max(groups) + 1 if groups else 0
        if len(groups) != len(ps) or loss is None:
            raise ValueError("adamw_step: telemetry needs a group for every "
                             "tensor and the loss")
    if not ps or not L.on_cuda("adamw_step", ps[0]):
        old = [p.clone() for p in ps] if tel else None
        gnorm = adamw_step_plain(ps, gs, ms, vs, decay, lr, b1, b2, eps, wd,
                                 clip, count, owned, reduce)
        if not tel:
            return gnorm
        return gnorm, pack_telemetry_plain(loss, gnorm, gs, old, ps, groups,
                                           owned, reduce)
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
    if chunks == 0 and mesh:
        raise ValueError("adamw_step: the mesh form needs a tensor with "
                         "elements on every rank")
    if chunks == 0:
        gnorm = out.zero_()[0]
        if not tel:
            return gnorm
        return gnorm, pack_telemetry_plain(loss, gnorm, gs, ps, ps, groups)
    slots = L.entry("adamw", "adamw_ws_slots")() if tel else 2
    ws = torch.empty(slots * chunks, dtype=torch.float64, device=dev)
    stream = L.stream(ps[0])
    gp = _ptrs(gs)
    own = (ctypes.c_int * t)(*(int(bool(o)) for o in owned)) if mesh \
        else None
    total = torch.empty(1, dtype=torch.float64, device=dev) if mesh \
        else None
    rc = L.entry("adamw", "adamw_sumsq")(
        t, gp, n, gtype, ws.data_ptr(), _counter(dev).data_ptr(),
        out.data_ptr(), float(clip or 0.0), int(tel), own,
        total.data_ptr() if mesh else None, stream)
    L.raise_on("adamw_sumsq", rc)
    if mesh:
        reduce(total)           # the global sum of squares, in place
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    args = (t, _ptrs(ps), gp, _ptrs(ms), _ptrs(vs), n, gtype,
            (ctypes.c_int * t)(*(int(bool(d) and bool(wd)) for d in decay)))
    hyper = (float(b1), float(1 - b1), float(b2), float(1 - b2), 1.0 / c1,
             1.0 / c2, float(eps), float(wd or 0.0), float(-lr),
             int(bool(clip)))
    batches = -(-t // L.entry("adamw", "adamw_max_tensors")())
    vec = (torch.empty(2 + 4 * n_groups, dtype=torch.float32, device=dev)
           if tel and not mesh else None)
    raw = (torch.empty(n_groups, 4, dtype=torch.float64, device=dev)
           if tel and mesh else None)
    rc = L.entry("adamw", "adamw_update")(
        *args, (ctypes.c_int * t)(*groups) if tel else None, out.data_ptr(),
        *hyper, ws.data_ptr(), _counter(dev).data_ptr(),
        loss.data_ptr() if tel else None,
        vec.data_ptr() if vec is not None else None,
        n_groups if tel else 0, own, total.data_ptr() if mesh else None,
        float(clip or 0.0), raw.data_ptr() if raw is not None else None,
        stream)
    L.raise_on("adamw_update", rc)
    adamw_step.launches += 2 * batches
    if _work.counting():
        _work.note("adamw", sum(_work.adamw(p.numel(), g.element_size())[0]
                                for p, g in zip(ps, gs)), 0)
    if not tel:
        return out[0]
    adamw_step.telemetry_launches += 2 * batches
    if raw is not None:
        vec = _pack(loss[0], out[0], reduce(raw))
    return out[0], vec


adamw_step.launches = 0
adamw_step.telemetry_launches = 0


# -- the eager form -------------------------------------------------------

def _eager_scalars(b1, b2, eps, count):
    """The step's f32 scalars as jnp takes them: (b1, 1 - b1, b2, 1 - b2,
    1 - b1^t, 1 - b2^t, eps), each operation rounded to f32."""
    f = np.float32
    b1, b2, t = f(b1), f(b2), f(count)
    return (b1, f(1) - b1, b2, f(1) - b2, f(1) - b1 ** t, f(1) - b2 ** t,
            f(eps))


def _eager_wds(wd, n):
    """Each tensor's weight decay: ``wd`` a number (or None) for all, or a
    sequence of one a tensor."""
    if wd is None or isinstance(wd, (int, float)):
        return [float(wd or 0.0)] * n
    wds = [float(w or 0.0) for w in wd]
    if len(wds) != n:
        raise ValueError("adamw_eager: one weight decay a tensor")
    return wds


def _eager_keep(mode, lrs, decay, wds):
    """AdamW's 1 - lr wd (f32) for each decayed tensor, else 1."""
    f = np.float32
    return [f(1) - f(lr) * f(w) if mode == "adamw" and d and w else f(1)
            for lr, d, w in zip(lrs, decay, wds)]


def _eager_flags(n, clip_flags, owned):
    clip_flags = [True] * n if clip_flags is None else list(clip_flags)
    owned = [True] * n if owned is None else list(owned)
    if len(clip_flags) != n or len(owned) != n:
        raise ValueError("adamw_eager: clip_flags and owned need a flag for "
                         "every tensor")
    return clip_flags, owned


def adamw_eager_plain(ps, gs, ms, vs, lrs, decay, b1, b2, eps, wd, count,
                      mode="adamw", clip=None, clip_flags=None, outs=None,
                      owned=None, reduce=None):
    """The eager optimizer's AdamW / Adam step with the global-norm clip in
    plain PyTorch, the JAX package's expressions op by op (one rounding an
    operation, true divisions by 0-dim f32 tensors):

    * gnorm = sqrt of the f64 sum of g^2 over the tensors flagged in both
      ``clip_flags`` (need_clip) and ``owned``, rounded to f32; the mesh
      form all_reduces the [1] f64 sum with ``reduce`` (in place) first;
    * ``clip`` (a float) scales the flagged grads by
      min(clip / max(gnorm, 1e-12), 1) and rounds them back to the grad's
      dtype (``paddle_tpu/nn/clip.py:91-102``);
    * ``mode`` "adam" adds wd * p to the grads of the ``decay`` tensors
      (``optimizer.py`` ``_l2``); "adamw" decays p by 1 - lr wd
      (``optimizers.py:35-42``); ``wd`` a number, or one a tensor;
    * m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 and
      p = p (1 - lr wd) - lr (m / c1) / (sqrt(v / c2) + eps) with
      c1 = 1 - b1^t, c2 = 1 - b2^t in f32 and ``lrs`` each tensor's lr.

    ``ps`` are the f32 masters or the parameters themselves (f32 / bf16 /
    f16), updated in place; ``outs`` (None, or a tensor or None a tensor)
    the parameters written as round(p) where ``ps`` holds a master. ms, vs
    f32 in place. Returns gnorm, a 0-dim f32 tensor."""
    n = len(ps)
    clip_flags, owned = _eager_flags(n, clip_flags, owned)
    dev = ps[0].device if ps else torch.device("cpu")
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for g, c, o in zip(gs, clip_flags, owned):
        if c and o:
            total = total + g.double().square().sum()
    if reduce is not None:
        total = reduce(total.reshape(1))[0]
    gnorm = total.sqrt().to(torch.float32)
    scale = None
    if clip:
        den = gnorm.clamp_min(1e-12)          # NaN stays NaN
        scale = torch.div(torch.full_like(gnorm, clip), den).clamp(max=1.0)

    def s(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    b1, omb1, b2, omb2, c1, c2, eps_ = (
        s(x) for x in _eager_scalars(b1, b2, eps, count))
    wds = _eager_wds(wd, n)
    keep = _eager_keep(mode, lrs, decay, wds)
    for i in range(n):
        g = gs[i]
        gf = g.to(torch.float32)
        if scale is not None and clip_flags[i]:
            gf = torch.mul(gf, scale).to(g.dtype).to(torch.float32)
        base = ps[i].to(torch.float32)
        if mode == "adam" and decay[i] and wds[i]:
            gf = torch.add(gf, torch.mul(s(np.float32(wds[i])), base))
        m = torch.add(torch.mul(b1, ms[i]), torch.mul(omb1, gf))
        v = torch.add(torch.mul(b2, vs[i]),
                      torch.mul(omb2, torch.mul(gf, gf)))
        denom = torch.add(torch.sqrt(torch.div(v, c2)), eps_)
        upd = torch.div(torch.mul(s(np.float32(lrs[i])), torch.div(m, c1)),
                        denom)
        new = torch.sub(torch.mul(base, s(keep[i])), upd)
        ms[i].copy_(m)
        vs[i].copy_(v)
        ps[i].copy_(new)
        if outs is not None and outs[i] is not None:
            outs[i].copy_(new)
    return gnorm


def adamw_eager(ps, gs, ms, vs, lrs, decay, b1, b2, eps, wd, count,
                mode="adamw", clip=None, clip_flags=None, outs=None,
                owned=None, reduce=None):
    """``adamw_eager_plain``'s step through kernel D's eager form for CUDA
    tensors (two launches up to 256 tensors, counted in
    ``adamw_eager.launches``), the plain version for CPU ones. Same
    arguments; every tensor contiguous on one device, g, p and the outs
    f32 / bf16 / f16, m and v f32 of p's shape. Returns gnorm."""
    if mode not in ("adamw", "adam"):
        raise ValueError(f"adamw_eager: mode must be 'adamw' or 'adam', got "
                         f"{mode!r}")
    if not ps or not L.on_cuda("adamw_eager", ps[0]):
        return adamw_eager_plain(ps, gs, ms, vs, lrs, decay, b1, b2, eps,
                                 wd, count, mode, clip, clip_flags, outs,
                                 owned, reduce)
    t = len(ps)
    clip_flags, owned = _eager_flags(t, clip_flags, owned)
    outs = [None] * t if outs is None else list(outs)
    dev = ps[0].device
    for p, g, m, v, o in zip(ps, gs, ms, vs, outs):
        ok = (p.dtype in L.DTYPE_CODE and g.dtype in L.DTYPE_CODE
              and m.dtype == v.dtype == torch.float32
              and p.shape == g.shape == m.shape == v.shape
              and (o is None or (o.dtype in L.DTYPE_CODE
                                 and o.shape == p.shape)))
        if not ok or any(x.device != dev or not x.is_contiguous()
                         for x in (p, g, m, v) + (() if o is None else (o,))):
            raise ValueError("adamw_eager: p, g and out must be contiguous "
                             "f32 / bf16 / f16 and m, v contiguous f32, all "
                             f"of p's shape on {dev}")
    mesh = reduce is not None
    chunk = L.entry("adamw", "adamw_chunk_elems")()
    chunks = sum(-(-p.numel() // chunk) for p in ps)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if chunks == 0 and mesh:
        raise ValueError("adamw_eager: the mesh form needs a tensor with "
                         "elements on every rank")
    if chunks == 0:
        return out.zero_()[0]
    ints = ctypes.c_int * t
    n = (ctypes.c_longlong * t)(*(p.numel() for p in ps))
    gtype = ints(*(L.DTYPE_CODE[g.dtype] for g in gs))
    wds = _eager_wds(wd, t)
    flags = ints(*((1 if d and w else 0) | (2 if c else 0)
                   | (4 if c and o else 0)
                   for d, w, c, o in zip(decay, wds, clip_flags, owned)))
    ws = torch.empty(2 * chunks, dtype=torch.float64, device=dev)
    total = torch.empty(1, dtype=torch.float64, device=dev) if mesh \
        else None
    stream = L.stream(ps[0])
    gp = _ptrs(gs)
    rc = L.entry("adamw", "adamw_eager_sumsq")(
        t, gp, n, gtype, flags, ws.data_ptr(), _counter(dev).data_ptr(),
        out.data_ptr(), float(clip or 0.0),
        total.data_ptr() if mesh else None, stream)
    L.raise_on("adamw_eager_sumsq", rc)
    if mesh:
        reduce(total)           # the global sum of squares, in place
    scalars = _eager_scalars(b1, b2, eps, count)
    floats = ctypes.c_float * t
    rc = L.entry("adamw", "adamw_eager_update")(
        t, _ptrs(ps), ints(*(L.DTYPE_CODE[p.dtype] for p in ps)),
        (ctypes.c_void_p * t)(*(None if o is None else o.data_ptr()
                                for o in outs)),
        ints(*(0 if o is None else L.DTYPE_CODE[o.dtype] for o in outs)),
        gp, gtype, _ptrs(ms), _ptrs(vs), n,
        floats(*(float(np.float32(lr)) for lr in lrs)),
        floats(*(float(k) for k in _eager_keep(mode, lrs, decay, wds))),
        floats(*wds), flags, out.data_ptr(), *(float(x) for x in scalars),
        int(mode == "adam"), int(bool(clip)), float(clip or 0.0),
        total.data_ptr() if mesh else None, stream)
    L.raise_on("adamw_eager_update", rc)
    batches = -(-t // L.entry("adamw", "adamw_max_tensors")())
    adamw_eager.launches += 2 * batches
    if _work.counting():
        _work.note("adamw_eager", sum(_work.adamw_eager(
            p.numel(), p.element_size(), g.element_size(),
            0 if o is None else o.element_size())[0]
            for p, g, o in zip(ps, gs, outs)), 0)
    return out[0]


adamw_eager.launches = 0
