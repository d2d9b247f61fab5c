"""Gradient clipping of the PyTorch port (counterpart of
``paddle_tpu/nn/clip.py``; reference python/paddle/nn/clip.py):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``,
which an optimizer's ``grad_clip`` applies to its (parameter, gradient)
pairs, and the in-place ``clip_grad_norm_``.

A parameter whose ``need_clip`` attribute is False keeps its gradient and
is left out of the global norm, as in the JAX package. The clipped
gradient is computed in float32 and rounded back to the gradient's dtype
(``paddle_tpu/nn/clip.py:102``). The global norm is the square root of an
f64 sum of the f32 squares, rounded to f32; the JAX package sums each
tensor in f32, so the two norms differ in their last bits at most.

On sharded state (the ZeRO stages, ``HybridParallelClipGrad``) a rank
holds parts of the gradients: ``_clip`` takes ``owned`` (whether this
rank counts each pair in the norm, so that a part replicated over ranks
counts once) and ``reduce`` (an in-place all_reduce of the [1] f64 sum
over the ranks). ``_norm_split`` is the hook that fleet's
``HybridParallelClipGrad`` overrides to add the model-parallel axis.
When the optimizer's step runs on kernel D (``optimizer.Adam`` /
``AdamW``), a ``ClipGradByGlobalNorm`` runs inside the kernel's first
launch instead (``ops.adamw.adamw_eager``) with the same split.

Sparse (SelectedRows) gradients are refused: they come with the port's
``sparse`` package (ROADMAP Queue 1 item 10)."""
import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _need_clip(p):
    return getattr(p, "need_clip", True)


def _dense(g):
    if g is not None and (g.is_sparse or g.layout != torch.strided):
        raise NotImplementedError(
            "gradient clipping: sparse (SelectedRows) gradients come with "
            "the port's sparse package (ROADMAP Queue 1 item 10)")
    return g


def _scaled(g, scale):
    """g * scale in float32, rounded back to g's dtype."""
    return torch.mul(g.to(torch.float32), scale).to(g.dtype)


def clip_scale(norm, clip_norm):
    """min(clip_norm / max(norm, 1e-12), 1) in f32, a true division; a
    NaN norm gives a NaN scale (jnp.maximum / jnp.minimum propagate it)."""
    num = torch.full_like(norm, float(clip_norm))
    return torch.div(num, norm.clamp_min(1e-12)).clamp(max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads, owned=None, reduce=None):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads, owned=None, reduce=None):
        out = []
        for p, g in params_grads:
            if _dense(g) is None or not _need_clip(p):
                out.append((p, g))
            else:
                out.append((p, torch.clamp(g, self.min, self.max)))
        return out


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``. On
    sharded state the norm is the whole tensor's: the per-tensor sums of
    the rank's parts are all_reduced (``reduce``) in one call."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads, owned=None, reduce=None):
        keep = [_dense(g) is not None and _need_clip(p)
                for p, g in params_grads]
        if not any(keep):
            return list(params_grads)
        owned = [True] * len(keep) if owned is None else owned
        sq = torch.stack([
            g.to(torch.float32).square().sum().double() if k and o else
            torch.zeros((), dtype=torch.float64, device=g.device)
            for k, o, (_, g) in zip(keep, owned, params_grads)
            if g is not None])
        if reduce is not None:
            sq = reduce(sq)
        norms = iter(sq.sqrt().to(torch.float32))
        out = []
        for k, (p, g) in zip(keep, params_grads):
            norm = next(norms) if g is not None else None
            out.append((p, _scaled(g, clip_scale(norm, self.clip_norm))
                        if k else g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by min(clip_norm / max(gnorm, 1e-12),
    1), gnorm the L2 norm over all of them. ``_norm_split`` /
    ``_global_norm`` are the hooks the distributed wrappers override (the
    reference's HybridParallelClipGrad)."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def _norm_split(self, params, owned, reduce):
        """(owned, reduce) for the norm over ``params``: which pairs this
        rank counts and the all_reduce of the sum over ranks (None: one
        rank)."""
        return owned, reduce

    def _global_norm(self, sq_sums, reduce=None):
        """sqrt of the f64 sum of ``sq_sums`` (0-dim f64 tensors), after
        ``reduce`` over the ranks, rounded to f32."""
        total = torch.stack(sq_sums).sum()
        if reduce is not None:
            total = reduce(total.reshape(1))[0]
        return total.sqrt().to(torch.float32)

    def _clip(self, params_grads, owned=None, reduce=None):
        params_grads = list(params_grads)
        live = [_dense(g) is not None and _need_clip(p)
                for p, g in params_grads]
        if not any(live):
            return params_grads
        owned = [True] * len(params_grads) if owned is None else owned
        owned, reduce = self._norm_split([p for p, _ in params_grads],
                                         owned, reduce)
        dev = next(g for (_, g), k in zip(params_grads, live) if k).device
        sq = [torch.zeros((), dtype=torch.float64, device=dev)]
        sq += [g.double().square().sum()
               for (_, g), k, o in zip(params_grads, live, owned) if k and o]
        scale = clip_scale(self._global_norm(sq, reduce), self.clip_norm)
        return [(p, _scaled(g, scale) if k else g)
                for (p, g), k in zip(params_grads, live)]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place so that their joint ``norm_type``
    norm is at most ``max_norm``; returns that norm (before scaling) as a
    0-dim f32 tensor."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [_dense(p.grad) for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().to(torch.float32)
                             for g in grads]).max()
    else:
        total = torch.stack([
            (g.to(torch.float32).abs() ** norm_type).sum()
            for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm of order "
                           f"{norm_type} is non-finite")
    scale = clip_scale(total, max_norm)
    for p in parameters:
        if p.grad is not None:
            p.grad.copy_(_scaled(p.grad, scale))
    return total
