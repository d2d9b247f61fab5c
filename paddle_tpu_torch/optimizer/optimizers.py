"""The optimizers of the PyTorch port (counterpart of
``paddle_tpu/optimizer/optimizers.py``; reference
python/paddle/optimizer/{sgd,momentum,adam,adamw,...}.py).

``Adam`` and ``AdamW`` step every tensor at once on kernel D's eager form
(``ops.adamw.adamw_eager``: two launches on the card, the plain version
on the CPU), with a ``ClipGradByGlobalNorm`` clip inside the kernel's
first launch. ``Adam`` folds its L2 term into the gradient as ``_l2``
does; ``AdamW`` decays the parameter (decoupled), where
``apply_decay_param_fun(name)`` allows it, and scales each tensor's rate
by ``lr_ratio(param)``.

The other thirteen run the JAX package's per-tensor update in torch
operations, expression for expression (in JAX each is an element-wise XLA
fusion with no Pallas kernel behind it). Their f32 scalars are rounded as
jnp rounds them (``f32``). ``Lamb``, ``LarsMomentum`` and ``LBFGS`` take
norms and dot products over the whole tensor (``_Item.total``), so they
also run on the ZeRO stages' chunks. ``LBFGS`` is the JAX package's
one-step form (``_apply_one``: a fixed-rate two-loop recursion over each
parameter's history), not ``torch.optim.LBFGS``.
"""
import numpy as np
import torch

from ..ops import adamw as _adamw
from .optimizer import Optimizer, f32

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD",
           "LarsMomentum", "LBFGS"]

F = np.float32


def _zeros(x):
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        self._write_back(it, st, self._base(it, st) - f32(lr) * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_state(self, x):
        return {"velocity": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        mu = f32(self._momentum)
        v2 = mu * st["velocity"] + g
        step = (g + mu * v2) if self._use_nesterov else v2
        st["velocity"] = v2
        self._write_back(it, st, self._base(it, st) - f32(lr) * step)


class _AdamBase(Optimizer):
    """Adam and AdamW: the state of both and their one kernel-D step."""

    _kernel_update = True
    _mode = None

    def _create_state(self, x):
        return {"moment1": _zeros(x), "moment2": _zeros(x)}

    def _tensor_rate(self, p, lr):
        return lr * self._lr_scale(p)

    def _tensor_decay(self, p):
        """(decayed, coefficient) for parameter p."""
        raise NotImplementedError

    def _update(self, items, lr, clip, reduce):
        if items:
            args, kw = self._kernel_args(items, lr, clip, reduce)
            self._last_grad_norm = _adamw.adamw_eager(*args, **kw)

    def _kernel_args(self, items, lr, clip, reduce, count=None):
        """(args, kwargs) of ``ops.adamw.adamw_eager`` for ``items`` (the
        state created where missing): each item's master (or x itself),
        its gradient, moments, rate and decay; the clip's flags and split;
        ``count`` the step's number (default the optimizer's)."""
        ps, outs, gs, ms, vs, lrs, decay, wds, cflags, owned = \
            ([] for _ in range(10))
        for it in items:
            st = self._state(it.p, it.x)
            master = st.get("master")
            ps.append(it.x if master is None else master)
            outs.append(None if master is None else it.x)
            gs.append(it.g.contiguous())
            ms.append(st["moment1"])
            vs.append(st["moment2"])
            lrs.append(self._tensor_rate(it.p, lr))
            d, wd = self._tensor_decay(it.p)
            decay.append(d)
            wds.append(wd)
            cflags.append(getattr(it.p, "need_clip", True))
            owned.append(it.owned)
        kw = dict(mode=self._mode, outs=outs)
        if clip is not None:
            owned, reduce = clip._norm_split([it.p for it in items], owned,
                                             reduce)
            kw.update(clip=clip.clip_norm, clip_flags=cflags, owned=owned,
                      reduce=reduce)
        args = (ps, gs, ms, vs, lrs, decay, self._beta1, self._beta2,
                self._epsilon, wds,
                self._step_count if count is None else count)
        return args, kw


class Adam(_AdamBase):
    _mode = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _tensor_decay(self, p):
        wd = self._wd_of(p, self._weight_decay)
        return bool(wd), wd


class AdamW(_AdamBase):
    """Decoupled weight decay (reference python/paddle/optimizer/adamw.py);
    ``weight_decay`` is the decoupled coefficient, default 0.01."""

    _mode = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        if isinstance(weight_decay, (int, float)) \
                and not isinstance(weight_decay, bool):
            self._wd = float(weight_decay)
        else:
            self._wd = float(getattr(weight_decay, "coeff", 0.01))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _tensor_rate(self, p, lr):
        lr = lr * self._lr_scale(p)
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        return lr

    def _tensor_decay(self, p):
        wd = self._wd_of(p, self._wd)
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names.get(id(p))):
            wd = 0.0
        return bool(wd), wd


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_state(self, x):
        return {"moment": torch.full(x.shape, f32(self._init_acc),
                                     dtype=torch.float32, device=x.device)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        acc2 = st["moment"] + g * g
        st["moment"] = acc2
        new = self._base(it, st) - f32(lr) * g / (acc2.sqrt()
                                                   + f32(self._epsilon))
        self._write_back(it, st, new)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_state(self, x):
        return {"mean_square": _zeros(x), "momentum_acc": _zeros(x),
                "mean_grad": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        rho, eps = F(self._rho), f32(self._epsilon)
        omr = float(F(1) - rho)
        ms2 = float(rho) * st["mean_square"] + omr * g * g
        if self._centered:
            mg2 = float(rho) * st["mean_grad"] + omr * g
            denom = (ms2 - mg2 * mg2 + eps).sqrt()
        else:
            mg2 = st["mean_grad"]
            denom = (ms2 + eps).sqrt()
        mom2 = f32(self._momentum) * st["momentum_acc"] + f32(lr) * g / denom
        st["mean_square"], st["momentum_acc"], st["mean_grad"] = \
            ms2, mom2, mg2
        self._write_back(it, st, self._base(it, st) - mom2)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon

    def _create_state(self, x):
        return {"avg_squared_grad": _zeros(x),
                "avg_squared_update": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        rho, eps = F(self._rho), f32(self._epsilon)
        omr = float(F(1) - rho)
        sq2 = float(rho) * st["avg_squared_grad"] + omr * g * g
        dx = (st["avg_squared_update"] + eps).sqrt() / (sq2 + eps).sqrt() * g
        st["avg_squared_grad"] = sq2
        st["avg_squared_update"] = (float(rho) * st["avg_squared_update"]
                                    + omr * dx * dx)
        self._write_back(it, st, self._base(it, st) - f32(lr) * dx)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_state(self, x):
        return {"moment": _zeros(x), "inf_norm": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        b1, b2, t = F(self._beta1), F(self._beta2), F(self._step_count)
        m2 = float(b1) * st["moment"] + float(F(1) - b1) * g
        u2 = torch.maximum(float(b2) * st["inf_norm"], g.abs())
        st["moment"], st["inf_norm"] = m2, u2
        rate = float(F(lr) / (F(1) - b1 ** t))
        new = self._base(it, st) - rate * m2 / (u2 + f32(self._epsilon))
        self._write_back(it, st, new)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_state(self, x):
        return {"moment1": _zeros(x), "moment2": _zeros(x)}

    def _apply_one(self, it, st, lr):
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(it.p):
            wd = 0.0
        g = it.g.to(torch.float32)
        p = self._base(it, st)
        b1, b2, t = F(self._beta1), F(self._beta2), F(self._step_count)
        m2 = float(b1) * st["moment1"] + float(F(1) - b1) * g
        v2 = float(b2) * st["moment2"] + float(F(1) - b2) * g * g
        mhat = m2 / float(F(1) - b1 ** t)
        vhat = v2 / float(F(1) - b2 ** t)
        r = mhat / (vhat.sqrt() + f32(self._epsilon)) + f32(wd) * p
        p_norm = it.total(p * p).sqrt()
        r_norm = it.total(r * r).sqrt()
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        st["moment1"], st["moment2"] = m2, v2
        self._write_back(it, st, p - f32(lr) * trust * r)


class NAdam(Optimizer):
    """Adam with Nesterov momentum (reference
    python/paddle/optimizer/nadam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_state(self, x):
        return {"moment1": _zeros(x), "moment2": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        b1, b2, t = F(self._beta1), F(self._beta2), F(self._step_count)
        m2 = float(b1) * st["moment1"] + float(F(1) - b1) * g
        v2 = float(b2) * st["moment2"] + float(F(1) - b2) * (g * g)
        mhat = m2 / float(F(1) - b1 ** (t + F(1)))
        vhat = v2 / float(F(1) - b2 ** t)
        nes = float(b1) * mhat + float(F(1) - b1) * g / float(F(1) - b1 ** t)
        st["moment1"], st["moment2"] = m2, v2
        new = self._base(it, st) - f32(lr) * nes / (vhat.sqrt()
                                                    + f32(self._epsilon))
        self._write_back(it, st, new)


class RAdam(Optimizer):
    """Rectified Adam (reference python/paddle/optimizer/radam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_state(self, x):
        return {"moment1": _zeros(x), "moment2": _zeros(x)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        b1, b2, t = F(self._beta1), F(self._beta2), F(self._step_count)
        m2 = float(b1) * st["moment1"] + float(F(1) - b1) * g
        v2 = float(b2) * st["moment2"] + float(F(1) - b2) * (g * g)
        mhat = m2 / float(F(1) - b1 ** t)
        c2 = F(1) - b2 ** t
        rho_inf = F(2) / (F(1) - b2) - F(1)
        rho_t = rho_inf - F(2) * t * (b2 ** t) / c2
        r_num = (rho_t - F(4)) * (rho_t - F(2)) * rho_inf
        r_den = (rho_inf - F(4)) * (rho_inf - F(2)) * rho_t
        rect = np.sqrt(np.maximum(r_num / r_den, F(0)))
        p = self._base(it, st)
        if rho_t > F(5):
            vhat = (v2 / float(c2)).sqrt() + f32(self._epsilon)
            new = p - float(F(lr) * rect) * mhat / vhat
        else:
            new = p - f32(lr) * mhat
        st["moment1"], st["moment2"] = m2, v2
        self._write_back(it, st, new)


class Rprop(Optimizer):
    """Resilient backprop: full-batch sign-based steps (reference
    python/paddle/optimizer/rprop.py)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _create_state(self, x):
        return {"prev_grad": _zeros(x),
                "step_size": torch.full(x.shape, f32(self.get_lr()),
                                        dtype=torch.float32,
                                        device=x.device)}

    def _apply_one(self, it, st, lr):
        g = it.g.to(torch.float32)
        sign = torch.sign(g * st["prev_grad"])
        one = torch.ones_like(g)
        factor = torch.where(sign > 0, f32(self._etas[1]) * one,
                             torch.where(sign < 0, f32(self._etas[0]) * one,
                                         one))
        step2 = torch.clamp(st["step_size"] * factor, f32(self._lr_range[0]),
                            f32(self._lr_range[1]))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        st["prev_grad"], st["step_size"] = g_eff, step2
        self._write_back(it, st,
                         self._base(it, st) - torch.sign(g_eff) * step2)


class ASGD(Optimizer):
    """Averaged SGD (reference python/paddle/optimizer/asgd.py): SGD steps
    and a running parameter average for evaluation."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, t0=0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._t0 = t0

    def _create_state(self, x):
        return {"averaged": x.to(torch.float32, copy=True)}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        p2 = self._base(it, st) - f32(lr) * g
        t, t0 = F(self._step_count), F(self._t0)
        avg = st["averaged"]
        st["averaged"] = (avg + (p2 - avg) / float(max(t - t0 + F(1), F(1)))
                          if t >= t0 else p2.clone())
        self._write_back(it, st, p2)

    def averaged_parameters(self):
        return {id(p): self._state(p)["averaged"]
                for p in self._parameter_list}


class LarsMomentum(Optimizer):
    """LARS: layer-wise adaptive rate scaling (reference
    python/paddle/incubate/optimizer lars_momentum)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 multi_precision=False, name=None, epsilon=1e-9):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def _create_state(self, x):
        return {"velocity": _zeros(x)}

    def _apply_one(self, it, st, lr):
        p = self._base(it, st)
        g = it.g.to(torch.float32)
        wd = f32(self._lars_wd)
        p_norm = it.total(p * p).sqrt()
        g_norm = it.total(g * g).sqrt()
        local = torch.where(
            (p_norm > 0) & (g_norm > 0),
            f32(self._lars_coeff) * p_norm / (g_norm + wd * p_norm
                                              + f32(self._epsilon)),
            torch.ones_like(p_norm))
        v2 = f32(self._momentum) * st["velocity"] + local * f32(lr) * (
            g + wd * p)
        st["velocity"] = v2
        self._write_back(it, st, p - v2)


class LBFGS(Optimizer):
    """Limited-memory BFGS, the JAX package's form: (s, y) curvature pairs
    per parameter and the two-loop recursion on the current grads, with a
    fixed learning-rate step (no line search)."""

    def __init__(self, learning_rate=1.0, max_iter=1, history_size=10,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, tolerance_grad=1e-7,
                 tolerance_change=1e-9, line_search_fn=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._hist = history_size

    def _create_state(self, x):
        return {"s": [], "y": [], "prev_p": None, "prev_g": None}

    def _apply_one(self, it, st, lr):
        g = self._l2(it, it.g, st).to(torch.float32)
        base = self._base(it, st)

        def dot(a, b):
            return it.total(a * b)
        if st["prev_p"] is not None:
            s = base - st["prev_p"]
            y = g - st["prev_g"]
            if float(dot(s, y)) > 1e-10:
                st["s"].append(s)
                st["y"].append(y)
                if len(st["s"]) > self._hist:
                    st["s"].pop(0)
                    st["y"].pop(0)
        q = g
        alphas = []
        for s, y in zip(reversed(st["s"]), reversed(st["y"])):
            rho = 1.0 / dot(y, s)
            a = rho * dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if st["s"]:
            s_l, y_l = st["s"][-1], st["y"][-1]
            q = q * (dot(s_l, y_l) / dot(y_l, y_l))
        for a, rho, s, y in reversed(alphas):
            b = rho * dot(y, q)
            q = q + (a - b) * s
        st["prev_p"], st["prev_g"] = base.clone(), g
        self._write_back(it, st, base - f32(lr) * q)
