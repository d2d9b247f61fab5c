"""Incubating optimizers of the PyTorch port (counterpart of
``paddle_tpu/incubate/optimizer/__init__.py``; reference
python/paddle/incubate/optimizer/): ``LookAhead``, ``ModelAverage``, the
``LBFGS`` alias, ``DistributedFusedLamb`` and the functional BFGS /
L-BFGS minimizers (``functional``).

``DistributedFusedLamb`` is the port's ``Lamb`` with the reference's
distributed step around it: micro-batch accumulation in f32, the clip
before or after the gradient all_reduce over the hybrid group's data
axis (``fleet.init``; none on one rank) and the 1 / n scaling. The
reference's CUDA kernels fuse that step over flat buffers; here each
part is the eager ops of the port's optimizer (Lamb has no kernel in
either package).
"""
import torch

from ...optimizer.optimizer import Optimizer, f32
from ...optimizer.optimizers import LBFGS  # noqa: F401
from ...optimizer.optimizers import Lamb as _Lamb
from . import functional  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "LBFGS", "DistributedFusedLamb",
           "functional"]


def _f32_copy(p):
    return p.detach().to(torch.float32, copy=True)


class LookAhead(Optimizer):
    """Lookahead (reference incubate/optimizer/lookahead.py): k fast
    steps of the inner optimizer, then the slow weights move ``alpha`` of
    the way to the fast ones and the parameters take them. The slow
    weights are the parameters at construction, in f32."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner = inner_optimizer
        super().__init__(inner_optimizer.get_lr(),
                         inner_optimizer._parameter_list, None, None,
                         False, name)
        self.alpha = alpha
        self.k = k
        self._slow = {id(p): _f32_copy(p) for p in self._parameter_list}
        self._steps = 0

    @torch.no_grad()
    def step(self):
        self.inner.step()
        self._steps += 1
        if self._steps % self.k:
            return
        for p in self._parameter_list:
            slow = self._slow.get(id(p))
            if slow is None:  # param added after construction
                self._slow[id(p)] = _f32_copy(p)
                continue
            slow = slow + f32(self.alpha) * (p.to(torch.float32) - slow)
            self._slow[id(p)] = slow
            p.copy_(slow.to(p.dtype))

    def clear_grad(self, set_to_zero=False):
        self.inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


class ModelAverage(Optimizer):
    """Running parameter average for evaluation (reference
    incubate/optimizer/modelaverage.py): each step adds the parameters to
    ``sum`` (f32); when the window reaches ``max_average_window`` (and
    ``min_average_window``) it rolls into ``old_sum`` and restarts.
    ``apply()`` puts (sum + old_sum) / count into the parameters,
    ``restore()`` takes them back."""

    def __init__(self, inner_optimizer_or_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if isinstance(inner_optimizer_or_rate, Optimizer):
            self.inner = inner_optimizer_or_rate
            params = self.inner._parameter_list
        else:
            self.inner = None
            params = parameters
        super().__init__(0.0, params, None, None, False, name)
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = {id(p): torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                     for p in self._parameter_list}
        self._old_sum = {k: torch.zeros_like(v) for k, v in self._sum.items()}
        self._count = 0
        self._old_count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        if self.inner is not None:
            self.inner.step()
        for p in self._parameter_list:
            self._sum[id(p)] = self._sum[id(p)] + p.to(torch.float32)
        self._count += 1
        if self._count >= self._max_w and self._count >= self._min_w:
            self._old_sum = dict(self._sum)
            self._old_count = self._count
            self._sum = {k: torch.zeros_like(v) for k, v in self._sum.items()}
            self._count = 0

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {id(p): p.detach().clone()
                        for p in self._parameter_list}
        total = self._count + self._old_count
        if not total:
            return
        for p in self._parameter_list:
            avg = (self._sum[id(p)] + self._old_sum[id(p)]) / total
            p.copy_(avg.to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup:
            for p in self._parameter_list:
                p.copy_(self._backup[id(p)])
            self._backup = None

    def clear_grad(self, set_to_zero=False):
        if self.inner is not None:
            self.inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


class DistributedFusedLamb(_Lamb):
    """Distributed LAMB (reference
    python/paddle/incubate/optimizer/distributed_fused_lamb.py:120): with
    ``gradient_accumulation_steps`` > 1 a step adds the gradients (f32)
    and updates only every that many calls, on their mean; the clip runs
    before the all_reduce when ``clip_after_allreduce`` is False (after
    it, inside Lamb, otherwise); the gradients are all_reduced over the
    hybrid group's data-parallel group when it has more than one rank,
    and divided by its size when ``is_grad_scaled_by_nranks``.
    ``use_master_param_norm`` is Lamb's ``multi_precision``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 alignment=128, use_master_param_norm=True,
                 gradient_accumulation_steps=1, use_master_acc_grad=True,
                 nproc_per_node=None, use_hierarchical_allreduce=False,
                 name=None):
        super().__init__(
            learning_rate=learning_rate, lamb_weight_decay=lamb_weight_decay,
            beta1=beta1, beta2=beta2, epsilon=epsilon, parameters=parameters,
            grad_clip=grad_clip if clip_after_allreduce else None,
            exclude_from_weight_decay_fn=exclude_from_weight_decay_fn,
            multi_precision=use_master_param_norm)
        self._pre_clip = None if clip_after_allreduce else grad_clip
        self._scaled_by_nranks = is_grad_scaled_by_nranks
        self._acc_steps = int(gradient_accumulation_steps)
        self._acc_count = 0
        self._acc = {}

    def _dp_group(self):
        from ...distributed.fleet import get_hcg
        hcg = get_hcg()
        if hcg is None:
            return None
        g = hcg.get_data_parallel_group()
        return g if g.size() > 1 else None

    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list if p.grad is not None]
        if self._acc_steps > 1:
            self._acc_count += 1
            for p in params:
                a = self._acc.get(id(p))
                g32 = p.grad.to(torch.float32)
                self._acc[id(p)] = g32 if a is None else a + g32
                p.grad = None
            if self._acc_count < self._acc_steps:
                return
            for p in params:
                p.grad = (self._acc.pop(id(p)) / self._acc_steps).to(p.dtype)
            self._acc_count = 0
        if self._pre_clip is not None:
            for p, g in self._pre_clip([(p, p.grad) for p in params]):
                p.grad = g
        group = self._dp_group()
        if group is not None:
            from ...distributed import collective
            n = group.size()
            for p in params:
                collective.all_reduce(p.grad, group=group)
                if self._scaled_by_nranks:
                    p.grad = p.grad / n
        return super().step()
