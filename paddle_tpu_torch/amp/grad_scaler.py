"""Dynamic loss scaling of the PyTorch port (counterpart of
``paddle_tpu/amp/grad_scaler.py``; reference python/paddle/amp/
grad_scaler.py — GradScaler :657 wrapping AmpScaler :62).

fp16 gradients underflow: the loss is scaled up before the backward, the
gradients unscaled before the optimizer's step, the step skipped when any
gradient is inf / nan, and the scale adapted (x incr_ratio after
incr_every_n_steps clean steps, x decr_ratio after
decr_every_n_nan_or_inf bad ones). bf16 needs none of it: ``enable=False``
makes every method a pass-through.

The state machine and its numbers are JAX's. What differs is how the
gradients are read: the JAX scaler checks each gradient and reads the
answer on the host, once a tensor. The port unscales the whole gradient
list in one pass in f32 (``torch._amp_foreach_non_finite_check_and_unscale_``
over each device / dtype group) into one ``found_inf`` flag on the
device, and reads that flag on the host once a step (``host_reads``
counts the reads). Under the ZeRO stages each rank holds only its own
gradients (stage 2 reduce-scatters them in the step, stage 3 holds
chunks), so ``group_sharded_parallel(..., scaler=)`` gives the scaler the
sharding group and the flag is all-reduced (MAX) over it before it is
read: every rank skips the same steps (the reference's
``GroupShardedScaler``). The pipeline (``PipelineParallel.train_batch(...,
scaler=)``) gives it the pp group (and the mp group) the same way, so
that every stage skips a step that one stage's gradients overflowed.
After ``DataParallel``'s reducer every rank holds the same averaged
gradients and finds the same flag.
"""
import enum

import numpy as np
import torch

__all__ = ["AmpScaler", "GradScaler", "OptimizerState"]


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        if incr_ratio <= 1.0:
            raise ValueError("incr_ratio must be > 1")
        if not 0.0 < decr_ratio < 1.0:
            raise ValueError("decr_ratio must be in (0, 1)")
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling)
        self._init_loss_scaling = float(init_loss_scaling)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf = False      # None: on the device, not read yet
        self._found_inf_t = None
        self._opt_states = {}
        self._group = None           # the sharding group (ZeRO stages)
        self.host_reads = 0

    # -- scaling ---------------------------------------------------------
    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _collect_grads(self, optimizer):
        return [p for p in optimizer._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def _unscale(self, optimizer):
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer), OptimizerState.INIT)
        if state is OptimizerState.UNSCALED:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update()")
        groups = {}
        for p in self._collect_grads(optimizer):
            groups.setdefault((p.grad.device, p.grad.dtype), []).append(
                p.grad)
        found = None
        for (dev, _), grads in groups.items():
            flag = torch.zeros(1, dtype=torch.float32, device=dev)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag, inv)
            found = flag if found is None else \
                torch.maximum(found, flag.to(found.device))
        if found is None:
            dev = self._group_device(optimizer)
            found = torch.zeros(1, dtype=torch.float32, device=dev)
        if self._group is not None:
            from ..distributed import collective
            groups = self._group if isinstance(self._group, (list, tuple)) \
                else (self._group,)
            for g in groups:
                collective.all_reduce(found, op=collective.ReduceOp.MAX,
                                      group=g)
        self._found_inf_t = found
        self._found_inf = None
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    unscale_ = _unscale

    @staticmethod
    def _group_device(optimizer):
        params = list(optimizer._parameter_list)
        return params[0].device if params else torch.device("cpu")

    def _found(self):
        """Whether the last unscale found an inf / nan: the device flag,
        read on the host at most once a step."""
        if self._found_inf is None:
            self._found_inf = bool(self._found_inf_t.item() > 0)
            self.host_reads += 1
        return self._found_inf

    # -- stepping --------------------------------------------------------
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), OptimizerState.INIT)
        if state is OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update()")
        if state is OptimizerState.INIT:
            self._unscale(optimizer)
        if not self._found():
            optimizer.step()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable:
            return
        found = self._found()
        if self._use_dynamic_loss_scaling:
            if found:
                self._decr_count += 1
                self._incr_count = 0
                if self._decr_count >= self._decr_every_n_nan_or_inf:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._decr_count = 0
            else:
                self._incr_count += 1
                self._decr_count = 0
                if self._incr_count >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._incr_count = 0
        self._found_inf = False
        self._found_inf_t = None
        self._opt_states.clear()

    def minimize(self, optimizer, scaled_loss, *args, **kwargs):
        if not self._enable:
            optimizer.step()
            optimizer.clear_grad()
            return
        self.step(optimizer)
        self.update()

    # -- introspection ---------------------------------------------------
    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic_loss_scaling

    def get_init_loss_scaling(self):
        return self._init_loss_scaling

    def set_init_loss_scaling(self, v):
        self._init_loss_scaling = float(v)
        self._scale = float(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        if v <= 1.0:
            raise ValueError("incr_ratio must be > 1")
        self._incr_ratio = float(v)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        if not 0.0 < v < 1.0:
            raise ValueError("decr_ratio must be in (0, 1)")
        self._decr_ratio = float(v)

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = int(v)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n_nan_or_inf = int(v)

    def state_dict(self):
        if not self._enable:
            return {}
        return {
            "scale": np.float32(self._scale),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._incr_count,
            "decr_count": self._decr_count,
            "use_dynamic_loss_scaling": self._use_dynamic_loss_scaling,
        }

    def load_state_dict(self, state):
        if not self._enable:
            return
        self._scale = float(state["scale"])
        self._incr_ratio = float(state["incr_ratio"])
        self._decr_ratio = float(state["decr_ratio"])
        self._incr_every_n_steps = int(state["incr_every_n_steps"])
        self._decr_every_n_nan_or_inf = int(state["decr_every_n_nan_or_inf"])
        self._incr_count = int(state.get("incr_count", 0))
        self._decr_count = int(state.get("decr_count", 0))
        self._use_dynamic_loss_scaling = bool(
            state["use_dynamic_loss_scaling"])


class GradScaler(AmpScaler):
    """Public scaler (reference: grad_scaler.py:657)."""
