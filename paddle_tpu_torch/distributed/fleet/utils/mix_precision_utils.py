"""Main-grad mixed precision of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py``; reference
python/paddle/distributed/fleet/utils/mix_precision_utils.py —
MixPrecisionLayer :36 hooks every parameter so that its gradients
accumulate into an f32 ``main_grad`` beside the low-precision ``.grad``;
MixPrecisionOptimizer :97 steps from ``main_grad``).

The hybrid-parallel O2 pattern: gradients cross the data-parallel and
sharding collectives in bf16 / fp16 but accumulate and apply in f32. As
in JAX, each parameter's hook is a tensor hook (``register_hook``): it
sees each backward's gradient of the parameter before ``.grad``
accumulates it, adds it to ``main_grad`` in f32 and passes it on
unchanged. torch refuses an f32 ``.grad`` on a bf16 parameter, so the
optimizer is not handed ``main_grad`` through ``.grad`` as JAX does: it
steps on (parameter, ``main_grad``) pairs through the port optimizer's
``_step_items``, which every port optimizer has.
"""
import torch

__all__ = ["MixPrecisionLayer", "MixPrecisionOptimizer"]


class MixPrecisionLayer(torch.nn.Module):
    def __init__(self, layers, dtype="float16"):
        super().__init__()
        self._layers = layers
        self._dtype = dtype
        for param in layers.parameters():
            if not param.requires_grad:
                continue
            param.main_grad = None
            param.register_hook(self._main_grad_hook(param))

    @staticmethod
    def _main_grad_hook(param):
        def hook(grad):
            g32 = grad.detach().to(torch.float32)
            if param.main_grad is None:
                param.main_grad = g32.clone()
            else:
                param.main_grad.add_(g32)
            return grad
        return hook

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)


class MixPrecisionOptimizer:
    """Steps the inner port optimizer from each parameter's f32
    ``main_grad`` (a parameter without one steps from its ``.grad``),
    then clears the main grads (reference MixPrecisionOptimizer)."""

    def __init__(self, optimizer):
        self._inner_opt = optimizer

    def __getattr__(self, item):
        if item == "_inner_opt":
            raise AttributeError(item)
        return getattr(self._inner_opt, item)

    def _params(self):
        return list(getattr(self._inner_opt, "_parameter_list", []) or [])

    @torch.no_grad()
    def step(self):
        from ....optimizer.optimizer import _Item
        items = []
        for p in self._params():
            g = getattr(p, "main_grad", None)
            g = p.grad if g is None else g
            if g is not None and p.requires_grad:
                items.append(_Item(p, p.detach(), g))
        try:
            # the f32 main_grad unchanged: rounding it to the parameter's
            # dtype would throw away what it accumulated
            self._inner_opt._step_items(items)
        finally:
            for p in self._params():
                p.main_grad = None

    def clear_grad(self, set_to_zero=True):
        for p in self._params():
            p.main_grad = None
        self._inner_opt.clear_grad()
