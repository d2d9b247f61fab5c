"""Carrying weights across for the PyTorch port's models: a port model
built from the JAX model's ``{name: np.ndarray}`` (as
``jit.functional.state_arrays`` gives them) and back.

Names and layouts are the JAX package's: [in, out] linear weights and
[out, in / groups, kh, kw] convolution weights load as they are. The
buffers (batch norm's ``_mean`` and ``_variance``) are the second dict
of ``state_arrays``: pass the pair ``(params, buffers)`` as it gives
them. The key sets must match exactly, for the parameters and
for the buffers, and every shape must agree; a model with buffers
refuses a load without them (its running statistics would stay at their
initial 0 / 1 and an eval forward would differ silently)."""
import numpy as np
import torch

__all__ = ["load_numpy", "state_from_numpy", "state_to_numpy"]


def _copy(own, arrays, what, who, dtype):
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"{who}: {what} missing {missing}, unexpected "
                       f"{extra}")
    with torch.no_grad():
        for name, t in own.items():
            arr = np.array(arrays[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{who}: {name} has shape {arr.shape}, the "
                                 f"model {tuple(t.shape)}")
            t.data = torch.from_numpy(arr).to(device=t.device,
                                              dtype=dtype or t.dtype)


def load_numpy(model, params, dtype=None, who="load_numpy"):
    """Copy ``params`` into ``model``'s parameters (each cast to ``dtype``,
    default float32); given the pair ``(params, buffers)``, also the
    buffers into its buffers (in their own dtype). Raises
    KeyError on missing or extra names and ValueError on a shape that
    differs. Returns the model."""
    buffers = None
    if isinstance(params, tuple):
        params, buffers = params
    _copy(dict(model.named_parameters()), params, "parameters", who,
          dtype or torch.float32)
    own = dict(model.named_buffers())
    if own or buffers:
        _copy(own, buffers or {}, "buffers", who, None)
    return model


def state_from_numpy(params, build, *args, device="cuda", dtype=None,
                     **kwargs):
    """``build(*args, device=device, **kwargs)`` (a port model class or
    factory: ``GPTForCausalLM``, ``vit_tiny``, ``vision.models.resnet50``,
    ...) holding the JAX model's weights ``params`` (or the pair
    ``(params, buffers)``), the parameters cast to ``dtype`` (default:
    float32)."""
    return load_numpy(build(*args, device=device, **kwargs), params, dtype,
                      f"state_from_numpy({getattr(build, '__name__', build)})")


def state_to_numpy(model, with_buffers=False):
    """{name: float32 np.ndarray} of a port model's parameters, the
    inverse of ``state_from_numpy``; with ``with_buffers`` the pair
    (parameters, buffers), as ``state_arrays`` gives them."""
    params = {n: p.detach().to(torch.float32).cpu().numpy()
              for n, p in model.named_parameters()}
    if not with_buffers:
        return params
    return params, {n: b.detach().cpu().numpy()
                    for n, b in model.named_buffers()}
