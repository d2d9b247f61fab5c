"""Carrying weights across for the PyTorch port's models: a port model
built from the JAX model's ``{name: np.ndarray}`` (as
``jit.functional.state_arrays`` gives them) and back.

Names and layouts are the JAX package's: [in, out] linear weights and
[out, in / groups, kh, kw] convolution weights load as they are. The key
sets must match exactly and every shape must agree."""
import numpy as np
import torch

__all__ = ["load_numpy", "state_from_numpy", "state_to_numpy"]


def load_numpy(model, params, dtype=None, who="load_numpy"):
    """Copy ``params`` into ``model``'s parameters (each cast to ``dtype``,
    default float32); raises KeyError on missing or extra names and
    ValueError on a shape that differs. Returns the model."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"{who}: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.array(params[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{who}: {name} has shape {arr.shape}, the "
                                 f"model {tuple(p.shape)}")
            p.data = torch.from_numpy(arr).to(device=p.device,
                                              dtype=dtype or torch.float32)
    return model


def state_from_numpy(params, build, *args, device="cuda", dtype=None,
                     **kwargs):
    """``build(*args, device=device, **kwargs)`` (a port model class or
    factory: ``GPTForCausalLM``, ``vit_tiny``, ``ErnieForMaskedLM``,
    ``UNet2DConditionModel``, ...) holding the JAX model's weights
    ``params``, cast to ``dtype`` (default: float32)."""
    return load_numpy(build(*args, device=device, **kwargs), params, dtype,
                      f"state_from_numpy({getattr(build, '__name__', build)})")


def state_to_numpy(model):
    """{name: float32 np.ndarray} of a port model's parameters, the
    inverse of ``state_from_numpy``."""
    return {n: p.detach().to(torch.float32).cpu().numpy()
            for n, p in model.named_parameters()}
