"""paddle.framework's ``save`` / ``load`` of the PyTorch port (counterpart
of ``paddle_tpu/framework/__init__.py``; reference
python/paddle/framework/io.py): a pickle of the object with every tensor
stored as ``{"__tensor__": True, "data": np.ndarray, "stop_gradient",
"name"}``, the JAX package's own format. A ``.pdparams`` / ``.pdopt``
file written here loads in the JAX ``framework.load``, and the reverse.
A bfloat16 tensor is stored as float32 (numpy has no bfloat16 of its
own). The rest of ``framework`` is not ported yet (ROADMAP Queue 1 item
10)."""
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _to_storable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return {"__tensor__": True, "data": t.cpu().numpy(),
                "stop_gradient": not obj.requires_grad,
                "name": getattr(obj, "name", None)}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_storable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_storable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            arr = np.asarray(obj["data"])
            if return_numpy:
                return arr
            if arr.dtype.name == "bfloat16":
                return torch.from_numpy(arr.view(np.uint16).copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(arr.copy())
        return {k: _from_storable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_storable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save: a state_dict or a nested structure of tensors, written
    to ``path`` (its directory made where missing)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """paddle.load: the object ``save`` wrote, its tensors CPU tensors (or
    numpy arrays with ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_storable(obj, return_numpy=return_numpy)
