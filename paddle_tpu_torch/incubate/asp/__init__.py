"""n:m structured sparsity, ASP, of the PyTorch port (counterpart of
``paddle_tpu/incubate/asp/__init__.py``; reference
python/paddle/incubate/asp/: calculate_density, create_mask with the
m4n2 patterns, prune_model, decorate).

Masks keep the n largest magnitudes of every group of m along the last
axis (ties: the lower index, numpy's order on groups this small), are
computed on the weight's own device, and are enforced through the
optimizer's step: ``decorate`` multiplies the pruned parameters by
their masks after every update. As in the JAX package this is the
training method; no sparse kernel runs (the H100's 2:4 tensor-core mode
is not used).
"""
import weakref

import numpy as np
import torch

__all__ = ["calculate_density", "create_mask", "check_mask_1d",
           "check_mask_2d", "prune_model", "decorate", "reset_excluded_layers",
           "set_excluded_layers", "add_supported_layer"]

_excluded = set()
_pruned_models = []  # weakrefs of every prune_model target
_supported_layer_types = set()  # extra layer classes opted into pruning
_custom_pruning = {}  # layer-type name -> pruning func


def _tensor(x):
    return x.detach() if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x))


def add_supported_layer(layer, pruning_func=None):
    """Opt a layer type into ASP pruning (reference
    incubate/asp/supported_layer_list.py add_supported_layer): ``layer``
    is a module class or its name; ``pruning_func(weight_np, m, n,
    mask_algo, param_name) -> (pruned_np, mask_np)`` replaces the n:m
    masking for that type's parameters."""
    name = layer if isinstance(layer, str) else getattr(
        layer, "__name__", str(layer))
    _supported_layer_types.add(name)
    if pruning_func is not None:
        _custom_pruning[name] = pruning_func


def calculate_density(x):
    """The share of non-zero elements of ``x``."""
    t = _tensor(x)
    return float(torch.count_nonzero(t)) / max(t.numel(), 1)


def create_mask(tensor, func_name="mask_1d", n=2, m=4):
    """Best-n-of-m mask along the last axis (reference create_mask
    mask_1d / mask_2d_best, which the JAX package computes alike): in
    every group of m the n largest |values| keep 1, on the tensor's
    device and in its dtype; a last group short of m is padded with
    zeros."""
    arr = _tensor(tensor)
    flat = arr.reshape(-1, arr.shape[-1])
    rows, cols = flat.shape
    pad = (-cols) % m
    groups = torch.nn.functional.pad(flat.abs(), (0, pad)).reshape(
        rows, -1, m)
    order = torch.argsort(-groups, dim=-1, stable=True)
    keep = torch.zeros(groups.shape, dtype=torch.bool, device=arr.device)
    keep.scatter_(-1, order[..., :n], True)
    mask = keep.reshape(rows, -1)[:, :cols].reshape(arr.shape)
    return mask.to(arr.dtype)


def check_mask_1d(mat, n=2, m=4):
    """Whether every group of m consecutive elements (flattened, the last
    one zero-padded) has at most n non-zeros."""
    flat = (_tensor(mat) != 0).reshape(-1)
    groups = torch.nn.functional.pad(flat, (0, (-flat.numel()) % m))
    return bool((groups.reshape(-1, m).sum(dim=1) <= n).all())


def check_mask_2d(mat, n=2, m=4):
    return check_mask_1d(mat, n, m)


def set_excluded_layers(param_names, main_program=None):
    _excluded.update(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def _prunable(name, p):
    return p.dim() >= 2 and name not in _excluded \
        and not name.endswith("bias")


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m masks to every prunable parameter of ``model`` (2-D or
    more, not a bias, not excluded); returns {name: mask}. The masks are
    kept on the model for ``decorate``; a parameter of a sub-module whose
    type has a pruning function (``add_supported_layer``) is pruned by
    it."""
    owner_type = {}
    for lname, sub in model.named_modules():
        if not lname:
            continue
        for pname, _ in sub.named_parameters(recurse=False):
            owner_type[f"{lname}.{pname}"] = type(sub).__name__
    masks = {}
    for name, p in model.named_parameters():
        if not _prunable(name, p):
            continue
        custom = _custom_pruning.get(owner_type.get(name))
        with torch.no_grad():
            if custom is not None:
                pruned, mask_np = custom(p.detach().cpu().numpy(), m, n,
                                         mask_algo, name)
                p.copy_(torch.as_tensor(np.asarray(pruned)))
                masks[name] = torch.as_tensor(np.asarray(mask_np)).to(
                    p.device)
                continue
            mask = create_mask(p, mask_algo, n, m)
            p.mul_(mask)
        masks[name] = mask
    model._asp_masks = masks
    _pruned_models.append(weakref.ref(model))
    return masks


def decorate(optimizer, model=None):
    """Wrap ``optimizer.step`` to re-apply the masks after every update
    (reference ASPOptimizer / OptimizerWithSparsityGuarantee): those of
    ``model``, or of every model given to ``prune_model`` so far."""
    orig_step = optimizer.step

    def step():
        orig_step()
        if model is not None:
            models = [model]
        else:
            models = [mdl for mdl in (r() for r in _pruned_models)
                      if mdl is not None]
        with torch.no_grad():
            for mdl in models:
                masks = getattr(mdl, "_asp_masks", None)
                if not masks:
                    continue
                for name, p in mdl.named_parameters():
                    msk = masks.get(name)
                    if msk is not None:
                        p.mul_(msk)

    optimizer.step = step
    return optimizer
