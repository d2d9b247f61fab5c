"""Incubating APIs of the PyTorch port (counterpart of
``paddle_tpu/incubate/__init__.py``): ``nn`` (the fused ops and layers),
``distributed`` (MoE and fleet's recompute entry points), ``optimizer``
(``LookAhead``, ``ModelAverage``, ``DistributedFusedLamb``, the
functional minimizers), ``asp``, and the JAX package's top-level
``identity_loss``, ``softmax_mask_fuse`` and
``softmax_mask_fuse_upper_triangle``. ``autograd``, ``inference`` and
the graph aliases wait for the packages they stand on."""
import torch

from . import distributed  # noqa: F401
from . import nn  # noqa: F401
from . import asp  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401


def identity_loss(x, reduction="none"):
    """Mark a value as a loss for IPU-style pipelines; here a reduction
    only (reference incubate.identity_loss): "none" / 2, "sum" / 1, else
    the mean."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 1):
        return x.sum()
    return x.mean()


def softmax_mask_fuse(x, mask):
    """softmax(x + mask) over the last axis (reference fused_softmax_mask
    op)."""
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x):
    """Causal-masked softmax (reference fused_softmax_mask_upper_triangle):
    the strictly upper triangle takes float32's lowest value (in x's
    dtype), the softmax runs in f32 and casts back."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    logits = torch.where(keep, x, torch.finfo(torch.float32).min)
    return torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
