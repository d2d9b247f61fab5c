"""Normalisation functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/norm.py``). Only what the Llama model calls."""
import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm: the mean square in float32, the normalised value cast back
    to x's dtype, then scaled by the weight cast to x's dtype (an f32
    scale never promotes a bf16 activation)."""
    dtype = x.dtype
    a32 = x.to(torch.float32)
    ms = torch.mean(a32 * a32, dim=-1, keepdim=True)
    out = (a32 * torch.rsqrt(ms + epsilon)).to(dtype)
    if weight is not None:
        out = out * weight.to(dtype)
    return out
