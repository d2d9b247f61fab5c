"""Normalisation functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``rms_norm`` (kernel A),
``layer_norm`` and ``group_norm``, named entries of the amp hook
(``amp._hook.amp_op``; all three on its black list).

Both new norms take their statistics in float32 whatever the input's
dtype. ``layer_norm`` returns the input's dtype, its scale and shift
cast to it, as the JAX op does. ``group_norm`` rounds the normalised
value to the input's dtype and then applies its scale and shift with
the JAX op's promotion (an f32 scale makes a bf16 input's output f32).
"""
import torch

from ...amp._hook import amp_op, casting
from ...ops import fused_norm


@amp_op("rms_norm")
def _rms_norm(x, weight, epsilon, residual):
    return fused_norm.rms_norm(x, weight, epsilon, residual=residual)


def rms_norm(x, weight=None, epsilon=1e-6, residual=None):
    """RMSNorm: the mean square in float32, the normalised value cast back
    to x's dtype, then scaled by the weight cast to x's dtype (an f32
    scale never promotes a bf16 activation). Kernel A
    (``ops.fused_norm``) on the card, its plain version on the CPU.

    ``residual`` (the port's fused form, ``nn.RMSNorm``'s): the norm of
    h = residual + x, returned as (out, h), the add inside kernel A. Under
    auto_cast the add is the JAX layer's own op, as there: it runs first,
    cast as "add" (so h takes the add's dtype, bf16 under O2), and the
    norm takes h as the black list casts it."""
    if residual is not None and casting():
        h = residual + x
        return _rms_norm(h, weight, epsilon, None), h
    return _rms_norm(x, weight, epsilon, residual)


rms_norm.amp_name = "rms_norm"


@amp_op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing ``normalized_shape`` dims (an int or a
    list), f32 statistics, output in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(-len(normalized_shape), 0))
    x32 = x.to(torch.float32)
    var, mean = torch.var_mean(x32, dim=axes, keepdim=True, correction=0)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
        if bias is not None:
            out = out + bias.to(x.dtype)
    return out


@amp_op("group_norm")
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Normalise [N, C, *spatial] over each of ``num_groups`` groups of
    channels and the spatial dims; channels-last inputs go through the
    channels-first form."""
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        nd = x.dim()
        out = group_norm(x.permute(0, nd - 1, *range(1, nd - 1)),
                         num_groups, weight, bias, epsilon)
        return out.permute(0, *range(2, nd), 1)
    n, c = x.shape[0], x.shape[1]
    g = x.to(torch.float32).reshape(n, num_groups, -1)
    var, mean = torch.var_mean(g, dim=2, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    out = out.to(x.dtype)
    shape = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return out
