"""Normalisation functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``rms_norm`` (kernel A),
``layer_norm``, ``group_norm``, ``batch_norm``, ``instance_norm`` and
``local_response_norm``, named entries of the amp hook
(``amp._hook.amp_op``; all but the last on its black list).

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


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1


@torch.no_grad()
def _update_running(running, batch, momentum):
    running.mul_(momentum).add_(batch.to(running.dtype), alpha=1 - momentum)


@amp_op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """paddle's batch norm (the JAX package's semantics): batch statistics
    over every axis but the channel's, and the running statistics updated
    in place as ``m * running + (1 - m) * batch`` with the BIASED batch
    variance (``momentum`` 0.9 keeps 90 % of the old value); the running
    statistics normalise instead out of training, or with
    ``use_global_stats``. ``torch.nn.functional.batch_norm`` (cuDNN on the
    card) computes the normalisation; torch keeps the opposite momentum
    and the unbiased variance, so it is called with momentum 1 on scratch
    vectors, which then hold the batch mean and unbiased variance, and
    the update here converts the variance back (n - 1) / n. A batch of
    one element a channel (torch refuses it) takes the statistics
    directly, as the JAX op does. Unlike the JAX op, which skips the
    update under tracing, the port updates in every training call."""
    if use_global_stats is None:
        use_global_stats = not training
    ch = _channel_axis(x, data_format)
    xc = x if ch == 1 else x.movedim(ch, 1)
    if use_global_stats:
        out = torch.nn.functional.batch_norm(
            xc, running_mean, running_var, weight, bias, False, 0.0,
            epsilon)
    else:
        c = xc.shape[1] if xc.dim() > 1 else xc.shape[0]
        n = xc.numel() // max(c, 1)
        if n > 1:
            stat = torch.float64 if x.dtype == torch.float64 \
                else torch.float32
            mean = torch.zeros(c, dtype=stat, device=x.device)
            var = torch.ones(c, dtype=stat, device=x.device)
            out = torch.nn.functional.batch_norm(
                xc, mean, var, weight, bias, True, 1.0, epsilon)
            var = var * ((n - 1) / n)
        else:
            axes = [i for i in range(xc.dim()) if i != 1]
            var, mean = torch.var_mean(xc, dim=axes, correction=0)
            shape = [1, c] + [1] * (xc.dim() - 2)
            out = (xc - mean.reshape(shape)) \
                * torch.rsqrt(var.reshape(shape) + epsilon)
            if weight is not None:
                out = out * weight.reshape(shape) + bias.reshape(shape)
        if running_mean is not None:
            _update_running(running_mean, mean, momentum)
            _update_running(running_var, var, momentum)
    return out if ch == 1 else out.movedim(1, ch)


@amp_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Normalise each sample's channel over its spatial dims (biased
    variance); the running statistics are taken and not read or written,
    as in the JAX op. A channels-last ``data_format`` goes through the
    channels-first form (the JAX op reads every input channels first)."""
    if not data_format.startswith("NC"):
        return instance_norm(x.movedim(-1, 1), None, None, weight, bias,
                             eps=eps).movedim(1, -1)
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return out


@amp_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """x / (k + alpha * sum of x^2 over a window of ``size`` channels) **
    beta, the window from c - size // 2 to c + (size - 1) // 2 (zeros
    past the ends). A channels-last ``data_format`` goes through the
    channels-first form, as in ``instance_norm``."""
    if not data_format.startswith("NC"):
        return local_response_norm(x.movedim(-1, 1), size, alpha, beta,
                                   k).movedim(1, -1)
    half = size // 2
    sq = torch.nn.functional.pad(
        x * x, (0, 0) * (x.dim() - 2) + (half, size - 1 - half))
    c = x.shape[1]
    acc = sq.narrow(1, 0, c)
    for i in range(1, size):
        acc = acc + sq.narrow(1, i, c)
    return x / (k + alpha * acc) ** beta
