"""Common functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/common.py``): ``linear``, ``embedding``,
``dropout`` and ``interpolate``, named entries of the amp hook
(``amp._hook.amp_op``) under the JAX ops' names.

``dropout`` draws its keep mask as the attention's does: a generator
seeded with a seed drawn from the default chain in the forward
(``core.random.fresh_seed``), the port's counterpart of the key the JAX
op takes as an input; the two frameworks give different masks.
``interpolate`` takes the nearest mode, at a size or a scale factor:
``jax.image.resize``'s nearest samples at half-pixel centers, which is
torch's "nearest-exact"."""
import threading

import torch

from ...amp._hook import amp_op
from ...core import random as _random

# the pipeline's weight-gradient split (ZB-H1): while a thread is inside
# ``distributed.fleet.pipeline_parallel.split_weight_grad``, its ``fn``
# computes this thread's linears
weight_grad_split = threading.local()


def plain_linear(x, weight):
    """``x @ weight`` with the JAX package's dtype promotion."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return torch.matmul(x.to(dtype), weight.to(dtype))


@amp_op("linear")
def linear(x, weight, bias=None):
    """paddle convention: weight is [in_features, out_features], so this
    is ``x @ weight`` (+ ``bias``). Mixed dtypes promote as in the JAX
    package (a bf16 activation against an f32 weight computes in f32, and
    an f32 bias promotes a bf16 product); torch's matmul would refuse
    them. Inside ``split_weight_grad`` the weight's gradient is deferred
    (``fleet.pipeline_parallel``)."""
    split = getattr(weight_grad_split, "fn", None)
    out = split(x, weight) if split is not None else plain_linear(x, weight)
    return out if bias is None else out + bias


@amp_op("embedding")
def embedding(x, weight):
    """Rows of ``weight`` [V, E] at the ids ``x``, as the JAX package's
    ``jnp.take`` (fill mode) gathers them: an id in [-V, V) reads its row,
    a negative one wrapping to ``id + V``; any other id reads a row of NaN
    in the weight's dtype, and its gradient is dropped. The index is
    clamped before the gather and the NaN rows selected after it, so no
    id can reach past the table (on the card that would be a device-side
    assert, which ends the CUDA context)."""
    idx = x.long()
    v = weight.shape[0]
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    rows = torch.nn.functional.embedding(idx.clamp(0, max(v - 1, 0)), weight)
    nan = torch.full((), float("nan"), dtype=weight.dtype,
                     device=weight.device)
    return torch.where(valid[..., None], rows, nan)


@amp_op("dropout")
def _dropout(x, p, axis, mode, seed):
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """paddle's dropout: in training each element (or each slice along
    ``axis``) is kept with probability 1 - p, scaled by 1 / (1 - p) in
    "upscale_in_train" mode; out of training the input, times 1 - p in
    "downscale_in_infer" mode."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    return _dropout(x, p, axis, mode, _random.fresh_seed(x.device))


@amp_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """2-D nearest resize of an NCHW (or NHWC) tensor to ``size`` or by
    ``scale_factor``, as the JAX package's ``jax.image.resize`` computes
    it. The other modes raise (ROADMAP Queue 1 item 10)."""
    if mode != "nearest":
        raise NotImplementedError(
            f"interpolate: mode {mode!r}; the port has the nearest mode")
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    h, w = x.shape[2], x.shape[3]
    if size is not None:
        out_hw = (int(size[0]), int(size[1]))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor, scale_factor)
        out_hw = (int(h * sf[0]), int(w * sf[1]))
    out = torch.nn.functional.interpolate(x, size=out_hw,
                                          mode="nearest-exact")
    return out if data_format == "NCHW" else out.permute(0, 2, 3, 1)
