"""Common functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/common.py``, with ``pad``, ``bilinear`` and
``fold`` of the JAX package's ``ops`` and ``functional/extra.py``):
``linear``, ``embedding``, the dropouts, ``interpolate``, ``one_hot``,
``normalize``, the similarities, pixel (un)shuffle, ``unfold`` /
``fold``, ``label_smooth`` and ``pad``, named entries of the amp hook
(``amp._hook.amp_op``) under the JAX ops' names.

The dropouts draw their keep masks as the attention's does: a generator
seeded with a seed drawn from the default chain in the forward
(``core.random.fresh_seed``), the port's counterpart of the key the JAX
op takes as an input; the two frameworks give different masks.
``interpolate`` computes ``jax.image.resize``: half-pixel centers in every
mode ("nearest" is torch's "nearest-exact"; "bilinear" / "bicubic" are
torch's antialiased kernels, whose weights are renormalised at the border
and whose cubic is Keys' with a = -0.5, as JAX's ``scale_and_translate``;
``align_corners`` is taken and not read, as in the JAX function)."""
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
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` [V, E] at the ids ``x``, as the JAX package's
    ``jnp.take`` (fill mode) gathers them: an id in [-V, V) reads its row,
    a negative one wrapping to ``id + V``; any other id reads a row of NaN
    in the weight's dtype, and its gradient is dropped. The index is
    clamped before the gather and the NaN rows selected after it, so no
    id can reach past the table (on the card that would be a device-side
    assert, which ends the CUDA context). An id equal to ``padding_idx``
    reads zeros and passes no gradient; ``sparse`` is taken and not read
    (the gradient is dense)."""
    idx = x.long()
    v = weight.shape[0]
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    rows = torch.nn.functional.embedding(idx.clamp(0, max(v - 1, 0)), weight)
    nan = torch.full((), float("nan"), dtype=weight.dtype,
                     device=weight.device)
    out = torch.where(valid[..., None], rows, nan)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


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


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: one draw an (N, C) pair."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


@amp_op("alpha_dropout")
def _alpha_dropout(x, p, seed):
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def alpha_dropout(x, p=0.5, training=True):
    """Dropout for SELU networks: a dropped element becomes -alpha *
    scale, then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p, _random.fresh_seed(x.device))


@amp_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """2-D resize of an NCHW (or NHWC) tensor to ``size`` or by
    ``scale_factor`` (each output size the int of input x factor), as the
    JAX package's ``jax.image.resize`` computes it (module docstring)."""
    modes = {"nearest": "nearest-exact", "bilinear": "bilinear",
             "linear": "bilinear", "bicubic": "bicubic"}
    if mode not in modes:
        raise ValueError(f"interpolate: mode {mode!r}; have {sorted(modes)}")
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    h, w = x.shape[2], x.shape[3]
    if size is not None:
        out_hw = (int(size[0]), int(size[1]))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor, scale_factor)
        out_hw = (int(h * sf[0]), int(w * sf[1]))
    if mode == "nearest":
        out = torch.nn.functional.interpolate(x, size=out_hw,
                                              mode="nearest-exact")
    else:
        out = torch.nn.functional.interpolate(
            x, size=out_hw, mode=modes[mode], align_corners=False,
            antialias=True)
    return out if data_format == "NCHW" else out.permute(0, 2, 3, 1)


upsample = interpolate


@amp_op("one_hot")
def one_hot(x, num_classes):
    """float32 [..., num_classes]; an id outside [0, num_classes) is a row
    of zeros, as ``jax.nn.one_hot`` makes it."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


@amp_op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12):
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


@amp_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


@amp_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


@amp_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    if data_format != "NCHW":
        return torch.nn.functional.pixel_shuffle(
            x.permute(0, 3, 1, 2), int(upscale_factor)).permute(0, 2, 3, 1)
    return torch.nn.functional.pixel_shuffle(x, int(upscale_factor))


@amp_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    if data_format != "NCHW":
        return torch.nn.functional.pixel_unshuffle(
            x.permute(0, 3, 1, 2), int(downscale_factor)).permute(0, 2, 3, 1)
    return torch.nn.functional.pixel_unshuffle(x, int(downscale_factor))


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a)
                                                             for a in v)


@amp_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: [N, C * kh * kw, L] (C major, then the kernel's rows and
    columns); a list ``paddings`` gives (h, w) by its first two entries,
    as in the JAX function."""
    pads = _pair(paddings)[:2]
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      _pair(dilations), pads, _pair(strides))


@amp_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the inverse of ``unfold``: overlapping patches summed."""
    return torch.nn.functional.fold(x, _pair(output_sizes),
                                    _pair(kernel_sizes), _pair(dilations),
                                    _pair(paddings), _pair(strides))


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@amp_op("bilinear")
def bilinear(x1, x2, weight, bias=None):
    """out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias), weight [out, in1,
    in2], accumulated in float32 and returned in x1's dtype."""
    out = torch.einsum("bi,oij,bj->bo", x1.to(torch.float32),
                       weight.to(torch.float32),
                       x2.to(torch.float32)).to(x1.dtype)
    return out if bias is None else out + bias


@amp_op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """paddle's pad: ``pad`` of 2 x ndim entries pads every dim in order
    ((lo, hi) of dim 0 first); a shorter one pads the trailing spatial
    dims, last dim first ([left, right, top, bottom] for NCHW; the spatial
    dims sit before the channel for a channels-last ``data_format``).
    ``mode``: "constant" (``value``), "reflect", "replicate", "circular"."""
    nd = x.dim()
    pad = [pad] * (2 * nd) if isinstance(pad, int) else [int(p) for p in pad]
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pad) // 2
        width = [(0, 0)] * nd
        dims = list(range(nd - n_sp, nd)) \
            if data_format in ("NCHW", "NCL", "NCDHW") \
            else list(range(nd - n_sp - 1, nd - 1))
        for j, d in enumerate(reversed(dims)):
            width[d] = (pad[2 * j], pad[2 * j + 1])
    first = next((d for d, w in enumerate(width) if w != (0, 0)), nd)
    flat = []
    for lo, hi in reversed(width[first:]):
        flat += [lo, hi]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, value=value)
    # torch's reflect / replicate / circular pad the trailing dims of an
    # (N, C, *dims) tensor: the leading dims fold into C
    y = x.reshape((1, -1) + tuple(x.shape[first:]))
    out = torch.nn.functional.pad(y, flat, mode=mode)
    return out.reshape(tuple(x.shape[:first]) + tuple(out.shape[2:]))
