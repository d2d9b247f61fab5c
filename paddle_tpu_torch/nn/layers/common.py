"""Common layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/common.py``), as ``torch.nn.Module``s: Linear,
Embedding, the dropouts, Identity, Flatten, the upsamplers, pixel
(un)shuffle, the pads, the similarities, Unfold / Fold and Bilinear.

Parameters follow ``nn.layer.create_parameter``'s rule with the JAX
layers' defaults, drawn on ``device`` from ``generator`` (None: one
seeded from the port's default chain). The two frameworks give different
numbers for one seed, so parity tests load the JAX model's weights
instead (``models.state_from_numpy``). The Llama model builds its
layers in the older form ``(in, out, std, generator, device)``: a
Normal(0, std) weight and, for ``Linear``, no bias."""
import torch

from ...core.device import DEFAULT_DEVICE
from .. import functional as F
from .. import initializer as I
from ..layer import ParamAttr, create_parameter


def normal_(shape, std, generator, device):
    """A float32 tensor of ``shape`` from Normal(0, std) on ``device``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, std, generator=generator)


def _std_attr(std, attr):
    """``weight_attr``, or Normal(0, std) when only ``std`` is given."""
    if std is None or attr is not None:
        return attr
    return ParamAttr(initializer=I.Normal(0.0, std))


class Linear(torch.nn.Module):
    """paddle's linear layer with its [in_features, out_features] weight:
    ``x @ weight + bias``. The JAX defaults: an XavierNormal weight and a
    zero bias; ``bias_attr=False`` leaves the bias out. Given ``std`` (the
    Llama form) the weight is Normal(0, std) and there is no bias unless
    ``bias_attr`` asks for one."""

    def __init__(self, in_features, out_features, std=None, generator=None,
                 device=DEFAULT_DEVICE, weight_attr=None, bias_attr=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter(
            (in_features, out_features), _std_attr(std, weight_attr),
            default_initializer=I.XavierNormal(), generator=generator,
            device=device)
        if bias_attr is False or (std is not None and bias_attr is None):
            self.bias = None
        else:
            self.bias = create_parameter((out_features,), bias_attr,
                                         is_bias=True, generator=generator,
                                         device=device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Dropout(torch.nn.Module):
    """``F.dropout`` while the module trains."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Embedding(torch.nn.Module):
    """Lookup table [num_embeddings, embedding_dim], Normal(0, 1) by
    default as the JAX layer's (Normal(0, std) given ``std``); an id
    outside [-num_embeddings, num_embeddings) reads a NaN row
    (``F.embedding``); an id equal to ``padding_idx`` reads zeros."""

    def __init__(self, num_embeddings, embedding_dim, std=None,
                 generator=None, device=DEFAULT_DEVICE, weight_attr=None,
                 padding_idx=None, sparse=False, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), _std_attr(std, weight_attr),
            default_initializer=I.Normal(0.0, 1.0), generator=generator,
            device=device)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Identity(torch.nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(torch.nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(torch.nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(torch.nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(torch.nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Upsample(torch.nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class PixelShuffle(torch.nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(torch.nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class Pad2D(torch.nn.Module):
    """``F.pad`` with the layer's spec ([left, right, top, bottom] for
    NCHW); ``Pad1D`` and ``Pad3D`` are this layer, as in the JAX
    package."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


Pad1D = Pad2D
Pad3D = Pad2D


class ZeroPad2D(torch.nn.Module):
    """Zeros around the spatial dims: ``padding`` an int or [left, right,
    top, bottom]."""

    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._padding = padding
        self._data_format = data_format

    def forward(self, x):
        p = self._padding
        if isinstance(p, int):
            p = [p, p, p, p]
        spec = [0, 0, 0, 0, p[2], p[3], p[0], p[1]] \
            if self._data_format == "NCHW" \
            else [0, 0, p[2], p[3], p[0], p[1], 0, 0]
        return F.pad(x, spec)


class CosineSimilarity(torch.nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(torch.nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, p=self.p, epsilon=self.epsilon,
                                   keepdim=self.keepdim)


class Unfold(torch.nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(torch.nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class Bilinear(torch.nn.Module):
    """x1 W x2 + b: W [out, in1, in2] (XavierNormal), b [out] (zeros;
    ``bias_attr=False`` leaves it out)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr, **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)
