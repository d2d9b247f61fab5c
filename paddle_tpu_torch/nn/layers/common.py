"""Linear, Dropout and Embedding layers of the PyTorch port (counterpart
of ``paddle_tpu/nn/layers/common.py``), as ``torch.nn.Module``s.

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
    (``F.embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, std=None,
                 generator=None, device=DEFAULT_DEVICE, weight_attr=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), _std_attr(std, weight_attr),
            default_initializer=I.Normal(0.0, 1.0), generator=generator,
            device=device)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
