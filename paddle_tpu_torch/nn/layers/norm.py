"""RMSNorm, LayerNorm and GroupNorm layers of the PyTorch port
(counterpart of ``paddle_tpu/nn/layers/norm.py``). LayerNorm's and
GroupNorm's scale is ``Constant(1)`` and their shift zero by default, as
the JAX layers' (``weight_attr`` / ``bias_attr``: a ``ParamAttr``, or
False to leave it out)."""
import torch

from ...core.device import DEFAULT_DEVICE, resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer import create_parameter


class RMSNorm(torch.nn.Module):
    """RMSNorm with a float32 scale initialised to 1.0, built on ``device``
    (default "cuda", which raises without a GPU)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=DEFAULT_DEVICE):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, dtype=torch.float32,
                       device=resolve_device(device)))

    def forward(self, x, residual=None):
        """RMSNorm of x, or with ``residual`` of h = x + residual (rounded
        to x's dtype): then (out, h), the add handed to the norm's kernel
        (the JAX layer's ``residual + hidden_states`` before the next
        norm). The scale is cast to the activation's dtype either way.
        Through ``F.rms_norm``, the amp hook's named entry."""
        return F.rms_norm(x, self.weight, self.epsilon, residual=residual)


class LayerNorm(torch.nn.Module):
    """``F.layer_norm`` over the trailing ``normalized_shape`` dims."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = dict(generator=generator, device=device)
        self.weight = None if weight_attr is False else create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), **kw)
        self.bias = None if bias_attr is False else create_parameter(
            self.normalized_shape, bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class GroupNorm(torch.nn.Module):
    """``F.group_norm`` over ``num_groups`` groups of ``num_channels``;
    ``weight_attr=False`` leaves out both the scale and the shift, as the
    JAX layer does."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        kw = dict(generator=generator, device=device)
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = create_parameter(
                (num_channels,), weight_attr,
                default_initializer=I.Constant(1.0), **kw)
            self.bias = create_parameter((num_channels,), bias_attr,
                                         is_bias=True, **kw)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)

    def extra_repr(self):
        return f"num_groups={self.num_groups}, num_channels={self.num_channels}"
