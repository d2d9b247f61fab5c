"""Convolution layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/conv.py``): ``Conv1D`` / ``Conv2D`` / ``Conv3D``
with paddle's [out_channels, in_channels / groups, *kernel] weight, and
``Conv1DTranspose`` / ``Conv2DTranspose`` / ``Conv3DTranspose`` with
[in_channels, out_channels / groups, *kernel]. The weight is
``KaimingUniform`` over the fan-in (in_channels / groups x the kernel for
a convolution, in_channels x the kernel for a transposed one, as the JAX
layers count it) and the bias zero (``bias_attr=False`` leaves it out).
``padding_mode`` is taken and not read, as in the JAX layers."""
import torch

from ...core.device import DEFAULT_DEVICE
from .. import functional as F
from .. import initializer as I
from ..layer import create_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(torch.nn.Module):
    _spatial = 2
    _transposed = False
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 generator=None, device=DEFAULT_DEVICE, output_padding=0):
        super().__init__()
        n = self._spatial
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format or ("NCL", "NCHW", "NCDHW")[n - 1]
        fan_in = in_channels if self._transposed else in_channels // groups
        for k in self.kernel_size:
            fan_in *= k
        shape = (in_channels, out_channels // groups) if self._transposed \
            else (out_channels, in_channels // groups)
        kw = dict(generator=generator, device=device)
        self.weight = create_parameter(
            shape + self.kernel_size, weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in), **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_channels,), bias_attr, is_bias=True, **kw)

    def forward(self, x, output_size=None):
        if self._transposed:
            return type(self)._fn(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, output_size,
                                  self.data_format)
        return type(self)._fn(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups,
                              self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={list(self.kernel_size)}, stride={self.stride}")


class Conv1D(_ConvNd):
    _spatial, _fn = 1, staticmethod(F.conv1d)


class Conv2D(_ConvNd):
    _spatial, _fn = 2, staticmethod(F.conv2d)


class Conv3D(_ConvNd):
    _spatial, _fn = 3, staticmethod(F.conv3d)


class _ConvTransposeNd(_ConvNd):
    _transposed = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, generator, device,
                         output_padding)


class Conv2DTranspose(_ConvTransposeNd):
    _spatial, _fn = 2, staticmethod(F.conv2d_transpose)


class _ConvTransposeGD(_ConvTransposeNd):
    """Conv1DTranspose's and Conv3DTranspose's argument order: groups
    before dilation, as in the JAX layers."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 generator=None, device=DEFAULT_DEVICE):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, generator,
                         device)


class Conv1DTranspose(_ConvTransposeGD):
    _spatial, _fn = 1, staticmethod(F.conv1d_transpose)


class Conv3DTranspose(_ConvTransposeGD):
    _spatial, _fn = 3, staticmethod(F.conv3d_transpose)
