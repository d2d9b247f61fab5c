"""Conv2D layer of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/conv.py``): paddle's [out_channels, in_channels /
groups, kh, kw] weight, ``KaimingUniform`` over the fan-in by default,
and a zero bias (``bias_attr=False`` leaves it out)."""
import torch

from ...core.device import DEFAULT_DEVICE
from .. import functional as F
from .. import initializer as I
from ..layer import create_parameter


class Conv2D(torch.nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        fan_in = in_channels // groups * self.kernel_size[0] \
            * self.kernel_size[1]
        kw = dict(generator=generator, device=device)
        self.weight = create_parameter(
            (out_channels, in_channels // groups, *self.kernel_size),
            weight_attr, default_initializer=I.KaimingUniform(fan_in=fan_in),
            **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_channels,), bias_attr, is_bias=True, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={list(self.kernel_size)}, stride={self.stride}")
