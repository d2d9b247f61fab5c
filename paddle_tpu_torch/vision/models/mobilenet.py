"""MobileNetV1 of the PyTorch port (counterpart of
``paddle_tpu/vision/models/mobilenet.py``): depthwise-separable blocks,
``scale`` the width multiplier (at least 8 channels a layer)."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["MobileNetV1", "mobilenet_v1"]


class _ConvBNRelu(torch.nn.Module):
    def __init__(self, in_c, out_c, kernel=3, stride=1, padding=1, groups=1,
                 **init):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, **init)
        self.bn = nn.BatchNorm2D(out_c, **init)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _DepthwiseSep(torch.nn.Module):
    def __init__(self, in_c, out_c, stride, **init):
        super().__init__()
        self.dw = _ConvBNRelu(in_c, in_c, 3, stride=stride, padding=1,
                              groups=in_c, **init)
        self.pw = _ConvBNRelu(in_c, out_c, 1, stride=1, padding=0, **init)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(v):
            return max(int(v * scale), 8)

        cfg = [(c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
               (c(128), c(256), 2), (c(256), c(256), 1), (c(256), c(512), 2),
               *[(c(512), c(512), 1)] * 5,
               (c(512), c(1024), 2), (c(1024), c(1024), 1)]
        layers = [_ConvBNRelu(3, c(32), 3, stride=2, padding=1, **init)]
        for in_c, out_c, s in cfg:
            layers.append(_DepthwiseSep(in_c, out_c, s, **init))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes, **init)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
