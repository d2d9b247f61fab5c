"""MobileNetV3 small / large of the PyTorch port (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``): inverted residuals with
squeeze-excite (Paddle's ``hardsigmoid``, slope 0.1666667) and
hard-swish."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn
from ...nn import functional as F
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
           "mobilenet_v3_small"]


class SqueezeExcite(torch.nn.Module):
    def __init__(self, ch, squeeze=4, **init):
        super().__init__()
        mid = _make_divisible(ch // squeeze)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1, **init)
        self.fc2 = nn.Conv2D(mid, ch, 1, **init)

    def forward(self, x):
        s = self.pool(x)
        s = F.relu(self.fc1(s))
        s = F.hardsigmoid(self.fc2(s))
        return x * s


class _ConvBNAct(torch.nn.Module):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 act="hardswish", **init):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias_attr=False, **init)
        self.bn = nn.BatchNorm2D(out_c, **init)
        self.act = {"relu": nn.ReLU, "hardswish": nn.Hardswish,
                    None: lambda: None}[act]()

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class InvertedResidualV3(torch.nn.Module):
    def __init__(self, in_c, mid_c, out_c, kernel, stride, use_se, act,
                 **init):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if mid_c != in_c:
            layers.append(_ConvBNAct(in_c, mid_c, 1, act=act, **init))
        layers.append(_ConvBNAct(mid_c, mid_c, kernel, stride=stride,
                                 groups=mid_c, act=act, **init))
        if use_se:
            layers.append(SqueezeExcite(mid_c, **init))
        layers.append(_ConvBNAct(mid_c, out_c, 1, act=None, **init))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_LARGE = [  # k, mid, out, se, act, s
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]

_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class MobileNetV3(torch.nn.Module):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        feats = [_ConvBNAct(3, in_c, 3, stride=2, act="hardswish", **init)]
        for k, mid, out, se, act, s in config:
            mid_c = _make_divisible(mid * scale)
            out_c = _make_divisible(out * scale)
            feats.append(InvertedResidualV3(in_c, mid_c, out_c, k, s, se,
                                            act, **init))
            in_c = out_c
        last_conv = _make_divisible(6 * in_c)
        feats.append(_ConvBNAct(in_c, last_conv, 1, act="hardswish", **init))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel, **init), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes, **init))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool,
                         **kwargs)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool,
                         **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)
