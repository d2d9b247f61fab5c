"""MobileNetV2 of the PyTorch port (counterpart of
``paddle_tpu/vision/models/mobilenetv2.py``): inverted residuals with
linear bottlenecks."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["InvertedResidual", "MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU6(torch.nn.Module):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, **init):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias_attr=False, **init)
        self.bn = nn.BatchNorm2D(out_c, **init)
        self.act = nn.ReLU6()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class InvertedResidual(torch.nn.Module):
    def __init__(self, in_c, out_c, stride, expand_ratio, **init):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU6(in_c, hidden, 1, **init))
        layers += [
            _ConvBNReLU6(hidden, hidden, 3, stride=stride, groups=hidden,
                         **init),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False, **init),
            nn.BatchNorm2D(out_c, **init),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        feats = [_ConvBNReLU6(3, in_c, 3, stride=2, **init)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(in_c, out_c,
                                              s if i == 0 else 1, t, **init))
                in_c = out_c
        feats.append(_ConvBNReLU6(in_c, last, 1, **init))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes, **init))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
