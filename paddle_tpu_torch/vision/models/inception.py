"""InceptionV3 of the PyTorch port (counterpart of
``paddle_tpu/vision/models/inception.py``): NCHW at 299 x 299, without
the auxiliary head, as the JAX model."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["InceptionV3", "inception_v3"]


class _ConvBNAct(torch.nn.Module):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, **init):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, bias_attr=False, **init)
        self.bn = nn.BatchNorm2D(out_c, **init)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _InceptionA(torch.nn.Module):
    def __init__(self, in_c, pool_features, **init):
        super().__init__()
        self.b1 = _ConvBNAct(in_c, 64, 1, **init)
        self.b5 = nn.Sequential(_ConvBNAct(in_c, 48, 1, **init),
                                _ConvBNAct(48, 64, 5, padding=2, **init))
        self.b3 = nn.Sequential(_ConvBNAct(in_c, 64, 1, **init),
                                _ConvBNAct(64, 96, 3, padding=1, **init),
                                _ConvBNAct(96, 96, 3, padding=1, **init))
        self.pool_proj = _ConvBNAct(in_c, pool_features, 1, **init)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x),
                          self.pool_proj(self.pool(x))], dim=1)


class _InceptionB(torch.nn.Module):
    """Grid reduction 35 -> 17."""

    def __init__(self, in_c, **init):
        super().__init__()
        self.b3 = _ConvBNAct(in_c, 384, 3, stride=2, **init)
        self.b3d = nn.Sequential(_ConvBNAct(in_c, 64, 1, **init),
                                 _ConvBNAct(64, 96, 3, padding=1, **init),
                                 _ConvBNAct(96, 96, 3, stride=2, **init))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class _InceptionC(torch.nn.Module):
    """Factorised 7 x 7 branches at 17 x 17."""

    def __init__(self, in_c, c7, **init):
        super().__init__()
        self.b1 = _ConvBNAct(in_c, 192, 1, **init)
        self.b7 = nn.Sequential(
            _ConvBNAct(in_c, c7, 1, **init),
            _ConvBNAct(c7, c7, (1, 7), padding=(0, 3), **init),
            _ConvBNAct(c7, 192, (7, 1), padding=(3, 0), **init))
        self.b7d = nn.Sequential(
            _ConvBNAct(in_c, c7, 1, **init),
            _ConvBNAct(c7, c7, (7, 1), padding=(3, 0), **init),
            _ConvBNAct(c7, c7, (1, 7), padding=(0, 3), **init),
            _ConvBNAct(c7, c7, (7, 1), padding=(3, 0), **init),
            _ConvBNAct(c7, 192, (1, 7), padding=(0, 3), **init))
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.pool_proj = _ConvBNAct(in_c, 192, 1, **init)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x),
                          self.pool_proj(self.pool(x))], dim=1)


class _InceptionD(torch.nn.Module):
    """Grid reduction 17 -> 8."""

    def __init__(self, in_c, **init):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBNAct(in_c, 192, 1, **init),
                                _ConvBNAct(192, 320, 3, stride=2, **init))
        self.b7x3 = nn.Sequential(
            _ConvBNAct(in_c, 192, 1, **init),
            _ConvBNAct(192, 192, (1, 7), padding=(0, 3), **init),
            _ConvBNAct(192, 192, (7, 1), padding=(3, 0), **init),
            _ConvBNAct(192, 192, 3, stride=2, **init))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7x3(x), self.pool(x)], dim=1)


class _InceptionE(torch.nn.Module):
    def __init__(self, in_c, **init):
        super().__init__()
        self.b1 = _ConvBNAct(in_c, 320, 1, **init)
        self.b3_stem = _ConvBNAct(in_c, 384, 1, **init)
        self.b3_a = _ConvBNAct(384, 384, (1, 3), padding=(0, 1), **init)
        self.b3_b = _ConvBNAct(384, 384, (3, 1), padding=(1, 0), **init)
        self.b3d_stem = nn.Sequential(
            _ConvBNAct(in_c, 448, 1, **init),
            _ConvBNAct(448, 384, 3, padding=1, **init))
        self.b3d_a = _ConvBNAct(384, 384, (1, 3), padding=(0, 1), **init)
        self.b3d_b = _ConvBNAct(384, 384, (3, 1), padding=(1, 0), **init)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)
        self.pool_proj = _ConvBNAct(in_c, 192, 1, **init)

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return torch.cat([
            self.b1(x),
            torch.cat([self.b3_a(s), self.b3_b(s)], dim=1),
            torch.cat([self.b3d_a(d), self.b3d_b(d)], dim=1),
            self.pool_proj(self.pool(x))], dim=1)


class InceptionV3(torch.nn.Module):
    def __init__(self, num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBNAct(3, 32, 3, stride=2, **init),
            _ConvBNAct(32, 32, 3, **init),
            _ConvBNAct(32, 64, 3, padding=1, **init),
            nn.MaxPool2D(3, stride=2),
            _ConvBNAct(64, 80, 1, **init),
            _ConvBNAct(80, 192, 3, **init),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32, **init), _InceptionA(256, 64, **init),
            _InceptionA(288, 64, **init),
            _InceptionB(288, **init),
            _InceptionC(768, 128, **init), _InceptionC(768, 160, **init),
            _InceptionC(768, 160, **init), _InceptionC(768, 192, **init),
            _InceptionD(768, **init),
            _InceptionE(1280, **init), _InceptionE(2048, **init))
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes, **init)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
