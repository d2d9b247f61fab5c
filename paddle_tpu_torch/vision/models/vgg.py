"""VGG of the PyTorch port (counterpart of
``paddle_tpu/vision/models/vgg.py``): VGG 11 / 13 / 16 / 19, with or
without batch norm."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, init):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1, **init))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, **init))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(torch.nn.Module):
    """``features`` a ``Sequential`` of the config's layers, or the config's
    name ("A", "B", "D", "E") to build them from ``init``."""

    def __init__(self, features, num_classes=1000, dropout=0.5,
                 batch_norm=False, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        if isinstance(features, str):
            features = _make_features(_CFGS[features], batch_norm, init)
        self.features = features
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 49, 4096, **init), nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(4096, 4096, **init), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(4096, num_classes, **init))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG("A", batch_norm=batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG("B", batch_norm=batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG("D", batch_norm=batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG("E", batch_norm=batch_norm, **kwargs)
