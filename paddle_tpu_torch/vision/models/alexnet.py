"""AlexNet of the PyTorch port (counterpart of
``paddle_tpu/vision/models/alexnet.py``)."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(torch.nn.Module):
    def __init__(self, num_classes=1000, dropout=0.5, device=DEFAULT_DEVICE,
                 seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2, **init), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2, **init), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1, **init), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1, **init), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1, **init), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(256 * 36, 4096, **init),
            nn.ReLU(), nn.Dropout(dropout), nn.Linear(4096, 4096, **init),
            nn.ReLU(), nn.Linear(4096, num_classes, **init))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
