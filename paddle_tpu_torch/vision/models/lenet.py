"""LeNet of the PyTorch port (counterpart of
``paddle_tpu/vision/models/lenet.py``): for 1 x 28 x 28 inputs."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["LeNet"]


class LeNet(torch.nn.Module):
    def __init__(self, num_classes=10, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **init),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **init),
            nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, **init),
                nn.Linear(120, 84, **init),
                nn.Linear(84, num_classes, **init))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
