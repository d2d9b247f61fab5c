"""ResNet family of the PyTorch port (counterpart of
``paddle_tpu/vision/models/resnet.py``): ResNet 18-152 and ResNeXt, with
the JAX layers' names (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``, ..., ``fc``), so parameters and the batch
norms' ``_mean`` / ``_variance`` carry across by name
(``models.state_from_numpy``). Every constructor takes ``device``
(default "cuda"), ``seed`` and ``generator`` for its weights, and
``pretrained``, which is accepted and not read: nothing is downloaded,
as in the JAX constructors."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 **init):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **init)
        self.bn1 = norm_layer(planes, **init)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **init)
        self.bn2 = norm_layer(planes, **init)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 **init):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **init)
        self.bn1 = norm_layer(width, **init)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False, **init)
        self.bn2 = norm_layer(width, **init)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **init)
        self.bn3 = norm_layer(planes * self.expansion, **init)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=DEFAULT_DEVICE, seed=0,
                 generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **init)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **init)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, init)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, init)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, init)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, init)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **init)

    def _make_layer(self, block, planes, blocks, stride, init):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **init),
                nn.BatchNorm2D(planes * block.expansion, **init))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **init)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **init))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, groups=64, width=4, **kwargs)
