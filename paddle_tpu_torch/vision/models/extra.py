"""SqueezeNet, DenseNet, GoogLeNet, ShuffleNetV2 and the wide ResNets of
the PyTorch port (counterpart of ``paddle_tpu/vision/models/extra.py``).
The constructors take ``**kw`` (``num_classes``, ``device``, ``seed``,
``generator``), as the JAX ones do."""
import torch

from ...core.device import DEFAULT_DEVICE
from ... import nn
from ...nn import functional as F

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "DenseNet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "densenet264", "GoogLeNet", "googlenet", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "wide_resnet50_2",
           "wide_resnet101_2"]


# -- SqueezeNet ----------------------------------------------------------

class Fire(torch.nn.Module):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c, **init):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1, **init)
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1, **init)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1, **init)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))],
                         dim=1)


class SqueezeNet(torch.nn.Module):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.num_classes = num_classes
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, **init), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64, **init), Fire(128, 16, 64, 64, **init),
                Fire(128, 32, 128, 128, **init), nn.MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128, **init),
                Fire(256, 48, 192, 192, **init),
                Fire(384, 48, 192, 192, **init),
                Fire(384, 64, 256, 256, **init),
                nn.MaxPool2D(3, stride=2), Fire(512, 64, 256, 256, **init))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, **init), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64, **init), Fire(128, 16, 64, 64, **init),
                nn.MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128, **init),
                Fire(256, 32, 128, 128, **init),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192, **init),
                Fire(384, 48, 192, 192, **init),
                Fire(384, 64, 256, 256, **init),
                Fire(512, 64, 256, 256, **init))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1, **init),
            nn.ReLU(), nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return torch.flatten(self.classifier(self.features(x)), 1)


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)


# -- DenseNet ------------------------------------------------------------

class _DenseLayer(torch.nn.Module):
    def __init__(self, in_c, growth, bn_size, **init):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_c, **init)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False,
                               **init)
        self.norm2 = nn.BatchNorm2D(bn_size * growth, **init)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False, **init)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class _Transition(torch.nn.Module):
    def __init__(self, in_c, out_c, **init):
        super().__init__()
        self.norm = nn.BatchNorm2D(in_c, **init)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False, **init)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(F.relu(self.norm(x))))


class DenseNet(torch.nn.Module):
    def __init__(self, layers=121, growth_rate=32, bn_size=4,
                 num_classes=1000, with_pool=True, device=DEFAULT_DEVICE,
                 seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        cfgs = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
                264: (6, 12, 64, 48)}
        block_cfg = cfgs[layers]
        num_init = 2 * growth_rate
        feats = [nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                           bias_attr=False, **init),
                 nn.BatchNorm2D(num_init, **init), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = num_init
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth_rate, bn_size, **init))
                ch += growth_rate
            if i != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2, **init))
                ch //= 2
        feats += [nn.BatchNorm2D(ch, **init), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(ch, num_classes, **init)

    def forward(self, x):
        return self.classifier(torch.flatten(self.pool(self.features(x)), 1))


def densenet121(**kw):
    return DenseNet(121, **kw)


def densenet161(**kw):
    return DenseNet(161, growth_rate=48, **kw)


def densenet169(**kw):
    return DenseNet(169, **kw)


def densenet201(**kw):
    return DenseNet(201, **kw)


def densenet264(**kw):
    return DenseNet(264, **kw)


# -- GoogLeNet (Inception v1) ----------------------------------------------

class Inception(torch.nn.Module):
    def __init__(self, in_c, c1, c2, c3, c4, **init):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_c, c1, 1, **init), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_c, c2[0], 1, **init), nn.ReLU(),
                                nn.Conv2D(c2[0], c2[1], 3, padding=1, **init),
                                nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_c, c3[0], 1, **init), nn.ReLU(),
                                nn.Conv2D(c3[0], c3[1], 5, padding=2, **init),
                                nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(in_c, c4, 1, **init), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class GoogLeNet(torch.nn.Module):
    def __init__(self, num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, **init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
            nn.Conv2D(64, 64, 1, **init), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1, **init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.blocks = nn.Sequential(
            Inception(192, 64, (96, 128), (16, 32), 32, **init),
            Inception(256, 128, (128, 192), (32, 96), 64, **init),
            nn.MaxPool2D(3, stride=2, padding=1),
            Inception(480, 192, (96, 208), (16, 48), 64, **init),
            Inception(512, 160, (112, 224), (24, 64), 64, **init),
            Inception(512, 128, (128, 256), (24, 64), 64, **init),
            Inception(512, 112, (144, 288), (32, 64), 64, **init),
            Inception(528, 256, (160, 320), (32, 128), 128, **init),
            nn.MaxPool2D(3, stride=2, padding=1),
            Inception(832, 256, (160, 320), (32, 128), 128, **init),
            Inception(832, 384, (192, 384), (48, 128), 128, **init))
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.dropout = nn.Dropout(0.2)
        self.fc = nn.Linear(1024, num_classes, **init)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        return self.fc(self.dropout(torch.flatten(self.pool(x), 1)))


def googlenet(**kw):
    return GoogLeNet(**kw)


# -- ShuffleNetV2 ----------------------------------------------------------

def _channel_shuffle(x, groups):
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(b, c, h, w)


class _ShuffleUnit(torch.nn.Module):
    def __init__(self, in_c, out_c, stride, **init):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 2:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=2, padding=1, groups=in_c,
                          bias_attr=False, **init),
                nn.BatchNorm2D(in_c, **init),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False, **init),
                nn.BatchNorm2D(branch_c, **init), nn.ReLU())
            b2_in = in_c
        else:
            self.branch1 = None
            b2_in = in_c // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch_c, 1, bias_attr=False, **init),
            nn.BatchNorm2D(branch_c, **init), nn.ReLU(),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False, **init),
            nn.BatchNorm2D(branch_c, **init),
            nn.Conv2D(branch_c, branch_c, 1, bias_attr=False, **init),
            nn.BatchNorm2D(branch_c, **init), nn.ReLU())

    def forward(self, x):
        if self.stride == 2:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        else:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch2(x[:, half:])], dim=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=DEFAULT_DEVICE, seed=0, generator=None):
        super().__init__()
        init = nn.model_init(device, seed, generator)
        stage_out = {0.25: (24, 48, 96, 512), 0.33: (32, 64, 128, 512),
                     0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
                     1.5: (176, 352, 704, 1024),
                     2.0: (244, 488, 976, 2048)}[scale]
        self.stem = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False,
                      **init),
            nn.BatchNorm2D(24, **init), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
        in_c = 24
        stages = []
        for out_c, repeat in zip(stage_out[:3], (4, 8, 4)):
            stages.append(_ShuffleUnit(in_c, out_c, 2, **init))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(out_c, out_c, 1, **init))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.tail = nn.Sequential(
            nn.Conv2D(in_c, stage_out[3], 1, bias_attr=False, **init),
            nn.BatchNorm2D(stage_out[3], **init), nn.ReLU())
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(stage_out[3], num_classes, **init)

    def forward(self, x):
        x = self.tail(self.stages(self.stem(x)))
        return self.fc(torch.flatten(self.pool(x), 1))


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_33(**kw):
    return ShuffleNetV2(0.33, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(2.0, **kw)


def shufflenet_v2_swish(**kw):
    """ShuffleNetV2 1.0x with every ReLU swapped for Swish."""
    net = ShuffleNetV2(1.0, **kw)

    def swap(layer):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, nn.ReLU):
                setattr(layer, name, nn.Swish())
            else:
                swap(sub)
    swap(net)
    return net


# -- wide ResNet -------------------------------------------------------------

def wide_resnet50_2(**kw):
    from .resnet import BottleneckBlock, ResNet
    return ResNet(BottleneckBlock, 50, width=128, **kw)


def wide_resnet101_2(**kw):
    from .resnet import BottleneckBlock, ResNet
    return ResNet(BottleneckBlock, 101, width=128, **kw)
