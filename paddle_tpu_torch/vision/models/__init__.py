"""The vision model zoo of the PyTorch port (counterpart of
``paddle_tpu/vision/models``): LeNet, ResNet / ResNeXt / wide ResNet,
VGG, MobileNet v1-v3, AlexNet, SqueezeNet, DenseNet, GoogLeNet,
ShuffleNetV2 and InceptionV3. Parameter and buffer names equal the JAX
models' (``jit.functional.state_arrays``), so weights and batch-norm
statistics carry across (``models.state_from_numpy``). Every model is
built on ``device`` (default "cuda") from ``generator``, or from one
seeded with ``seed``; ``pretrained`` is accepted and not read."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .extra import (  # noqa: F401
    DenseNet, GoogLeNet, ShuffleNetV2, SqueezeNet, densenet121, densenet161,
    densenet169, densenet201, densenet264, googlenet, shufflenet_v2_swish,
    shufflenet_v2_x0_25, shufflenet_v2_x0_33, shufflenet_v2_x0_5,
    shufflenet_v2_x1_0, shufflenet_v2_x1_5, shufflenet_v2_x2_0,
    squeezenet1_0, squeezenet1_1, wide_resnet50_2, wide_resnet101_2)
from .inception import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,  # noqa: F401
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
