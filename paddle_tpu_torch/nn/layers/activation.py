"""Activation layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/activation.py``): one ``torch.nn.Module`` a
functional of ``nn.functional.activation`` (``nn.layer.functional_layer``),
under the JAX names and with the JAX defaults. ``PReLU``'s weight is a
parameter (``Constant(init)``); ``RReLU`` draws its training slopes from
``generator`` (default: a fresh seed of the port's chain a call) and is
deterministic in eval."""
import torch

from ...core.device import DEFAULT_DEVICE
from .. import functional as F
from .. import initializer as I
from ..layer import create_parameter
from ..layer import functional_layer as _layer


ReLU = _layer("ReLU", F.relu)
ReLU6 = _layer("ReLU6", F.relu6)
Sigmoid = _layer("Sigmoid", F.sigmoid)
Tanh = _layer("Tanh", F.tanh)
SiLU = _layer("SiLU", F.silu)
Swish = _layer("Swish", F.silu)
Mish = _layer("Mish", F.mish)
Softsign = _layer("Softsign", F.softsign)
Tanhshrink = _layer("Tanhshrink", F.tanhshrink)
Hardswish = _layer("Hardswish", F.hardswish)
LogSigmoid = _layer("LogSigmoid", F.log_sigmoid)
GELU = _layer("GELU", F.gelu, ("approximate", False))
LeakyReLU = _layer("LeakyReLU", F.leaky_relu, ("negative_slope", 0.01))
ELU = _layer("ELU", F.elu, ("alpha", 1.0))
SELU = _layer("SELU", F.selu, ("scale", 1.0507009873554805),
              ("alpha", 1.6732632423543772))
CELU = _layer("CELU", F.celu, ("alpha", 1.0))
Softmax = _layer("Softmax", F.softmax, ("axis", -1))
LogSoftmax = _layer("LogSoftmax", F.log_softmax, ("axis", -1))
Softplus = _layer("Softplus", F.softplus, ("beta", 1.0), ("threshold", 20.0))
Softshrink = _layer("Softshrink", F.softshrink, ("threshold", 0.5))
Hardshrink = _layer("Hardshrink", F.hardshrink, ("threshold", 0.5))
Hardtanh = _layer("Hardtanh", F.hardtanh, ("min", -1.0), ("max", 1.0))
Hardsigmoid = _layer("Hardsigmoid", F.hardsigmoid, ("slope", 0.1666667),
                     ("offset", 0.5))
ThresholdedReLU = _layer("ThresholdedReLU", F.thresholded_relu,
                         ("threshold", 1.0), ("value", 0.0))
Maxout = _layer("Maxout", F.maxout, ("groups", None), ("axis", 1))
GLU = _layer("GLU", F.glu, ("axis", -1))


class PReLU(torch.nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.data_format = data_format
        self.weight = create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=I.Constant(init), generator=generator,
            device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(torch.nn.Module):
    def __init__(self, lower=0.125, upper=0.3333333, name=None,
                 generator=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self.generator)
