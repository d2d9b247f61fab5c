"""Weight initializers of the PyTorch port (counterpart of
``paddle_tpu/nn/initializer.py``): the ones the layers of the model
families draw from by default (``Linear``: ``XavierNormal``;
``Embedding``: ``Normal(0, 1)``; the norms: ``Constant(1)``; ``Conv2D``:
``KaimingUniform`` over its fan-in; a bias: ``Constant(0)``), and
``Normal`` / ``Constant`` / ``Uniform`` for a ``ParamAttr``.

Each is a callable ``(shape, generator, device) -> float32 tensor``: the
JAX package's take (shape, dtype) and draw from its key chain; the port
draws from an explicit ``torch.Generator`` on ``device`` (the two give
different numbers for one seed, so parity tests carry the JAX weights
across). Fans follow paddle: [in, out] for a matrix, dims 1 and 0 times
the receptive field for a convolution's [out, in, kh, kw]."""
import math

import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "KaimingUniform", "fan_in_out"]


def fan_in_out(shape):
    """paddle's (fan_in, fan_out) of a parameter shape."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, device):
    return torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                       device=device)


class Initializer:
    def __call__(self, shape, generator, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, generator, device):
        return _empty(shape, device).fill_(float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, generator, device):
        return _empty(shape, device).normal_(self.mean, self.std,
                                             generator=generator)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, generator, device):
        return _empty(shape, device).uniform_(self.low, self.high,
                                              generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, generator, device):
        fi, fo = fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, generator, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, generator, device):
        fi = self._fan_in if self._fan_in is not None \
            else fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2)) \
            if self.nonlinearity in ("relu", "leaky_relu") else 1.0
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, generator, device)
