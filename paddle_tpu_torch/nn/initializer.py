"""Weight initializers of the PyTorch port (counterpart of
``paddle_tpu/nn/initializer.py``): the ones the layers of the model
families draw from by default (``Linear``: ``XavierNormal``;
``Embedding``: ``Normal(0, 1)``; the norms: ``Constant(1)``; ``Conv2D``:
``KaimingUniform`` over its fan-in; a bias: ``Constant(0)``), and the
rest of the JAX module for a ``ParamAttr``: ``Normal``, ``Uniform``,
``TruncatedNormal``, ``XavierUniform``, ``KaimingNormal``, ``Assign``,
``Orthogonal``, ``Dirac``, ``Bilinear``, ``calculate_gain`` and the
short aliases (``constant_``, ``normal_``, ...).

Each is a callable ``(shape, generator, device) -> float32 tensor``: the
JAX package's take (shape, dtype) and draw from its key chain; the port
draws from an explicit ``torch.Generator`` on ``device`` (the two give
different numbers for one seed, so parity tests carry the JAX weights
across). Fans follow paddle: [in, out] for a matrix, dims 1 and 0 times
the receptive field for a convolution's [out, in, kh, kw]."""
import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform",
           "TruncatedNormal", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "fan_in_out", "constant_", "normal_",
           "uniform_", "xavier_normal_", "xavier_uniform_",
           "kaiming_normal_", "kaiming_uniform_"]


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


def _gain(nonlinearity, negative_slope):
    return math.sqrt(2.0 / (1 + negative_slope ** 2)) \
        if nonlinearity in ("relu", "leaky_relu") else 1.0


class TruncatedNormal(Initializer):
    """Normal(mean, std) cut to [mean + a std, mean + b std]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, generator, device):
        out = torch.nn.init.trunc_normal_(_empty(shape, device), 0.0, 1.0,
                                          self.a, self.b,
                                          generator=generator)
        return out * self.std + self.mean


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, generator, device):
        fi, fo = fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, generator, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, generator, device):
        fi = self._fan_in if self._fan_in is not None \
            else fan_in_out(shape)[0]
        std = _gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return Normal(0.0, std)(shape, generator, device)


class Assign(Initializer):
    """The given value (a numpy array, list, number or tensor), reshaped
    to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, generator, device):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v, dtype=np.float32).reshape(
            tuple(int(s) for s in shape))
        return torch.from_numpy(arr.copy()).to(device)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns, over
    [shape[0], prod(shape[1:])], from the QR of a normal draw."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, generator, device):
        return torch.nn.init.orthogonal_(_empty(shape, device), self.gain,
                                         generator=generator)


class Dirac(Initializer):
    """A convolution weight [out, in, *k] that passes its input through:
    1 at the kernel's center of (g * out / groups + i, i)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, generator, device):
        out = np.zeros(tuple(int(s) for s in shape), dtype=np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        center = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + center] = 1.0
        return torch.from_numpy(out).to(device)


class Bilinear(Initializer):
    """The bilinear-upsampling stencil in every [i, j] of a 4-D weight
    (a transposed convolution's)."""

    def __call__(self, shape, generator, device):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = int(shape[2]), int(shape[3])
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f_h - c_h)) * (1 - abs(og[1] / f_w - c_w))
        w = np.broadcast_to(filt.astype(np.float32),
                            tuple(int(s) for s in shape))
        return torch.from_numpy(w.copy()).to(device)


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of an init for ``nonlinearity``."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0), "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity in gains:
        return gains[nonlinearity]
    raise ValueError(f"unsupported nonlinearity: {nonlinearity}")


# paddle's short aliases
constant_ = Constant
normal_ = Normal
uniform_ = Uniform
xavier_normal_ = XavierNormal
xavier_uniform_ = XavierUniform
kaiming_normal_ = KaimingNormal
kaiming_uniform_ = KaimingUniform
