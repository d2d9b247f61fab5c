"""Activations for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/activation.py``): every function the JAX
module defines, with its constants (``hardsigmoid``'s slope 0.1666667
and offset 0.5 are Paddle's, not torch's 1/6 and 1/2 of
``torch.nn.functional.hardsigmoid``; ``rrelu`` draws its training slopes
from an explicit generator, default a fresh seed of the port's chain, and
is the leaky relu of the mean slope out of training). The in-place forms
(``relu_``, ``elu_``, ...) write the result into their input. Each is a
named entry of the amp hook under the JAX op's name;
``gelu`` computes ``jax.nn.gelu``'s formulas (exact: x / 2 erfc(-x /
sqrt 2); ``approximate``: the tanh form) in float32 and rounds once to
a 16-bit input's dtype, as XLA evaluates the chain: op by op in bf16 the
tails at large negative x lose most of their bits."""
import math

import torch

from ...amp._hook import amp_op
from ...core import random as _random

_SQRT_HALF = math.sqrt(0.5)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@amp_op("silu")
def silu(x):
    return torch.nn.functional.silu(x)


@amp_op("gelu")
def gelu(x, approximate=False):
    a = x.to(torch.float32)
    if approximate:
        out = a * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                           * (a + 0.044715 * a ** 3))))
    else:
        out = 0.5 * a * torch.special.erfc(-a * _SQRT_HALF)
    return out.to(x.dtype)


@amp_op("tanh")
def tanh(x):
    return torch.tanh(x)


@amp_op("relu")
def relu(x):
    return torch.relu(x)


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("paddle.", ""))


swish = silu


@amp_op("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@amp_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@amp_op("hardswish")
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@amp_op("softshrink")
def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@amp_op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@amp_op("elu")
def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


@amp_op("mish")
def mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.nn.functional.softplus(scaled) / beta)


@amp_op("softsign")
def softsign(x):
    return x / (1 + torch.abs(x))


@amp_op("softmax")
def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=axis)


@amp_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


@amp_op("log_sigmoid")
def log_sigmoid(x):
    return torch.nn.functional.logsigmoid(x)


@amp_op("glu")
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@amp_op("prelu")
def prelu(x, weight, data_format="NCHW"):
    """max(0, x) + weight * min(0, x): one weight for all, else one a
    channel (dim 1 for NC* data of 3+ dims, the last dim otherwise)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    elif data_format.startswith("NC") and x.dim() > 2:
        w = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        w = weight
    return torch.where(x > 0, x, w * x)


@amp_op("maxout")
def maxout(x, groups, axis=1):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


@amp_op("rrelu")
def _rrelu(x, lower, upper, seed, generator):
    gen = generator
    if gen is None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    slope.uniform_(lower, upper, generator=gen)
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, generator=None):
    """Randomized leaky relu: in training each negative element's slope is
    drawn from U[lower, upper) (from ``generator``, default a generator
    seeded from the port's chain); out of training the slope is their
    mean."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    seed = None if generator is not None else _random.fresh_seed(x.device)
    return _rrelu(x, lower, upper, seed, generator)


def _inplace(base):
    def fn(x, *args, **kwargs):
        return x.copy_(base(x, *args, **kwargs))
    fn.__name__ = base.__name__ + "_"
    fn.__doc__ = f"``{base.__name__}`` written into x."
    return fn


relu_ = _inplace(relu)
elu_ = _inplace(elu)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
softmax_ = _inplace(softmax)
tanh_ = _inplace(tanh)
thresholded_relu_ = _inplace(thresholded_relu)
