"""Activations for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/activation.py``): what the model families
call. Each is a named entry of the amp hook under the JAX op's name;
``gelu`` computes ``jax.nn.gelu``'s formulas (exact: x / 2 erfc(-x /
sqrt 2); ``approximate``: the tanh form) in float32 and rounds once to
a 16-bit input's dtype, as XLA evaluates the chain: op by op in bf16 the
tails at large negative x lose most of their bits."""
import math

import torch

from ...amp._hook import amp_op

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
