"""paddle.flops of the PyTorch port (counterpart of
``paddle_tpu/hapi/flops.py``; reference python/paddle/hapi/
dynamic_flops.py): forward hooks on the leaf modules count each one by
its type, with the JAX table: a linear or a convolution its multiply-
accumulates (no bias), a batch norm or layer norm 2 x its input's
elements, a ReLU / GELU / Sigmoid its input's elements; other types 0
unless ``custom_ops`` {type: fn(layer, x, y)} counts them."""
import math

import torch

from .. import nn

__all__ = ["flops"]


def _count_linear(layer, x, y):
    return x.numel() // x.shape[-1] * layer.weight.shape[0] \
        * layer.weight.shape[1]


def _count_conv(layer, x, y):
    return y.numel() * layer.weight.shape[1] \
        * math.prod(layer.weight.shape[2:])


def _count_norm(layer, x, y):
    return 2 * x.numel()


def _count_act(layer, x, y):
    return x.numel()


_TABLE = [
    (nn.Linear, _count_linear),
    (nn.Conv1D, _count_conv), (nn.Conv2D, _count_conv),
    (nn.Conv3D, _count_conv),
    (nn.BatchNorm1D, _count_norm), (nn.BatchNorm2D, _count_norm),
    (nn.LayerNorm, _count_norm),
    (nn.ReLU, _count_act), (nn.GELU, _count_act), (nn.Sigmoid, _count_act),
]


def _counter_for(layer):
    for cls, fn in _TABLE:
        if isinstance(layer, cls):
            return fn
    return None


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """The forward's count over one eval forward on ``inputs`` (default:
    zeros of ``input_size`` on the network's device)."""
    custom_ops = custom_ops or {}
    counts, handles = {}, []

    def make_hook(name):
        def hook(layer, inp, out):
            x = inp[0] if isinstance(inp, (tuple, list)) else inp
            fn = custom_ops.get(type(layer)) or _counter_for(layer)
            if fn is not None and isinstance(x, torch.Tensor):
                counts[name] = counts.get(name, 0) + int(fn(layer, x, out))
        return hook

    for name, layer in net.named_modules():
        if not any(True for _ in layer.children()):
            handles.append(layer.register_forward_hook(
                make_hook(name or type(layer).__name__)))
    if inputs is None:
        if input_size is None:
            raise ValueError("flops needs input_size or inputs")
        p = next(net.parameters(), None)
        dev = p.device if p is not None else torch.device("cpu")
        inputs = (torch.zeros(list(input_size), dtype=torch.float32,
                              device=dev),)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        net.train(was_training)
        for h in handles:
            h.remove()
    total = sum(counts.values())
    if print_detail:
        for k, v in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"{k:50s} {v:>15,d}")
        print(f"{'Total':50s} {total:>15,d}")
    return total
