"""Convolutions for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/conv.py``): ``conv2d``, a named entry of the
amp hook.

NCHW (or NHWC) input, paddle's [out, in / groups, kh, kw] weight, which
is torch's layout. The JAX package computes it in XLA
(``lax.conv_general_dilated``), not in a Pallas kernel, so the port
calls ``torch.nn.functional.conv2d``. Mixed input and weight dtypes
promote first, as the JAX op promotes them; the bias is added after the
convolution with the same promotion (an f32 bias makes a bf16
convolution's output f32). Padding is an int, one int a spatial dim, a
(low, high) pair a dim, or "SAME" / "VALID"."""
import torch

from ...amp._hook import amp_op

__all__ = ["conv2d"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(x) for x in v)


def _pads(padding):
    """(top, bottom, left, right), or a string torch takes as it is."""
    if isinstance(padding, str):
        return padding.lower()
    if isinstance(padding, int):
        return (padding,) * 4
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        return (padding[0], padding[0], padding[1], padding[1])
    if len(padding) == 4:
        return tuple(padding)
    raise ValueError(f"conv2d: bad padding {padding}")


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    dtype = torch.promote_types(x.dtype, weight.dtype)
    x, weight = x.to(dtype), weight.to(dtype)
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    pads = _pads(padding)
    if isinstance(pads, str):
        out = torch.nn.functional.conv2d(x, weight, None, _pair(stride),
                                         pads, _pair(dilation), groups)
    else:
        top, bottom, left, right = pads
        if top == bottom and left == right:
            out = torch.nn.functional.conv2d(x, weight, None, _pair(stride),
                                             (top, left), _pair(dilation),
                                             groups)
        else:
            out = torch.nn.functional.conv2d(
                torch.nn.functional.pad(x, (left, right, top, bottom)),
                weight, None, _pair(stride), 0, _pair(dilation), groups)
    if data_format != "NCHW":
        out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + (bias.reshape(1, -1, 1, 1) if data_format == "NCHW"
                     else bias)
    return out
