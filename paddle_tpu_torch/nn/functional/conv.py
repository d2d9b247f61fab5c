"""Convolutions for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/conv.py``): ``conv1d`` / ``conv2d`` /
``conv3d`` and their transposes, named entries of the amp hook.

Channels-first input (NCL / NCHW / NCDHW; NLC / NHWC / NDHWC go through
it), paddle's [out, in / groups, *k] weight for a convolution and
[in, out / groups, *k] for a transposed one, which are torch's layouts.
The JAX package computes them in XLA (``lax.conv_general_dilated``), not
in a Pallas kernel, so the port calls ``torch.nn.functional``'s (cuDNN
on the card). Mixed input and weight dtypes promote first, as the JAX op
promotes them; the bias is added after the convolution with the same
promotion (an f32 bias makes a bf16 convolution's output f32). Padding
is an int, one int a spatial dim, a (low, high) pair a dim, or "SAME" /
"VALID".

A transposed convolution takes ``output_padding`` (added on the high
side) or ``output_size`` (the output padding that reaches it, refused
when it is negative or not below the stride), and "SAME" / "VALID" by
the reference's rule (SAME: output = input x stride, the pad split low /
high, a shortfall made up by output padding). torch takes only
symmetric pads and an output padding below the stride or dilation: any
other case runs the full transposed convolution (no padding) and crops
it, the rows past its end being zeros, as the dilated convolution of the
JAX op computes them."""
import torch
import torch.nn.functional as TF

from ...amp._hook import amp_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(a) for a in v)


def _pads(padding, n):
    """[(low, high)] a spatial dim, or a string torch takes as it is."""
    if isinstance(padding, str):
        return padding.lower()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = [int(p) for p in padding]
    if len(padding) == n:
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    raise ValueError(f"conv: bad padding {padding}")


def _flat(pads):
    """[(low, high)] a dim -> ``F.pad``'s list (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _promote(x, weight):
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return x.to(dtype), weight.to(dtype)


def _add_bias(out, bias, n):
    return out if bias is None else out + bias.reshape((1, -1) + (1,) * n)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    x, weight = _promote(x, weight)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    pads = _pads(padding, n)
    if isinstance(pads, str):
        out = _CONV[n](x, weight, None, stride, pads, dilation, groups)
    elif all(lo == hi for lo, hi in pads):
        out = _CONV[n](x, weight, None, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = _CONV[n](TF.pad(x, _flat(pads)), weight, None, stride, 0,
                       dilation, groups)
    out = _add_bias(out, bias, n)
    return out.movedim(1, -1) if last else out


@amp_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


@amp_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, n, data_format):
    """The transposed convolution (module docstring)."""
    x, weight = _promote(x, weight)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    s, d = _ntuple(stride, n), _ntuple(dilation, n)
    opad = list(_ntuple(output_padding, n))
    ks = weight.shape[2:]
    if isinstance(padding, str):
        pads = []
        for i in range(n):
            if padding.upper() == "VALID":
                pads.append((0, 0))
                continue
            total = d[i] * (ks[i] - 1) + 1 - s[i]
            if total < 0:
                opad[i] += -total
                total = 0
            pads.append((total // 2, total - total // 2))
    else:
        pads = _pads(padding, n)
    full = [(x.shape[2 + i] - 1) * s[i] + d[i] * (ks[i] - 1) + 1
            for i in range(n)]
    if output_size is not None:
        osz = _ntuple(output_size, n)[-n:] if not isinstance(
            output_size, int) else (int(output_size),) * n
        opad = [osz[i] - (full[i] - pads[i][0] - pads[i][1])
                for i in range(n)]
        if any(p < 0 or p >= s[i] for i, p in enumerate(opad)):
            raise ValueError(f"output_size {list(osz)} not reachable with "
                             f"stride {list(s)}")
    if all(lo == hi and 0 <= op < max(si, di)
           for (lo, hi), op, si, di in zip(pads, opad, s, d)):
        out = _CONV_T[n](x, weight, None, s, [lo for lo, _ in pads], opad,
                         groups, d)
    else:
        out = _CONV_T[n](x, weight, None, s, 0, 0, groups, d)
        for i in range(n):
            lo, hi = pads[i]
            size = full[i] - lo - hi + opad[i]
            short = lo + size - full[i]
            if short > 0:            # rows past the full output are zeros
                pad = [0, 0] * (n - 1 - i) + [0, short]
                out = TF.pad(out, pad)
            out = out.narrow(2 + i, lo, size)
    out = _add_bias(out, bias, n)
    return out.movedim(1, -1) if last else out


@amp_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              1, data_format)


@amp_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              2, data_format)


@amp_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              3, data_format)
