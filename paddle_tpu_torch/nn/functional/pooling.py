"""Pooling for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/pooling.py``): max / avg / lp pooling in 1-3D,
the adaptive pools, ``max_unpool*`` and the fractional max pools, named
entries of the amp hook under the JAX ops' names.

The JAX package pools with ``lax.reduce_window``, an XLA op, so the port
calls ``torch.nn.functional``'s pools, on padding it makes itself where
the two differ:

* ``ceil_mode`` extends the HIGH pad until every partial window counts
  (``_resolve_pads``). torch's ``ceil_mode`` drops a last window that
  starts in the padding, so the two can give different sizes (in = 5,
  k = 2, s = 2, p = 1: JAX 4 windows, torch 3). The port pads itself and
  pools in floor mode, so it gives JAX's size and JAX's values: a window
  wholly in the padding is -inf for max, NaN for exclusive avg (0 / 0)
  and 0 for inclusive avg, as in the reference.
* ``exclusive=True`` (the default) divides a padded window's sum by its
  count of real elements; ``exclusive=False`` by the window's size, the
  ceil region still left out of the count; a string padding ("SAME" /
  "VALID", XLA's rule) divides by the kernel's size.
* ``data_format`` channels-last runs through the channels-first form (the
  JAX pools take the argument and read every input channels first).

A max pool that needs no padding of its own (floor mode, symmetric pads
of at most half the kernel) is one torch call; ResNet's 3 x 3 / 2 / 1
stem pool is one. The max-pool mask (``return_mask``) is an int32 flat
index into the unpadded plane, computed in floor mode with symmetric pads
whatever ``ceil_mode`` says, a tie keeping the earlier element, as the
JAX function's. The adaptive pools' bins run from floor(i * n / o) to
ceil((i + 1) * n / o), torch's own rule."""
import math

import torch
import torch.nn.functional as TF

from ...amp._hook import amp_op
from ...core import random as _random

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "fractional_max_pool2d",
    "fractional_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_AMAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
         3: TF.adaptive_max_pool3d}
_AAVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
         3: TF.adaptive_avg_pool3d}


def _tup(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(a) for a in v)


def _first(v):
    return v if v is None or isinstance(v, int) else v[0]


def _resolve_pads(kernel, stride, padding, ceil_mode, in_sizes):
    """(kernel, stride, [(lo, hi)] a spatial dim), hi extended for
    ``ceil_mode`` (the JAX function's rule)."""
    n = len(in_sizes)
    k, s, p = _tup(kernel, n), _tup(stride, n), _tup(padding, n)
    pads = []
    for i in range(n):
        hi = p[i]
        if ceil_mode:
            rem = (in_sizes[i] + 2 * p[i] - k[i]) % s[i]
            if rem:
                hi += s[i] - rem
        pads.append((p[i], hi))
    return k, s, pads


def _same_pads(kernel, stride, in_sizes, mode):
    """XLA's pads of a string padding: "VALID" none; "SAME" enough for
    ceil(in / stride) windows, the odd one on the high side."""
    pads = []
    for k, s, n in zip(kernel, stride, in_sizes):
        if mode == "VALID":
            pads.append((0, 0))
            continue
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pads(pads):
    """[(lo, hi)] a dim -> ``F.pad``'s flat list (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _cf(fn, x, data_format, *args):
    """``fn(x, *args)`` on channels-first data: a channels-last
    ``data_format`` moves the channels to dim 1 and the result (or each
    tensor of a tuple) back."""
    if data_format.startswith("NC"):
        return fn(x, *args)
    out = fn(x.movedim(-1, 1), *args)
    if isinstance(out, tuple):
        return tuple(o.movedim(1, -1) for o in out)
    return out.movedim(1, -1)


def _pool(x, kernel, stride, padding, nd, kind, ceil_mode=False,
          exclusive=True, divisor_override=None):
    """Max or average pooling over the last ``nd`` dims, the JAX
    function's semantics (module docstring)."""
    if stride is None:
        stride = kernel
    in_sizes = tuple(x.shape[2:])
    if isinstance(padding, str):
        k, s = _tup(kernel, nd), _tup(stride, nd)
        pads = _same_pads(k, s, in_sizes, padding.upper())
        string = True
    else:
        k, s, pads = _resolve_pads(kernel, stride, padding, ceil_mode,
                                   in_sizes)
        string = False
    size = math.prod(k)
    if kind == "max":
        if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
            return _MAX[nd](x, k, s, [lo for lo, _ in pads])
        xp = TF.pad(x, _torch_pads(pads), value=float("-inf"))
        return _MAX[nd](xp, k, s)
    padded = any(lo or hi for lo, hi in pads)
    xp = TF.pad(x, _torch_pads(pads)) if padded else x
    mean = _AVG[nd](xp, k, s)               # windows are whole: sum / size
    if string:
        return mean
    if divisor_override:
        return mean * (size / divisor_override)
    if not padded:
        return mean
    ones = torch.ones((1, 1) + in_sizes, dtype=x.dtype, device=x.device)
    if exclusive:
        return mean / _AVG[nd](TF.pad(ones, _torch_pads(pads)), k, s)
    if ceil_mode:
        # the declared padding counts, the ceil extension does not
        ones = TF.pad(ones, _torch_pads([(lo, lo) for lo, _ in pads]),
                      value=1.0)
        ones = TF.pad(ones, _torch_pads([(0, hi - lo) for lo, hi in pads]))
        counts = torch.round(_AVG[nd](ones, k, s) * size)
        return mean * size / torch.clamp_min(counts, 1.0)
    return mean


def _max(x, kernel_size, stride, padding, ceil_mode, return_mask, nd):
    out = _pool(x, kernel_size, stride, padding, nd, "max", ceil_mode)
    if return_mask:
        return out, _max_mask(x, _tup(kernel_size, nd), stride, padding)
    return out


@amp_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False):
    return _max(x, _first(kernel_size), _first(stride), _first(padding),
                ceil_mode, return_mask, 1)


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    return _cf(_max, x, data_format, kernel_size, stride, padding,
               ceil_mode, return_mask, 2)


@amp_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    return _cf(_max, x, data_format, kernel_size, stride, padding,
               ceil_mode, return_mask, 3)


def _max_mask(x, kernel, stride, padding):
    """int32 flat indices into the unpadded plane of each window's first
    maximum (floor mode, symmetric pads; -1 for a window of padding
    alone)."""
    nd = len(kernel)
    s = kernel if stride is None else _tup(stride, nd)
    p = (0,) * nd if isinstance(padding, str) else _tup(padding, nd)
    sizes = x.shape[2:]
    xp = TF.pad(x.detach(), _torch_pads([(a, a) for a in p]),
                value=float("-inf"))
    vals, idx = _MAX[nd](xp, kernel, s, return_indices=True)
    padded = xp.shape[2:]
    coords, rest = [], idx
    for d in reversed(range(nd)):
        coords.append(rest % padded[d] - p[d])
        rest = rest // padded[d]
    coords.reverse()
    flat = torch.zeros_like(idx)
    inside = torch.ones_like(idx, dtype=torch.bool)
    for d in range(nd):
        flat = flat * sizes[d] + coords[d]
        inside &= (coords[d] >= 0) & (coords[d] < sizes[d])
    flat = torch.where(inside & (vals > float("-inf")), flat,
                       torch.full_like(flat, -1))
    return flat.to(torch.int32)


def _avg(x, kernel_size, stride, padding, ceil_mode, exclusive,
         divisor_override, nd):
    return _pool(x, kernel_size, stride, padding, nd, "avg", ceil_mode,
                 exclusive, divisor_override)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    return _avg(x, _first(kernel_size), _first(stride), _first(padding),
                ceil_mode, exclusive, None, 1)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _cf(_avg, x, data_format, kernel_size, stride, padding,
               ceil_mode, exclusive, divisor_override, 2)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _cf(_avg, x, data_format, kernel_size, stride, padding,
               ceil_mode, exclusive, divisor_override, 3)


def _out_sizes(output_size, x, nd):
    """Adaptive output sizes; a None keeps the input's size."""
    o = (output_size,) * nd if isinstance(output_size, int) \
        else tuple(output_size)
    return tuple(x.shape[2 + i] if v is None else int(v)
                 for i, v in enumerate(o))


def _adaptive_avg(x, output_size, nd):
    return _AAVG[nd](x, _out_sizes(output_size, x, nd))


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size):
    return _adaptive_avg(x, output_size, 1)


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _cf(_adaptive_avg, x, data_format, output_size, 2)


@amp_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _cf(_adaptive_avg, x, data_format, output_size, 3)


def _adaptive_max(x, output_size, return_mask, nd):
    out, idx = _AMAX[nd](x, _out_sizes(output_size, x, nd),
                         return_indices=True)
    return (out, idx.to(torch.int32)) if return_mask else out


@amp_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive_max(x, output_size, return_mask, 1)


@amp_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    return _cf(_adaptive_max, x, data_format, output_size, return_mask, 2)


@amp_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    return _cf(_adaptive_max, x, data_format, output_size, return_mask, 3)


def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, nd):
    """(sum over the window of |x|^p)^(1/p), zero padding extended for
    ``ceil_mode`` as in ``_pool``."""
    p = float(norm_type)
    if stride is None:
        stride = kernel_size
    k, s, pads = _resolve_pads(kernel_size, stride, padding, ceil_mode,
                               tuple(x.shape[2:]))
    powed = TF.pad(torch.abs(x) ** p, _torch_pads(pads))
    return (_AVG[nd](powed, k, s) * math.prod(k)) ** (1.0 / p)


@amp_op("lp_pool1d")
def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL"):
    return _cf(_lp_pool, x, data_format, norm_type, _first(kernel_size),
               _first(stride), _first(padding), ceil_mode, 1)


@amp_op("lp_pool2d")
def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW"):
    return _cf(_lp_pool, x, data_format, norm_type, kernel_size, stride,
               padding, ceil_mode, 2)


def _max_unpool(x, indices, nd, kernel_size, stride, padding, output_size):
    """Each pooled value written at its flat index (a ``max_pool*`` mask)
    into zeros of the unpooled size: (in - 1) * stride - 2 * padding +
    kernel, or the last ``nd`` entries of ``output_size``."""
    if stride is None:
        stride = kernel_size
    lead, in_sizes = tuple(x.shape[:2]), tuple(x.shape[2:])
    if output_size is not None:
        sizes = tuple(int(v) for v in tuple(output_size)[-nd:])
    else:
        k, s, p = (_tup(kernel_size, nd), _tup(stride, nd),
                   _tup(padding, nd))
        sizes = tuple((in_sizes[i] - 1) * s[i] - 2 * p[i] + k[i]
                      for i in range(nd))
    rows = math.prod(lead)
    out = torch.zeros((rows, math.prod(sizes)), dtype=x.dtype,
                      device=x.device)
    out = out.scatter(1, indices.reshape(rows, -1).long(),
                      x.reshape(rows, -1))
    return out.reshape(lead + sizes)


@amp_op("max_unpool1d")
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


@amp_op("max_unpool2d")
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


@amp_op("max_unpool3d")
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


def _fractional_starts(in_size, out_size, k, u):
    """Window starts of fractional pooling (Graham 2014, the JAX
    function's rule): alpha = (in - k) / (out - 1) steps, jittered by u in
    [0, 1), the first at 0 and none past in - k."""
    alpha = (in_size - k) / max(out_size - 1, 1)
    starts = [min(int(math.floor(alpha * (i + u))), in_size - k)
              for i in range(out_size)]
    if out_size > 0:
        starts[0] = 0
    return starts


def _fractional(x, output_size, kernel_size, random_u, return_mask,
                generator, nd):
    """Max over windows of ``kernel_size`` (default in // out + 1) at the
    fractional starts. ``random_u`` is the jitter u; None draws it from
    ``generator`` (default: the port's chain, ``core.random``)."""
    outs = _tup(output_size, nd)
    sizes = tuple(x.shape[2:])
    if kernel_size is None:
        ks = tuple(n // o + 1 for n, o in zip(sizes, outs))
    else:
        ks = _tup(kernel_size, nd)
    if random_u is None:
        gen = generator
        if gen is None:
            gen = torch.Generator()
            gen.manual_seed(_random.fresh_seed(x.device))
        random_u = float(torch.rand((), generator=gen))
    u = float(random_u)
    # per dim an index tensor [out, k] of the rows each window reads
    idx = [torch.tensor(_fractional_starts(n, o, k, u),
                        device=x.device)[:, None]
           + torch.arange(k, device=x.device)
           for n, o, k in zip(sizes, outs, ks)]
    grids = torch.meshgrid(*[i.reshape(-1) for i in idx], indexing="ij")
    win = x[(slice(None), slice(None)) + tuple(grids)]
    # win: [N, C, o0 * k0, o1 * k1, ...] -> [N, C, o0, o1, ..., k0 * k1 ...]
    shape = list(x.shape[:2])
    for o, k in zip(outs, ks):
        shape += [o, k]
    win = win.reshape(shape)
    perm = [0, 1] + [2 + 2 * i for i in range(nd)] \
        + [3 + 2 * i for i in range(nd)]
    win = win.permute(perm).reshape(list(x.shape[:2]) + list(outs) + [-1])
    out = win.amax(-1)
    if not return_mask:
        return out
    arg = win.argmax(-1)
    flat = torch.zeros_like(arg)
    rest = arg
    offs = []
    for d in reversed(range(nd)):
        offs.append(rest % ks[d])
        rest = rest // ks[d]
    offs.reverse()
    for d in range(nd):
        start = idx[d][:, 0].reshape([-1 if i == d else 1
                                      for i in range(nd)])
        flat = flat * sizes[d] + offs[d] + start
    return out, flat.to(torch.int32)


@amp_op("fractional_max_pool2d")
def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, generator=None):
    return _fractional(x, output_size, kernel_size, random_u, return_mask,
                       generator, 2)


@amp_op("fractional_max_pool3d")
def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, generator=None):
    return _fractional(x, output_size, kernel_size, random_u, return_mask,
                       generator, 3)
