"""SwiGLU, silu(gate) * up (kernel B of the training step's fused tier,
``csrc/swiglu.cu``).

The JAX package computes this inside its jitted step, where XLA fuses it
(``paddle_tpu/models/llama.py:209-214``,
``paddle_tpu/incubate/nn/functional/__init__.py:1011``): no
``pallas_call`` stands behind it. Kernel contract:
  gate, up     [R, im]  one dtype (f32, bf16, f16), the last axis
                        contiguous, any row stride: the two halves of a
                        fused [R, 2 im] projection are read in place
  out          [R, im]  round(round(silu(gate)) * up)
  d_gate, d_up [R, im]  written through their own row strides, so the
                        fused projection's gradient is one [R, 2 im]
                        tensor
silu in f32, with the eager ops' roundings (``csrc/swiglu.cu``).

``swiglu_fwd`` / ``swiglu_bwd`` launch the kernels for CUDA tensors (each
call counted in ``.launches``) and run ``swiglu_fwd_plain`` /
``swiglu_bwd_plain`` for CPU tensors. ``swiglu`` is the public op, a
``torch.autograd.Function``.
"""
import torch

from . import _launch as L
from . import work as _work

__all__ = ["swiglu", "swiglu_fwd", "swiglu_bwd", "swiglu_fwd_plain",
           "swiglu_bwd_plain"]


def swiglu_fwd_plain(g, u):
    return torch.nn.functional.silu(g) * u


def swiglu_bwd_plain(dout, g, u, dg, du):
    """Fills dg and du (views of the caller's gradient) in plain PyTorch:
    the ops autograd takes through ``swiglu_fwd_plain``."""
    s = torch.nn.functional.silu(g)
    du.copy_(dout * s)
    dg.copy_(torch.ops.aten.silu_backward(dout * u, g))


def _check(name, *ts):
    base = ts[0]
    for t in ts:
        if t.dim() != 2 or t.shape != base.shape or t.dtype != base.dtype \
                or t.device != base.device or t.stride(1) != 1:
            raise ValueError(f"{name}: every tensor must be [R, im] of one "
                             "dtype and device, the last axis contiguous")


def _vec(ts):
    return ts[0].shape[1] % 8 == 0 and L.aligned16(*ts) and all(
        t.stride(0) % 8 == 0 for t in ts)


def swiglu_fwd(g, u):
    """out [R, im] = silu(g) * u. A CPU tensor runs the plain version; a
    CUDA tensor launches the forward kernel (counted in
    ``swiglu_fwd.launches``) or raises."""
    if not L.on_cuda("swiglu_fwd", g):
        return swiglu_fwd_plain(g, u)
    _check("swiglu_fwd", g, u)
    r, im = g.shape
    out = torch.empty((r, im), dtype=g.dtype, device=g.device)
    rc = L.entry("swiglu", "swiglu_fwd")(
        L.dtype_code("swiglu_fwd", g), int(_vec((g, u, out))), g.data_ptr(),
        u.data_ptr(), out.data_ptr(), g.stride(0), u.stride(0),
        out.stride(0), r, im, L.stream(g))
    L.raise_on("swiglu_fwd", rc)
    swiglu_fwd.launches += 1
    if _work.counting():
        _work.note("swiglu_fwd", *_work.swiglu_fwd(r, im, g.element_size()))
    return out


swiglu_fwd.launches = 0


def swiglu_bwd(dout, g, u, dg, du):
    """Writes d_gate into dg and d_up into du ([R, im], any row stride). A
    CPU tensor runs the plain version; a CUDA tensor launches the backward
    kernel (counted in ``swiglu_bwd.launches``) or raises."""
    if not L.on_cuda("swiglu_bwd", g):
        return swiglu_bwd_plain(dout, g, u, dg, du)
    _check("swiglu_bwd", dout, g, u, dg, du)
    r, im = g.shape
    ts = (dout, g, u, dg, du)
    rc = L.entry("swiglu", "swiglu_bwd")(
        L.dtype_code("swiglu_bwd", g), int(_vec(ts)),
        *(t.data_ptr() for t in ts), *(t.stride(0) for t in ts), r, im,
        L.stream(g))
    L.raise_on("swiglu_bwd", rc)
    swiglu_bwd.launches += 1
    if _work.counting():
        _work.note("swiglu_bwd", *_work.swiglu_bwd(r, im, g.element_size()))


swiglu_bwd.launches = 0


class SwiGLU(torch.autograd.Function):
    """Kernel B with autograd over [R, ...] rows: (x,) with x = [gate | up]
    [R, 2 im], or (gate, up). ``swiglu_fwd`` / ``swiglu_bwd`` are looked
    up at call time."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.fused = y is None
        if ctx.fused:
            im = x.shape[1] // 2
            g, u = x[:, :im], x[:, im:]
        else:
            g, u = x, y
        ctx.save_for_backward(x, y)
        return swiglu_fwd(g, u)

    @staticmethod
    def backward(ctx, dout):
        x, y = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.fused:
            im = x.shape[1] // 2
            dx = torch.empty_like(x)
            swiglu_bwd(dout, x[:, :im], x[:, im:], dx[:, :im], dx[:, im:])
            return dx, None
        dg, du = torch.empty_like(x), torch.empty_like(y)
        swiglu_bwd(dout, x, y, dg, du)
        return dg, du


def swiglu(x, y=None):
    """silu(x) * y through kernel B; with y None, x [..., 2 im] is split in
    half on the last axis (gate first). Mixed dtypes promote first."""
    if y is None:
        if x.shape[-1] % 2:
            raise ValueError(f"swiglu: the last axis of x ({x.shape[-1]}) "
                             "must be even to split in half")
        x2 = x.reshape(-1, x.shape[-1])
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        out = SwiGLU.apply(x2, None)
        return out.reshape(*x.shape[:-1], x.shape[-1] // 2)
    shape = torch.broadcast_shapes(x.shape, y.shape)
    dt = torch.promote_types(x.dtype, y.dtype)
    x2 = x.to(dt).expand(shape).reshape(-1, shape[-1]).contiguous()
    y2 = y.to(dt).expand(shape).reshape(-1, shape[-1]).contiguous()
    return SwiGLU.apply(x2, y2).reshape(shape)
