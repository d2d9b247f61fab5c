"""RMSNorm with an optional bias and residual (kernel A of the training
step's fused tier, ``csrc/fused_norm.cu``).

The JAX package computes this inside its jitted step, where XLA fuses it
(``paddle_tpu/nn/functional/norm.py:81``, the residual adds of
``paddle_tpu/models/llama.py:227-235``,
``paddle_tpu/incubate/nn/functional/__init__.py:1042``): no
``pallas_call`` stands behind it. Kernel contract, over rows of the last
axis:
  x, bias, residual  [R, H], [H], [R, H]  one dtype T (f32, bf16, f16)
  w                  [H]                  T or f32 (or None)
  out                [R, H]               O: T, or f32 for an f32 scale
                                          over a 16-bit x when the scale
                                          is not cast to T first
  h (residual_out)   [R, H] T             x (+ bias) (+ residual), each add
                                          rounded to T
  inv                [R] f32              1 / sqrt(mean(h^2) + eps)
out = round_O(round_T(h * inv) * round_O(w)): with O = T this is
``nn.RMSNorm``'s rule (the scale cast to the activation's dtype), with
O = f32 ``fused_rms_norm``'s (``(hf * inv).astype(h.dtype) * w``
promotes).

``rms_norm_fwd`` / ``rms_norm_bwd`` launch the kernels for CUDA tensors
(each call counted in ``.launches``; the backward is two launches, the
rows and then the column sum of dw) and run ``rms_norm_fwd_plain`` /
``rms_norm_bwd_plain`` for CPU tensors. ``rms_norm`` is the public op, a
``torch.autograd.Function``.

The backward takes one of three routes, chosen by ``bwd_plan`` from the
activation's dtype, H and whether the rows allow 16-byte accesses, and
passed to the kernel, which runs that route or refuses it: "warp" (one
warp a row, read once through a ring of rows in shared memory), "warps"
(2, 4 or 8 warps a row, 16-bit rows up to 8192 columns) and "block" (a
block a row, two passes: wider rows, f32 rows past 512 columns, and rows
without 16-byte accesses). ``rms_norm_bwd.route`` names the route of the
last launch.
"""
import torch

from . import _launch as L

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_bwd", "rms_norm_fwd_plain",
           "rms_norm_bwd_plain", "bwd_plan"]

# the backward's shapes (csrc/fused_norm.cu): a lane of the register routes
# holds 64 bytes of each operand of a row, LANE_CHUNKS chunks of 8. f32
# rows past one warp stay on "block": split over 2 warps they ran 8%
# slower than it (H = 1024, 0.1089 against 0.1007 ms on an H100 SXM at
# 700 W), half of each lane's work gone to the per-row barrier and
# reductions.
LANE_CHUNKS = {2: 4, 4: 2}          # element bytes -> chunks a lane
ROW_WARPS_MAX = {2: 8, 4: 1}        # wider rows: "block"
BLOCK_WARPS_MIN = 4
BLOCK_THREADS = 128                 # route "block": NT threads a row
# the register routes' grid, one wave of 8 warps an SM, each streaming
# its rows through a ring of 3 rows (75 KB a block of 4 warps; on an H100
# 8 warps an SM beat 12 and 16, with fewer partial rows of dw)
WARPS_PER_SM = 8
BLOCK_ROUTE_BLOCKS_PER_SM = 8


def bwd_plan(r, hid, dtype, sms, vec=True):
    """The backward's route and grid for R rows of width H in ``dtype``
    on a card of ``sms`` SMs (``vec``: the rows allow 16-byte accesses),
    from those alone: route, warps a row (0 for "block"), warps a block,
    row groups a block, blocks, row slots (each walks rows s, s + slots,
    ...), columns a warp holds, and the bytes of dw partials (one f32 row
    a block). The kernel takes the route and grid as they are."""
    size = 4 if dtype == torch.float32 else 2
    cw = 32 * 8 * LANE_CHUNKS[size]
    wpr = 1
    while wpr * cw < hid:
        wpr *= 2
    if vec and wpr <= ROW_WARPS_MAX[size]:
        nw = max(BLOCK_WARPS_MIN, wpr)
        groups = nw // wpr
        blocks = min(-(-r // groups), sms * WARPS_PER_SM // nw)
        route = "warp" if wpr == 1 else "warps"
    else:
        route, wpr, cw, groups = "block", 0, 0, 1
        nw = BLOCK_THREADS // 32
        blocks = min(r, BLOCK_ROUTE_BLOCKS_PER_SM * sms)
    blocks = max(blocks, 1)
    return {"route": route, "warps_per_row": wpr, "warps_per_block": nw,
            "groups": groups, "blocks": blocks, "slots": blocks * groups,
            "warp_cols": cw, "partial_bytes": blocks * hid * 4}


def rms_norm_fwd_plain(x, w, eps, bias, residual, out_dtype):
    """(out, h, inv) in plain PyTorch, the eager ops of
    ``nn/functional/norm.py``."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    hf = h.to(torch.float32)
    inv = torch.rsqrt(torch.mean(hf * hf, dim=-1) + eps)
    out = (hf * inv[:, None]).to(h.dtype)
    if w is not None:
        out = out.to(out_dtype) * w.to(out_dtype)
    return out, h, inv


def rms_norm_bwd_plain(dout, dres, h, w, inv, out_dtype):
    """(dh, dw) in plain PyTorch: the gradients that autograd takes through
    ``rms_norm_fwd_plain`` (dw None without w), written out."""
    t = h.dtype
    hf = h.to(torch.float32)
    n = (hf * inv[:, None]).to(t)
    d = dout.to(torch.float32)
    if w is None:
        dn, dw = d.to(t), None
    else:
        wo = w.to(out_dtype).to(torch.float32)
        dn = (d * wo).to(t)
        prod = (d * n.to(torch.float32)).to(out_dtype)
        dw = prod.to(torch.float32).sum(0).to(out_dtype).to(w.dtype)
    gy = dn.to(torch.float32)
    dot = (gy * hf).sum(-1)
    gsq = (-0.5 * dot * inv ** 3) / h.shape[-1]
    tt = gsq[:, None] * hf
    dh = (gy * inv[:, None] + (tt + tt)).to(t)
    if dres is not None:
        dh = dh + dres
    return dh, dw


def _vec(h, *tensors):
    return h % 8 == 0 and L.aligned16(*tensors)


def _check(name, x, *more):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [R, H] tensor")
    for t in more:
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"on {x.device}")


def rms_norm_fwd(x, w, eps, bias, residual, out_dtype):
    """(out, h, inv) of x [R, H]; ``h`` is x itself without bias and
    residual. A CPU tensor runs the plain version; a CUDA tensor launches
    the forward kernel (counted in ``rms_norm_fwd.launches``) or
    raises."""
    if not L.on_cuda("rms_norm_fwd", x):
        return rms_norm_fwd_plain(x, w, eps, bias, residual, out_dtype)
    _check("rms_norm_fwd", x, w, bias, residual)
    r, hid = x.shape
    out = torch.empty((r, hid), dtype=out_dtype, device=x.device)
    h = x if bias is None and residual is None else torch.empty_like(x)
    inv = torch.empty(r, dtype=torch.float32, device=x.device)
    tcode = L.dtype_code("rms_norm_fwd", x)
    wcode = tcode if w is None else L.dtype_code("rms_norm_fwd", w)
    rc = L.entry("fused_norm", "fused_norm_fwd")(
        tcode, wcode, L.DTYPE_CODE[out_dtype],
        int(_vec(hid, x, w, bias, residual, out, h)), x.data_ptr(),
        L.ptr(bias), L.ptr(residual), L.ptr(w), out.data_ptr(),
        None if h is x else h.data_ptr(), inv.data_ptr(), r, hid,
        float(eps), L.stream(x))
    L.raise_on("rms_norm_fwd", rc)
    rms_norm_fwd.launches += 1
    return out, h, inv


rms_norm_fwd.launches = 0


def rms_norm_bwd(dout, dres, h, w, inv, out_dtype):
    """(dh, dw) of the norm over h [R, H] given dout (and dres, the
    residual_out gradient, or None). A CPU tensor runs the plain version;
    a CUDA tensor launches the backward kernels on ``bwd_plan``'s route
    (the call counted once in ``rms_norm_bwd.launches``, the route in
    ``rms_norm_bwd.route``) or raises."""
    if not L.on_cuda("rms_norm_bwd", h):
        return rms_norm_bwd_plain(dout, dres, h, w, inv, out_dtype)
    _check("rms_norm_bwd", h, dout, dres, w, inv)
    r, hid = h.shape
    if dout.dtype != out_dtype or dout.shape != h.shape or (
            dres is not None and (dres.dtype != h.dtype
                                  or dres.shape != h.shape)):
        raise ValueError("rms_norm_bwd: dout / dres do not match the "
                         "forward")
    dh = torch.empty_like(h)
    dw = part = None
    vec = _vec(hid, dout, dres, h, w, dh)
    plan = bwd_plan(r, hid, h.dtype, L.sms(h.device), vec)
    tcode = L.dtype_code("rms_norm_bwd", h)
    if w is not None:
        dw = torch.empty_like(w)
        if r == 0:
            return dh, dw.zero_()
        part = torch.empty((plan["blocks"], hid), dtype=torch.float32,
                           device=h.device)
    wcode = tcode if w is None else L.dtype_code("rms_norm_bwd", w)
    rc = L.entry("fused_norm", "fused_norm_bwd")(
        tcode, wcode, L.DTYPE_CODE[out_dtype],
        int(vec), dout.data_ptr(), L.ptr(dres), h.data_ptr(), L.ptr(w),
        inv.data_ptr(), dh.data_ptr(), L.ptr(part), L.ptr(dw), r, hid,
        plan["blocks"], plan["warps_per_row"], plan["warps_per_block"],
        L.stream(h))
    L.raise_on("rms_norm_bwd", rc)
    rms_norm_bwd.launches += 1
    rms_norm_bwd.route = plan["route"]
    return dh, dw


rms_norm_bwd.launches = 0
rms_norm_bwd.route = None


class RmsNorm(torch.autograd.Function):
    """Kernel A with autograd: x [R, H] (+ bias [H]) (+ residual [R, H]) ->
    out, or (out, h) when a bias or residual is given. ``rms_norm_fwd`` /
    ``rms_norm_bwd`` are looked up at call time."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, eps, out_dtype):
        out, h, inv = rms_norm_fwd(x, w, eps, bias, residual, out_dtype)
        ctx.save_for_backward(h, w, inv)
        ctx.out_dtype = out_dtype
        ctx.fused = bias is not None or residual is not None
        ctx.set_materialize_grads(False)
        return (out, h) if ctx.fused else out

    @staticmethod
    def backward(ctx, dout, dh_out=None):
        h, w, inv = ctx.saved_tensors
        if dout is None:
            dh, dw = dh_out, None
        else:
            dh, dw = rms_norm_bwd(dout.contiguous(), None if dh_out is None
                                  else dh_out.contiguous(), h, w, inv,
                                  ctx.out_dtype)
        need = ctx.needs_input_grad
        if not need[1]:
            dw = None
        dbias = None
        if need[2] and dh is not None:
            dbias = dh.to(torch.float32).sum(0).to(h.dtype)
        return dh, dw, dbias, dh if need[3] else None, None, None


def rms_norm(x, weight, epsilon, bias=None, residual=None,
             cast_weight=True):
    """RMSNorm over the last axis of x (+ bias) (+ residual) through
    kernel A. ``cast_weight`` True rounds the scale to the activation's
    dtype (``nn.RMSNorm``); False promotes as ``fused_rms_norm`` does.
    Returns out, or (out, residual_out) when a bias or residual is given.
    Mixed input dtypes promote first, as the JAX adds do."""
    dt = x.dtype
    for t in (bias, residual):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    if weight is not None and weight.dtype not in (dt, torch.float32):
        weight = weight.to(torch.float32)    # exact for 16-bit scales
    out_dtype = dt if cast_weight or weight is None else \
        torch.promote_types(dt, weight.dtype)
    shape = x.shape
    hid = shape[-1]

    def rows(t):
        return t.to(dt).reshape(-1, hid).contiguous()

    x2 = rows(x)
    b = None if bias is None else bias.to(dt).reshape(hid).contiguous()
    r2 = None if residual is None else rows(residual)
    w = None if weight is None else weight.reshape(hid).contiguous()
    res = RmsNorm.apply(x2, w, b, r2, float(epsilon), out_dtype)
    if b is None and r2 is None:
        return res.reshape(shape)
    out, h = res
    return out.reshape(shape), h.reshape(shape)
