"""Flash attention for the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``).

Kernel contract (the JAX package's, heads folded into batch):
  q, o, do  [BH, Sq, D]   float32 / bfloat16 / float16
  k, v      [BH, Sk, D]
  lse       [BH, Sq]      float32 row logsumexp of the scaled scores
  rope_cos, rope_sin [S, D/2] float32 (optional, S >= Sq and Sk): neox
            rope applied to q and k inside the kernels, the row at position
            p rotating the q and k rows at p; the tables get no gradient
The causal mask is top-left aligned (row >= col). The TPU kernel saves
lse as [BH, 8, S] (eight equal rows, a lane-tiling artifact); the port
owns both kernels and keeps one row.

``flash_fwd`` and ``flash_bwd`` launch the CUDA kernels of
``csrc/flash_attention.cu`` for CUDA tensors and run ``flash_fwd_plain``
/ ``flash_bwd_plain`` for CPU tensors; nothing else chooses between
them. The plain versions are written from the formulas with the saved
lse (not through autograd) and take the Pallas bodies' dtype steps: f32
scores, p cast to v's dtype before p @ v, ds cast to q's dtype before
the second products, delta = rowsum(do * o) in f32. With rope they
rotate q and k in the input's dtype, as ``_rope_fwd`` (:58-66) does (the
tables cast to that dtype, a rounding after each product and each sum),
and counter-rotate the f32 dq and dk before the cast, as ``_rope_bwd``
(:69-75) does. ``flash_bwd_twopass`` is the two-pass backward (the JAX
package's A/B entry): the FlashMask backward kernels of
``csrc/flashmask.cu`` without the interval, with ``flash_bwd_plain`` as
its plain version.

``flash_attention_bshd`` is the [B, S, H, D] entry with a
``torch.autograd.Function`` around the pair. Grouped-query kv heads are
repeated up to the query heads before the kernel, as the JAX wrapper
does (:616-620); autograd sums dk / dv over each group, and the rope
tables apply per sequence position to q and to the repeated k.
"""
import ctypes
import functools
import math

import torch

from . import work as _work

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _visible(sq, sk, causal, device):
    """[Sq, Sk] bool of the (row, key) pairs a causal row sees, or None."""
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows >= cols


def _rope(x, cos, sin):
    """Neox rotation of [BH, S, D] by the first S rows of the tables, in
    x's dtype."""
    half = x.shape[-1] // 2
    c = cos[:x.shape[1]].to(x.dtype)
    s = sin[:x.shape[1]].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope_bwd(g, cos, sin):
    """The transpose of ``_rope`` on an f32 gradient, in f32."""
    half = g.shape[-1] // 2
    c = cos[:g.shape[1]].float()
    s = sin[:g.shape[1]].float()
    g1, g2 = g[..., :half], g[..., half:]
    return torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], dim=-1)


def flash_fwd_plain(q, k, v, scale, causal, rope_cos=None, rope_sin=None):
    """softmax(q k^T * scale) v over [BH, S, D] in plain PyTorch:
    returns (o in q's dtype, lse [BH, Sq] f32). Fully masked rows give
    zeros."""
    if rope_cos is not None:
        q, k = _rope(q, rope_cos, rope_sin), _rope(k, rope_cos, rope_sin)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = p * vis
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, scale, causal, rope_cos=None,
                    rope_sin=None):
    """Gradients (dq, dk, dv) of flash attention from the saved o and lse,
    in plain PyTorch, each in its input's dtype."""
    rope = rope_cos is not None
    if rope:
        q, k = _rope(q, rope_cos, rope_sin), _rope(k, rope_cos, rope_sin)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        # select, as the kernels do: a masked score far above its row's
        # lse overflows exp to inf, and inf * 0 would be NaN
        p = torch.where(vis, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dq = torch.matmul(ds, k.float())
    if rope:
        dq, dk = _rope_bwd(dq, rope_cos, rope_sin), \
            _rope_bwd(dk, rope_cos, rope_sin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, *more):
    """Refuse what the kernels do not take: ``more`` are further tensors
    of q's dtype and device (o and do)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [BH, Sq, D], "
                         "[BH, Sk, D], [BH, Sk, D]")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[2]} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} must be float32, "
                         "bfloat16 or float16")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: batch x heads {q.shape[0]} > 65535")
    for t in (q, k, v, *more):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must start on a 16-byte "
                             "boundary (the kernels copy 16-byte chunks)")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")


def _check_saved(name, q, o, lse, do):
    """Refuse a saved o / lse or an upstream do the backward kernels do
    not take."""
    bh, sq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, sq) \
            or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"{name}: o and do must be shaped like q and lse a "
                         f"contiguous float32 [{bh}, {sq}] on {q.device}")


def _rope_ptrs(name, q, k, rope_cos, rope_sin):
    """The tables' device pointers (None, None without rope), after
    refusing tables the kernels do not take."""
    if rope_cos is None and rope_sin is None:
        return None, None
    rows = max(q.shape[1], k.shape[1])
    for t in (rope_cos, rope_sin):
        if t is None or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[0] < rows or t.shape[1] != q.shape[2] // 2 \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rope_cos and rope_sin must both be "
                             f"contiguous float32 [>= {rows}, "
                             f"{q.shape[2] // 2}] on {q.device}, starting "
                             "on a 16-byte boundary")
    return rope_cos.data_ptr(), rope_sin.data_ptr()


def flash_fwd(q, k, v, scale, causal, rope_cos=None, rope_sin=None):
    """(o, lse) of flash attention over [BH, S, D], with rope on q and k
    when the tables are given. A CPU tensor runs the plain version; a CUDA
    tensor launches the forward kernel (counted in ``flash_fwd.launches``,
    and in ``flash_fwd.rope_launches`` when it took the tables) or
    raises."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, rope_cos, rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check("flash_fwd", q, k, v)
    rcos, rsin = _rope_ptrs("flash_fwd", q, k, rope_cos, rope_sin)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    rc = _launcher("fwd")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), rcos, rsin, bh, sq, k.shape[1], d,
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed with CUDA error "
                           f"{rc}")
    flash_fwd.launches += 1
    flash_fwd.rope_launches += rcos is not None
    if _work.counting():
        _work.note("flash_fwd", *_work.flash_fwd(
            bh, sq, k.shape[1], d, causal, q.element_size(),
            rcos is not None))
    return o, lse


flash_fwd.launches = 0
flash_fwd.rope_launches = 0


def flash_bwd(q, k, v, o, lse, do, scale, causal, rope_cos=None,
              rope_sin=None):
    """(dq, dk, dv) of flash attention from the saved o and lse, the
    gradients of the unrotated q and k when the rope tables are given. A
    CPU tensor runs the plain version; a CUDA tensor launches the backward
    kernel (counted in ``flash_bwd.launches``, and in
    ``flash_bwd.rope_launches`` when it took the tables) on the current
    stream, the forward's when autograd calls it, or raises."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale, causal, rope_cos,
                               rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    _check("flash_bwd", q, k, v, o, do)
    _check_saved("flash_bwd", q, o, lse, do)
    rcos, rsin = _rope_ptrs("flash_bwd", q, k, rope_cos, rope_sin)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if sq == 0:
        return dq.to(q.dtype), dk.zero_(), dv.zero_()
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    rc = _launcher("bwd")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), rcos, rsin, bh, sq,
        sk, d, float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd: kernel launch failed with CUDA error "
                           f"{rc}")
    flash_bwd.launches += 1
    flash_bwd.rope_launches += rcos is not None
    if _work.counting():
        _work.note("flash_bwd", *_work.flash_bwd(
            bh, sq, sk, d, causal, q.element_size(), rcos is not None))
    return dq.to(q.dtype), dk, dv


flash_bwd.launches = 0
flash_bwd.rope_launches = 0


def flash_bwd_twopass(q, k, v, o, lse, do, scale, causal, rope_cos=None,
                      rope_sin=None):
    """(dq, dk, dv) from the two-pass backward (``_flash_bwd_twopass``
    :485-550, kept for A/B measurement against ``flash_bwd``): a dq pass
    over the k tiles and a dk / dv pass over the q tiles, with the same
    dtype steps as the fused backward, so ``flash_bwd_plain`` is its plain
    version. Refuses rope, as :491-494 does. A CPU tensor runs the plain
    version; a CUDA tensor launches the no-interval instantiation of the
    FlashMask backward kernels (``csrc/flashmask.cu``, counted in
    ``flash_bwd_twopass.dq_launches`` and ``.dkv_launches``) or raises.
    Nothing on the training path calls it."""
    if rope_cos is not None or rope_sin is not None:
        raise NotImplementedError(
            "flash_bwd_twopass has no in-kernel rope; A/B with "
            "fuse_rope_in_attention=False")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_twopass: unsupported device {q.device}")
    from . import flashmask as _fm
    _check("flash_bwd_twopass", q, k, v, o, do)
    _check_saved("flash_bwd_twopass", q, o, lse, do)
    return _fm._bwd_kernels(flash_bwd_twopass, _fm.MODE_TWOPASS, q, k, v, o,
                            lse, do, None, None, scale, causal)


flash_bwd_twopass.dq_launches = 0
flash_bwd_twopass.dkv_launches = 0


@functools.cache
def _launcher(which):
    """The kernel's C entry point with its prototype bound, built and
    loaded on the first launch."""
    from . import _build
    lib = _build.load("flash_attention")
    if which == "fwd":
        fn = lib.flash_attention_fwd_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
    else:
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class FlashAttention(torch.autograd.Function):
    """Flash attention over [BH, S, D] with the kernel pair as forward and
    backward; saves (q, k, v, o, lse) and the rope tables, which get no
    gradient. ``flash_fwd`` / ``flash_bwd`` are looked up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal, rope_cos, rope_sin)
        ctx.save_for_backward(q, k, v, o, lse, rope_cos, rope_sin)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, rope_cos, rope_sin = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale,
                               ctx.causal, rope_cos, rope_sin)
        return dq, dk, dv, None, None, None, None


def flash_attention_bshd(q, k, v, causal=True, scale=None, rope_cos=None,
                         rope_sin=None):
    """q [B, Sq, H, D], k / v [B, Sk, KVH, D] (paddle's flash_attention
    layout) -> out [B, Sq, H, D]. kv heads are repeated up to H. rope_cos /
    rope_sin [S, D/2] f32: neox rope on q and k inside the kernels."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hk != h:
        rep = h // hk
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def fold(x, s):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    o = FlashAttention.apply(fold(q, sq), fold(k, sk), fold(v, sk),
                             rope_cos, rope_sin, float(scale), bool(causal))
    return o.reshape(b, h, sq, d).transpose(1, 2)
