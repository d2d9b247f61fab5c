"""FlashMask attention for the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/flashmask.py``): flash attention in which every
key column j masks the query rows of one interval ``[sr_j, er_j)`` on
top of the causal mask, so a document, sliding-window or shared-prompt
mask costs O(S) memory instead of O(S^2).

Kernel contract (heads folded into batch, as the JAX package's):
  q, o, do  [BH, Sq, D]   float32 / bfloat16 / float16, D in FM_HEAD_DIMS
  k, v      [BH, Sk, D]
  sr, er    [B, MH, Sk]   int32, BH = B * H and H a multiple of MH: head
            h reads mask head h // (H / MH) (MH = H is one mask per head)
  lse       [BH, Sq]      float32 row logsumexp of the scaled scores
A column is visible to a row when col < Sk, row >= col if causal (top
left aligned), and not sr_col <= row < er_col (``_mask_block`` :33-46).
The TPU broadcasts sr / er (:346-350) and lse (:119-120) to eight
sublanes; the port keeps one row of each.

``flashmask_fwd`` / ``flashmask_bwd`` launch the CUDA kernels of
``csrc/flashmask.cu`` for CUDA tensors and run ``flashmask_fwd_plain``
/ ``flashmask_bwd_plain`` for CPU tensors; nothing else chooses between
them. The plain versions are written from the formulas with the saved
lse (not through autograd) and take the Pallas bodies' dtype steps: q,
k, v, o and do cast to f32 (:88-90, :140-144, :188-192), p computed in
f32 and never rounded, o / dq / dk / dv cast to their dtypes once at the
end. A row that sees no column has o = 0 and lse = -1e30 (:114-118), p =
0 in the backward (:152, :200), dq = 0, and adds nothing to dk or dv.
They work on groups of heads so that no ``[heads, Sq, Sk]`` f32 temporary
passes ``PLAIN_CHUNK_ELEMS`` elements. The bf16 / fp16 kernels take the
f32 p to the tensor cores as 16-bit parts (``split_parts`` is that split
on the CPU): the forward ``FM_FWD_PARTS`` of p in p v, the backward
``FM_PARTS`` of p and ds each, within 2**-16 |p| and |ds| of the f32
values; ``fwd_route`` and ``bwd_route`` name the body a dtype (and mode)
launch.

``flashmask_attention_bshd`` is the [B, S, H, D] entry (:317-353) with a
``torch.autograd.Function`` around the pair; the index gets no gradient.
"""
import ctypes
import functools
import math

import torch

from . import work as _work
from .flash_attention import (_DTYPE_CODE, FM_HEAD_DIMS, NEG_INF, _check,
                              _check_saved)

PLAIN_CHUNK_ELEMS = 1 << 28     # f32 elements of one [heads, Sq, Sk] temporary
FM_PARTS = 2    # 16-bit parts of FlashMask's p and ds in the tensor-core
                # backward (``FM_PARTS`` of csrc/flashmask.cu)
FM_FWD_PARTS = 2    # 16-bit parts of the forward's p in p v
                    # (``FM_FWD_PARTS`` of csrc/flashmask.cu)


def split_parts(x, parts, dtype=torch.bfloat16):
    """``parts`` tensors of ``dtype`` that sum to the f32 ``x``, hi first:
    part i is what the parts before it leave of x, rounded to ``dtype``
    (x less a part is exact in f32). The CPU mirror of ``split_frag`` in
    csrc/mma_tiles.cuh, which feeds each part to its own tensor-core
    product: bf16 hi + lo is within 2**-16 |x| of x, hi + mid + lo is x
    where |x| >= 2**-110."""
    rest = x.float()
    out = []
    for i in range(parts):
        part = rest.to(dtype)
        out.append(part)
        if i + 1 < parts:
            rest = rest - part.float()
    return out


def _mask_rows(x, bh):
    """[B, MH, Sk] -> [BH, Sk]: head h of each batch row takes mask head
    h // (H / MH), as ``jnp.repeat`` over the mask heads gives it."""
    b, mh, sk = x.shape
    return x.repeat_interleave(bh // b // mh, dim=1).reshape(bh, sk)


def _visible(sr, er, sq, causal):
    """[n, Sq, Sk] bool of the (row, col) pairs a row sees, from the
    [n, Sk] interval bounds."""
    sk = sr.shape[-1]
    rows = torch.arange(sq, device=sr.device)[:, None]
    vis = ~((rows >= sr[:, None, :]) & (rows < er[:, None, :]))
    if causal:
        vis &= rows >= torch.arange(sk, device=sr.device)[None, :]
    return vis


def _head_groups(bh, sq, sk):
    n = max(1, PLAIN_CHUNK_ELEMS // max(1, sq * sk))
    return [slice(a, min(a + n, bh)) for a in range(0, bh, n)]


def flashmask_fwd_plain(q, k, v, sr, er, scale, causal):
    """(o in q's dtype, lse [BH, Sq] f32) of FlashMask attention in plain
    PyTorch."""
    bh, sq, _ = q.shape
    srx, erx = _mask_rows(sr, bh), _mask_rows(er, bh)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    for g in _head_groups(bh, sq, k.shape[1]):
        s = torch.matmul(q[g].float(), k[g].float().transpose(1, 2)) * scale
        vis = _visible(srx[g], erx[g], sq, causal)
        s = s.masked_fill(~vis, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * vis
        l = p.sum(dim=-1, keepdim=True)
        l = torch.where(l == 0, torch.ones_like(l), l)
        o[g] = (torch.matmul(p, v[g].float()) / l).to(q.dtype)
        lse[g] = (m + torch.log(l))[..., 0]
    return o, lse


def flashmask_bwd_plain(q, k, v, o, lse, do, sr, er, scale, causal):
    """Gradients (dq, dk, dv) of FlashMask attention from the saved o and
    lse, in plain PyTorch, each in its input's dtype."""
    bh, sq, _ = q.shape
    srx, erx = _mask_rows(sr, bh), _mask_rows(er, bh)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for g in _head_groups(bh, sq, k.shape[1]):
        qf, kf, vf = q[g].float(), k[g].float(), v[g].float()
        dof = do[g].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        vis = _visible(srx[g], erx[g], sq, causal)
        p = torch.where(vis, torch.exp(s - lse[g][..., None]),
                        torch.zeros((), device=q.device))
        dp = torch.matmul(dof, vf.transpose(1, 2))
        delta = (dof * o[g].float()).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dv[g] = torch.matmul(p.transpose(1, 2), dof).to(v.dtype)
        dk[g] = torch.matmul(ds.transpose(1, 2), qf).to(k.dtype)
        dq[g] = torch.matmul(ds, kf).to(q.dtype)
    return dq, dk, dv


def _check_mask(name, q, k, sr, er):
    """(H, MH) after refusing interval bounds the kernels do not take."""
    bh, sk = q.shape[0], k.shape[1]
    for t in (sr, er):
        if t.dtype != torch.int32 or t.dim() != 3 or t.shape[2] != sk \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: sr and er must be contiguous int32 "
                             f"[B, MH, {sk}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    b, mh = sr.shape[:2]
    if er.shape != sr.shape or b == 0 or mh == 0 or bh % b \
            or (bh // b) % mh:
        raise ValueError(f"{name}: sr {tuple(sr.shape)} / er "
                         f"{tuple(er.shape)} do not divide {bh} heads of q "
                         "into B rows of H heads with H a multiple of MH")
    return bh // b, mh


def _raise_on(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _ext(q, k, sr):
    """int32 scratch for the per-(mask row, k tile) (max sr, min er)."""
    nk = -(-k.shape[1] // _lib().flashmask_block_k())
    return torch.empty((sr.shape[0] * sr.shape[1] * nk * 2,),
                       dtype=torch.int32, device=q.device)


def flashmask_fwd(q, k, v, sr, er, scale, causal):
    """(o, lse) of FlashMask attention over [BH, S, D]. A CPU tensor runs
    the plain version; a CUDA tensor launches the forward kernel (counted
    in ``flashmask_fwd.launches``) or raises."""
    if q.device.type == "cpu":
        return flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flashmask_fwd: unsupported device {q.device}")
    _check("flashmask_fwd", q, k, v, head_dims=FM_HEAD_DIMS)
    h, mh = _check_mask("flashmask_fwd", q, k, sr, er)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    ext = _ext(q, k, sr)
    rc = _launcher("fwd")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        sr.data_ptr(), er.data_ptr(), ext.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, mh, sq, k.shape[1], d, float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flashmask_fwd", rc)
    flashmask_fwd.launches += 1
    if _work.counting():
        _note_work(("flashmask_fwd",), ("fwd",), q, k, sr, er, h, causal)
    return o, lse


flashmask_fwd.launches = 0

MODE_FLASHMASK = 0      # the interval mask and tile skip; f32 p and ds
MODE_TWOPASS = 1        # no interval; p and ds rounded to the input dtype


def _note_work(kernels, parts, q, k, sr, er, h, causal):
    """Report ``kernels``' work (``ops.work.flashmask``'s ``parts``) to
    the cost catalog's counter: the visible pairs of the interval mask
    (read back from the device: counting only), or of the causal mask
    without one."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if sr is None:
        pairs, idx = _work.flash_pairs(bh, sq, sk, causal), 0
    else:
        pairs = _work.flashmask_pairs(sr.cpu().numpy(), er.cpu().numpy(), h,
                                      sq, causal)
        idx = sr.numel()
    got = _work.flashmask(bh // h, h, sq, d, pairs, idx, q.element_size())
    for kernel, part in zip(kernels, parts):
        _work.note(kernel, *got[part])


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _bwd_prep(name, mode, q, k, o, do, sr, er):
    """Launch the backward's pre-pass: delta = rowsum(do * o) in f32 and,
    for FlashMask, the tile extremes. Returns what the dq and dk / dv
    launches read: (delta, ext or None, H, MH, sr, er)."""
    bh, sq, d = q.shape
    if mode == MODE_FLASHMASK:
        h, mh = _check_mask(name, q, k, sr, er)
        ext = _ext(q, k, sr)
    else:
        h, mh, ext = 1, 1, None
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _raise_on(name, _launcher("prep")(
        _DTYPE_CODE[q.dtype], o.data_ptr(), do.data_ptr(), *_ptrs(sr, er, ext),
        delta.data_ptr(), bh, h, mh, sq, k.shape[1], d,
        torch.cuda.current_stream(q.device).cuda_stream))
    return delta, ext, h, mh, sr, er


def _bwd_launch(which, name, mode, q, k, v, lse, do, prep, outs, scale,
                causal):
    """Launch the dq kernel (``which`` "dq", ``outs`` (dq,)) or the dk / dv
    kernel ("dkv", (dk, dv)) after ``_bwd_prep``; counts nothing."""
    delta, ext, h, mh, sr, er = prep
    bh, sq, d = q.shape
    _raise_on(name, _launcher(which)(
        mode, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(),
        *_ptrs(sr, er, ext), *_ptrs(*outs), bh, h, mh, sq, k.shape[1], d,
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream))


def _bwd_kernels(owner, mode, q, k, v, o, lse, do, sr, er, scale, causal):
    """The pre-pass, the dq kernel and the dk / dv kernel of
    ``csrc/flashmask.cu``, adding one to ``owner.dq_launches`` and
    ``owner.dkv_launches`` at each launch. ``mode`` picks the
    instantiation; the caller has checked the inputs."""
    name = owner.__name__
    prep = _bwd_prep(name, mode, q, k, o, do, sr, er)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bwd_launch("dq", name, mode, q, k, v, lse, do, prep, (dq,), scale,
                causal)
    owner.dq_launches += 1
    _bwd_launch("dkv", name, mode, q, k, v, lse, do, prep, (dk, dv), scale,
                causal)
    owner.dkv_launches += 1
    if _work.counting():
        _note_work((name + "_dq",
                    name + "_dkv"), ("dq", "dkv"), q, k, sr, er, prep[2],
                   causal)
    return dq, dk, dv


def flashmask_bwd(q, k, v, o, lse, do, sr, er, scale, causal):
    """(dq, dk, dv) of FlashMask attention from the saved o and lse. A CPU
    tensor runs the plain version; a CUDA tensor launches the dq kernel
    and the dk / dv kernel (counted in ``flashmask_bwd.dq_launches`` and
    ``flashmask_bwd.dkv_launches``) on the current stream, the forward's
    when autograd calls it, or raises."""
    if q.device.type == "cpu":
        return flashmask_bwd_plain(q, k, v, o, lse, do, sr, er, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flashmask_bwd: unsupported device {q.device}")
    _check("flashmask_bwd", q, k, v, o, do, head_dims=FM_HEAD_DIMS)
    _check_saved("flashmask_bwd", q, o, lse, do)
    return _bwd_kernels(flashmask_bwd, MODE_FLASHMASK, q, k, v, o, lse, do,
                        sr, er, scale, causal)


flashmask_bwd.dq_launches = 0
flashmask_bwd.dkv_launches = 0


def fwd_route(dtype):
    """(route, parts) of the forward kernel that ``dtype`` launches, as the
    built library reports it: ("tensor-core", the 16-bit parts of p in p v)
    or ("cuda-core", 0) for the f32 body. Builds the library."""
    parts = _lib().flashmask_fwd_parts(_DTYPE_CODE[dtype])
    if parts < 0:
        raise ValueError(f"fwd_route: dtype {dtype}")
    return ("tensor-core", parts) if parts else ("cuda-core", 0)


def bwd_route(mode, dtype):
    """(route, parts) of the backward kernels that ``mode``
    (``MODE_FLASHMASK`` / ``MODE_TWOPASS``) launches for ``dtype``, as the
    built library reports it: ("tensor-core", the 16-bit parts of p and ds
    a product) or ("cuda-core", 0) for the f32 body. Builds the library."""
    parts = _lib().flashmask_bwd_parts(mode, _DTYPE_CODE[dtype])
    if parts < 0:
        raise ValueError(f"bwd_route: mode {mode}, dtype {dtype}")
    return ("tensor-core", parts) if parts else ("cuda-core", 0)


@functools.cache
def _lib():
    from . import _build
    lib = _build.load("flashmask")
    lib.flashmask_block_k.argtypes = []
    lib.flashmask_block_k.restype = ctypes.c_int
    lib.flashmask_bwd_parts.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flashmask_bwd_parts.restype = ctypes.c_int
    lib.flashmask_fwd_parts.argtypes = [ctypes.c_int]
    lib.flashmask_fwd_parts.restype = ctypes.c_int
    return lib


@functools.cache
def _launcher(which):
    """A C entry point of ``csrc/flashmask.cu`` with its prototype bound,
    built and loaded on the first launch."""
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # BH, H, MH, Sq, Sk, D, scale, causal, stream
    shape = [i] * 6 + [f, i, ptr]
    fn, args = {
        "fwd": ("flashmask_fwd_launch", [i] + [ptr] * 8 + shape),
        "prep": ("flashmask_bwd_prep_launch", [i] + [ptr] * 6 + [i] * 6
                 + [ptr]),
        "dq": ("flashmask_bwd_dq_launch", [i, i] + [ptr] * 10 + shape),
        "dkv": ("flashmask_bwd_dkv_launch", [i, i] + [ptr] * 11 + shape),
    }[which]
    fn = getattr(_lib(), fn)
    fn.argtypes = args
    fn.restype = ctypes.c_int
    return fn


class FlashMaskAttention(torch.autograd.Function):
    """FlashMask attention over [BH, S, D] with the kernels as forward and
    backward; saves (q, k, v, sr, er, o, lse) as ``_fm_vjp_fwd``
    (:302-304) does; the interval bounds get no gradient.
    ``flashmask_fwd`` / ``flashmask_bwd`` are looked up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, sr, er, scale, causal):
        o, lse = flashmask_fwd(q, k, v, sr, er, scale, causal)
        ctx.save_for_backward(q, k, v, sr, er, o, lse)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, sr, er, o, lse = ctx.saved_tensors
        dq, dk, dv = flashmask_bwd(q, k, v, o, lse, do.contiguous(), sr, er,
                                   ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flashmask_attention_bshd(q, k, v, startend_row_indices, causal=True,
                             scale=None):
    """q [B, Sq, H, D], k / v [B, Sk, KVH, D] -> out [B, Sq, H, D].
    ``startend_row_indices`` [B, MH, Sk, 1] masks rows [start_j, Sq) of
    column j; [B, MH, Sk, 2] masks [start_j, end_j). MH is 1, KVH or H;
    head h reads mask head h // (H / MH). kv heads are repeated up to H.
    Integer indices are cast to int32."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    idx = startend_row_indices
    if idx.dim() != 4 or idx.shape[-1] not in (1, 2) or idx.shape[0] != b \
            or idx.shape[2] != sk or idx.shape[1] == 0 \
            or h % idx.shape[1]:
        raise ValueError(f"flashmask_attention: startend_row_indices "
                         f"{tuple(idx.shape)} must be [{b}, MH, {sk}, 1 or 2]"
                         f" with {h} heads a multiple of MH")
    if idx.dtype.is_floating_point or idx.dtype.is_complex \
            or idx.dtype == torch.bool:
        raise ValueError(f"flashmask_attention: startend_row_indices must be "
                         f"integers, got {idx.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hk != h:
        k = torch.repeat_interleave(k, h // hk, dim=2)
        v = torch.repeat_interleave(v, h // hk, dim=2)
    idx = idx.to(device=q.device, dtype=torch.int32)
    sr = idx[..., 0].contiguous()
    er = idx[..., 1].contiguous() if idx.shape[-1] == 2 \
        else torch.full_like(sr, sq)

    def fold(x, s):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    o = FlashMaskAttention.apply(fold(q, sq), fold(k, sk), fold(v, sk), sr,
                                 er, float(scale), bool(causal))
    return o.reshape(b, h, sq, d).transpose(1, 2)
