"""Blockwise LM-head cross entropy for the PyTorch port (counterpart of
``paddle_tpu/ops/pallas/blockwise_ce.py``).

The LM-head product ``h @ w`` and the softmax cross entropy are one
computation: the ``[T, V]`` logits never exist in device memory, forward
or backward. Kernel contract:
  h       [T, H]   float32 / bfloat16 / float16, contiguous
  w       [H, V]   h's dtype, contiguous
  labels  [T]      int64; rows equal to ``ignore`` count zero
  loss    [T] f32  lse - logit[label] (0 on ignored rows)
  lse     [T] f32  row logsumexp of the f32 logits (the backward's residual;
                   the TPU kernel keeps it as an [8, T] strip, a lane-tiling
                   artifact)

``ce_fwd``, ``ce_bwd_dh`` and ``ce_bwd_dw`` launch the CUDA kernels of
``csrc/blockwise_ce.cu`` for CUDA tensors (each counted in its
``.launches``) and run the plain versions for CPU tensors; any other
device, and any input the kernels do not take, raises. The forward takes
one of three routes, chosen from dtype and shapes before launch
(``fwd_plan``) and recorded in ``ce_fwd.route``: ``"wgmma"`` (bf16 /
fp16: warp-specialised ``wgmma`` fed by a TMA ring), ``"wgmma-pitched"``
(the same over copies of h and / or w whose rows are padded to 16 bytes,
where H or V is not a multiple of 8: TMA reads only rows that start on 16
bytes) or ``"cuda-core"`` (f32). The backward takes
one of two routes, chosen from dtype and H before launch and recorded in
``ce_bwd_dh.route`` / ``ce_bwd_dw.route``: ``"cluster"`` (bf16 with H up
to 8192: thread-block clusters, no f32 workspace) or ``"workspace"`` (f32,
f16, and bf16 wider than that: per-split f32 workspaces in device
memory). ``bwd_plan`` reads the cluster plan from the kernels' source.

The plain versions take the Pallas bodies' dtype steps: logits are
``h @ w`` with f32 accumulation of the native operands, the gold logit is
read from those f32 logits, a label outside ``[0, V)`` that is not
``ignore`` has no gold logit (loss = lse),
``dl = (exp(logits - lse) - onehot) * g`` is zero on ignored rows,
``dh = dl @ w.float().T`` is cast to h's dtype and ``dw = h.float().T @ dl``
to w's.

``blockwise_lm_head_ce`` is the public op, a ``torch.autograd.Function``
saving ``(h, w, labels, lse)`` as the JAX ``_vjp_fwd`` does. A tied LM
head hands it the transposed ``[H, V]`` view of the ``[V, H]`` embedding:
the op makes ``w`` contiguous (one copy of the table per forward; the
copy is what the backward reads) and autograd transposes dw back through
the view, so the kernels take only the ``[H, V]`` layout.
"""
import ctypes
import functools

import torch

__all__ = ["ce_fwd", "ce_bwd_dh", "ce_bwd_dw", "ce_fwd_plain",
           "ce_bwd_dh_plain", "ce_bwd_dw_plain", "blockwise_lm_head_ce",
           "fwd_plan", "bwd_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _logits(h, w):
    return torch.matmul(h.float(), w.float())


def ce_fwd_plain(h, w, labels, ignore):
    """(loss [T] f32, lse [T] f32) in plain PyTorch."""
    logits = _logits(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    vocab = w.shape[1]
    in_range = (labels >= 0) & (labels < vocab)
    gold = torch.gather(logits, 1, labels.clamp(0, vocab - 1)[:, None])[:, 0]
    gold = torch.where(in_range, gold, torch.zeros_like(gold))
    loss = torch.where(labels != ignore, lse - gold, torch.zeros_like(lse))
    return loss, lse


def _dlogits(h, w, labels, g, lse, ignore):
    """(softmax - onehot(label)) * g in f32, zero on ignored rows."""
    p = torch.exp(_logits(h, w) - lse[:, None])
    cols = torch.arange(w.shape[1], device=h.device)
    hit = (cols[None, :] == labels[:, None]).to(torch.float32)
    scale = torch.where(labels == ignore, torch.zeros_like(g), g)
    return (p - hit) * scale[:, None]


def ce_bwd_dh_plain(h, w, labels, g, lse, ignore):
    """dh [T, H] in h's dtype, in plain PyTorch."""
    dl = _dlogits(h, w, labels, g, lse, ignore)
    return torch.matmul(dl, w.float().t()).to(h.dtype)


def ce_bwd_dw_plain(h, w, labels, g, lse, ignore):
    """dw [H, V] in w's dtype, in plain PyTorch."""
    dl = _dlogits(h, w, labels, g, lse, ignore)
    return torch.matmul(h.float().t(), dl).to(w.dtype)


def _check(name, h, w, labels, *strips):
    """Refuse what the kernels do not take; ``strips`` are [T] f32
    tensors (g and lse)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0] \
            or labels.shape != (h.shape[0],):
        raise ValueError(f"{name}: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)} must be [T, H], "
                         "[H, V], [T]")
    if h.dtype not in _DTYPE_CODE or w.dtype != h.dtype:
        raise ValueError(f"{name}: h {h.dtype} and w {w.dtype} must share "
                         "one of float32, bfloat16, float16")
    if labels.dtype != torch.int64:
        raise ValueError(f"{name}: labels must be int64, got {labels.dtype}")
    t, hid = h.shape
    vocab = w.shape[1]
    if vocab == 0 or hid == 0 or max(t, hid, vocab) >= 2 ** 31:
        raise ValueError(f"{name}: sizes T={t}, H={hid}, V={vocab} out of "
                         "range")
    for s in strips:
        if s.shape != (t,) or s.dtype != torch.float32:
            raise ValueError(f"{name}: g and lse must be float32 [{t}]")
    for x in (h, w, labels, *strips):
        if x.device != h.device or not x.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"on {h.device}")


def _device(name, h):
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {h.device}")
    return h.device.type == "cuda"


def _raise_on(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(t, vocab, device):
    """Vocab splits of the workspace dh, chosen by the kernels' own source
    from their tile sizes and the card's SM count (the forward takes its
    own from ``fwd_plan``)."""
    return _launcher("splits")(t, vocab, _sms(device))


PLAN_KEYS = ("route", "cluster", "slice", "panels", "groups", "tile_tokens",
             "tile_vocab", "dh_clusters", "dw_clusters", "dh_smem_bytes",
             "dw_smem_bytes", "dh_max_active_clusters",
             "dw_max_active_clusters", "dh_busy_sms", "dw_busy_sms")


@functools.lru_cache(maxsize=64)
def _plan(t, hid, vocab, sms):
    out = (ctypes.c_int * len(PLAN_KEYS))()
    n = _launcher("plan")(hid, vocab, t, sms, out)
    if n != len(PLAN_KEYS):
        raise ValueError(f"bwd_plan: no plan for T={t}, H={hid}, V={vocab}")
    return dict(zip(PLAN_KEYS, out))


def bwd_plan(t, hid, vocab, device=None):
    """The bf16 backward's plan from ``csrc/blockwise_ce.cu`` for T tokens,
    H hidden units and V columns on the card: ``route`` 1 for the cluster
    kernel (0: the workspace bodies), blocks per ``cluster``, the hidden
    ``slice`` and ``panels`` of 128 a block multiplies, ``groups`` of
    clusters per tile, the tile, the clusters of each launch, their shared
    memory, how many fit at once and the SMs they keep busy."""
    device = torch.device("cuda") if device is None else device
    return dict(_plan(int(t), int(hid), int(vocab), _sms(device)))


FWD_PLAN_KEYS = ("route", "splits", "tiles_per_split", "tile_tokens",
                 "tile_vocab", "stages", "blocks", "scratch_floats",
                 "h_copy_bytes", "w_copy_bytes")
FWD_ROUTES = ("cuda-core", "wgmma", "wgmma-pitched")


@functools.lru_cache(maxsize=64)
def _fwd_plan(code, t, hid, vocab, sms):
    out = (ctypes.c_longlong * len(FWD_PLAN_KEYS))()
    n = _launcher("fwd_plan")(code, t, hid, vocab, sms, out)
    if n != len(FWD_PLAN_KEYS):
        raise ValueError(f"fwd_plan: no plan for T={t}, H={hid}, V={vocab}")
    plan = dict(zip(FWD_PLAN_KEYS, out))
    plan["route"] = FWD_ROUTES[plan["route"]]
    return plan


def fwd_plan(t, hid, vocab, dtype=torch.bfloat16, device=None):
    """The forward's plan from ``csrc/blockwise_ce.cu`` for T tokens, H
    hidden units and V columns in ``dtype`` on the card: its ``route``
    (``FWD_ROUTES``), vocab ``splits`` and tiles per split, the tile, the
    ring's ``stages``, the ``blocks`` of the launch, the f32 scratch it
    needs and the bytes of h and w it copies to padded rows."""
    device = torch.device("cuda") if device is None else device
    return dict(_fwd_plan(_DTYPE_CODE[dtype], int(t), int(hid), int(vocab),
                          _sms(device)))


def _aligned(x):
    """x, or a copy of it on a 16-byte boundary (TMA's rule for h and w)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bwd_route(h, vocab):
    if h.dtype != torch.bfloat16:
        return "workspace"
    plan = bwd_plan(h.shape[0], h.shape[1], vocab, h.device)
    return "cluster" if plan["route"] == 1 else "workspace"


def ce_fwd(h, w, labels, ignore):
    """(loss, lse) of the LM-head cross entropy. A CPU tensor runs the
    plain version; a CUDA tensor launches the forward kernel (counted in
    ``ce_fwd.launches``) or raises."""
    if not _device("ce_fwd", h):
        return ce_fwd_plain(h, w, labels, ignore)
    _check("ce_fwd", h, w, labels)
    t, hid = h.shape
    vocab = w.shape[1]
    loss = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    if t == 0:
        return loss, lse
    plan = fwd_plan(t, hid, vocab, h.dtype, h.device)
    if plan["route"] != "cuda-core":
        h, w = _aligned(h), _aligned(w)
    nsplit = plan["splits"]
    part = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                       device=h.device)
    rc = _launcher("fwd")(
        _DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(), labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), part.data_ptr(), t, hid, vocab,
        nsplit, int(ignore), torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on("ce_fwd", rc)
    ce_fwd.route = plan["route"]
    ce_fwd.launches += 1
    return loss, lse


ce_fwd.launches = 0
ce_fwd.route = None


def ce_bwd_dh(h, w, labels, g, lse, ignore):
    """dh [T, H] in h's dtype. A CPU tensor runs the plain version; a CUDA
    tensor launches the dh kernel (counted in ``ce_bwd_dh.launches``) or
    raises."""
    if not _device("ce_bwd_dh", h):
        return ce_bwd_dh_plain(h, w, labels, g, lse, ignore)
    _check("ce_bwd_dh", h, w, labels, g, lse)
    t, hid = h.shape
    dh = torch.empty_like(h)
    if t == 0:
        return dh
    route = _bwd_route(h, w.shape[1])
    nsplit, ws = 1, None
    if route == "workspace":
        nsplit = _splits(t, w.shape[1], h.device)
        ws = torch.empty((nsplit, t, hid), dtype=torch.float32,
                         device=h.device)
    rc = _launcher("dh")(
        _DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(), labels.data_ptr(),
        g.data_ptr(), lse.data_ptr(), None if ws is None else ws.data_ptr(),
        dh.data_ptr(), t, hid, w.shape[1], nsplit, int(ignore),
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on("ce_bwd_dh", rc)
    ce_bwd_dh.route = route
    ce_bwd_dh.launches += 1
    return dh


ce_bwd_dh.launches = 0
ce_bwd_dh.route = None


def ce_bwd_dw(h, w, labels, g, lse, ignore):
    """dw [H, V] in w's dtype. A CPU tensor runs the plain version; a CUDA
    tensor launches the dw kernel (counted in ``ce_bwd_dw.launches``) or
    raises."""
    if not _device("ce_bwd_dw", h):
        return ce_bwd_dw_plain(h, w, labels, g, lse, ignore)
    _check("ce_bwd_dw", h, w, labels, g, lse)
    t, hid = h.shape
    if t == 0:
        return torch.zeros_like(w)
    dw = torch.empty_like(w)
    route = _bwd_route(h, w.shape[1])
    ws = None
    if route == "workspace":
        ws = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    rc = _launcher("dw")(
        _DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(), labels.data_ptr(),
        g.data_ptr(), lse.data_ptr(), None if ws is None else ws.data_ptr(),
        dw.data_ptr(), t, hid, w.shape[1], int(ignore),
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on("ce_bwd_dw", rc)
    ce_bwd_dw.route = route
    ce_bwd_dw.launches += 1
    return dw


ce_bwd_dw.launches = 0
ce_bwd_dw.route = None


@functools.cache
def _launcher(which):
    """The kernel's C entry point with its prototype bound, built and
    loaded on the first launch."""
    from . import _build
    lib = _build.load("blockwise_ce")
    if which == "splits":
        fn = lib.blockwise_ce_splits
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return fn
    if which == "fwd_plan":
        fn = lib.blockwise_ce_fwd_plan
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        return fn
    if which == "plan":
        fn = lib.blockwise_ce_bwd_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        return fn
    if which == "cluster_check":
        fn = lib.blockwise_ce_cluster_check
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn
    fn = getattr(lib, f"blockwise_ce_{which}_launch")
    if which == "fwd":
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    elif which == "dh":
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class BlockwiseCE(torch.autograd.Function):
    """Per-token LM-head cross entropy with the kernels as forward and
    backward; saves (h, w, labels, lse). ``ce_fwd`` / ``ce_bwd_dh`` /
    ``ce_bwd_dw`` are looked up at call time."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index):
        h, w = h.contiguous(), w.contiguous()
        loss, lse = ce_fwd(h, w, labels, ignore_index)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.ignore = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = ce_bwd_dh(h, w, labels, g, lse, ctx.ignore)
        if ctx.needs_input_grad[1]:
            dw = ce_bwd_dw(h, w, labels, g, lse, ctx.ignore)
        return dh, dw, None, None


def blockwise_lm_head_ce(h, w, labels, ignore_index=-100):
    """Per-token cross entropy of the LM head, the logits never in memory.

    h [T, H], w [H, V] (h's dtype), labels [T] integers -> loss [T] f32.
    Tokens whose label is ``ignore_index`` get loss 0 and zero gradient."""
    return BlockwiseCE.apply(h, w, labels.to(torch.int64).contiguous(),
                             int(ignore_index))
