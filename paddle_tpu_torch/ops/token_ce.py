"""The streamed token cross entropy over logits [N, V] (kernel C of the
training step's fused tier, ``csrc/token_ce.cu``).

The JAX package computes this inside its jitted step, where XLA fuses it
(the streamed path of ``paddle_tpu/nn/functional/loss.py:23-48``): no
``pallas_call`` stands behind it. No [N, V] f32 tensor exists on the
kernels' path. Kernel contract:
  x       [N, V]  f32 / bf16 / f16, the last axis contiguous
  labels  [N]     int64; rows equal to ``ignore`` count zero and leave the
                  mean's denominator; a label outside [0, V) gives NaN
  loss    [N] f32 lse - x[label] (with smoothing eps: (1 - eps) that +
                  eps (lse - mean x)); lse = log(sum(exp(f32(x - m)))) + m,
                  the difference taken in x's dtype (JAX's order)
  stats   [N, 2]  f32 (m, sum exp): what the backward needs
  totals  [3]     f32 (sum of loss, count of rows kept, sum / max(count, 1)),
                  summed in a fixed order
  dx      [N, V]  x's dtype: g_r (softmax - (1 - eps) onehot - eps / V)
                  with g_r per row (none), one scalar (sum), or one scalar
                  over max(count, 1) read on the device (mean)

``token_ce_fwd`` / ``token_ce_bwd`` launch the kernels for CUDA tensors
(each call counted in ``.launches``; the forward is two launches, the rows
and then the totals) and run ``token_ce_fwd_plain`` / ``token_ce_bwd_plain``
for CPU tensors. ``token_cross_entropy`` is the public op, a
``torch.autograd.Function``.

The forward takes one of three routes, chosen by ``fwd_plan`` from the
logits' dtype and V alone and passed to the kernel, which runs that route
or refuses it: "rows" (a block a row, the row kept in shared memory
between the max and the exp-sum), "cluster" (2, 4 or 8 blocks a row over
DSMEM) and "two-pass" (a block a row, read twice: rows wider than 512
KB). ``token_ce_fwd.route`` names the route of the last launch.
"""
import torch

from . import _launch as L

__all__ = ["token_cross_entropy", "token_ce_fwd", "token_ce_bwd",
           "token_ce_fwd_plain", "token_ce_bwd_plain", "fwd_plan"]

# the forward's shapes (csrc/token_ce.cu)
ROW_THREADS = 512                   # routes "rows" / "cluster": NT_ROW
CLUSTER_MAX = 8
TWO_PASS_THREADS = 256              # route "two-pass": NT


def fwd_plan(n, vocab, dtype):
    """The forward's route for N rows of V logits in ``dtype``, from those
    alone: route, 16-byte chunks a thread holds (a power of two; at most 8
    for 16-bit logits, 4 for f32: 64 KB a block), blocks a row, threads a
    block, blocks of the grid and the bytes of a row a block holds. The
    kernel takes the route as it is."""
    size = 4 if dtype == torch.float32 else 2
    maxc = 4 if size == 4 else 8
    per = ROW_THREADS * 8
    route, chunks, cluster = "two-pass", 0, 1
    for c in (1, 2, 4, 8):
        if c <= maxc and per * c >= vocab:
            route, chunks = "rows", c
            break
    else:
        for cs in (2, 4, 8):
            if per * maxc * cs >= vocab:
                route, chunks, cluster = "cluster", maxc, cs
                break
    threads = TWO_PASS_THREADS if route == "two-pass" else ROW_THREADS
    held = per * chunks * size if chunks else 0
    return {"route": route, "chunks": chunks, "cluster": cluster,
            "threads": threads, "blocks": n * cluster, "block_bytes": held}


_GMODE = {"none": 0, "sum": 1, "mean": 2}


def _gold(x, labels):
    """x[row, label] in f32, NaN where the label is outside [0, V)."""
    vocab = x.shape[1]
    inr = (labels >= 0) & (labels < vocab)
    gold = torch.gather(x, 1, labels.clamp(0, vocab - 1)[:, None])[:, 0]
    return torch.where(inr, gold.to(torch.float32),
                       torch.full_like(gold, float("nan"),
                                       dtype=torch.float32))


def token_ce_fwd_plain(x, labels, ignore, smoothing):
    """(loss, stats, totals) in plain PyTorch, the JAX function's ops."""
    valid = labels != ignore
    m = x.amax(dim=-1, keepdim=True)
    s = torch.exp((x - m).to(torch.float32)).sum(-1)
    lse = torch.log(s) + m[:, 0].to(torch.float32)
    loss = lse - _gold(x, labels)
    if smoothing > 0:
        loss = (1 - smoothing) * loss + smoothing * (
            lse - x.to(torch.float32).mean(-1))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    cnt = valid.to(torch.float32).sum()
    tot = loss.sum()
    totals = torch.stack([tot, cnt, tot / cnt.clamp_min(1.0)])
    stats = torch.stack([m[:, 0].to(torch.float32), s], dim=-1)
    return loss, stats, totals


def token_ce_bwd_plain(x, labels, stats, g, totals, ignore, smoothing,
                       reduction):
    """dx [N, V] in x's dtype, in plain PyTorch."""
    n, vocab = x.shape
    if reduction == "none":
        gr = g
    else:
        gr = g.expand(n)
        if reduction == "mean":
            gr = gr / totals[1].clamp_min(1.0)
    gr = torch.where(labels == ignore, torch.zeros_like(gr), gr)
    e = torch.exp((x - stats[:, :1].to(x.dtype)).to(torch.float32))
    t = ((1 - smoothing) * gr + smoothing * gr) / stats[:, 1]
    d = t[:, None] * e - (smoothing * gr / vocab)[:, None]
    cols = torch.arange(vocab, device=x.device)
    hit = (cols[None, :] == labels[:, None]).to(torch.float32)
    d = d - hit * ((1 - smoothing) * gr)[:, None]
    return d.to(x.dtype)


def _check(name, x, labels):
    if x.dim() != 2 or x.stride(1) != 1 or labels.shape != (x.shape[0],) \
            or labels.dtype != torch.int64 or labels.device != x.device \
            or not labels.is_contiguous():
        raise ValueError(f"{name}: x must be [N, V] with its last axis "
                         "contiguous and labels a contiguous int64 [N] on "
                         "its device")
    if x.shape[1] == 0 or x.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: V={x.shape[1]} out of range")


def _vec(x):
    return x.shape[1] % 8 == 0 and x.stride(0) % 8 == 0 and L.aligned16(x)


def token_ce_fwd(x, labels, ignore, smoothing):
    """(loss [N], stats [N, 2], totals [3]), all f32. A CPU tensor runs the
    plain version; a CUDA tensor launches the forward kernels on
    ``fwd_plan``'s route (the call counted once in
    ``token_ce_fwd.launches``, the route in ``token_ce_fwd.route``) or
    raises."""
    if not L.on_cuda("token_ce_fwd", x):
        return token_ce_fwd_plain(x, labels, ignore, smoothing)
    _check("token_ce_fwd", x, labels)
    n, vocab = x.shape
    plan = fwd_plan(n, vocab, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    loss, stats = torch.empty(n, **f32), torch.empty((n, 2), **f32)
    totals = torch.empty(3, **f32)
    rc = L.entry("token_ce", "token_ce_fwd")(
        L.dtype_code("token_ce_fwd", x), int(_vec(x)), x.data_ptr(),
        labels.data_ptr(), loss.data_ptr(), stats.data_ptr(),
        totals.data_ptr(), n, x.stride(0), vocab, int(ignore),
        float(1 - smoothing), float(smoothing), plan["chunks"],
        plan["cluster"], L.stream(x))
    L.raise_on("token_ce_fwd", rc)
    token_ce_fwd.launches += 1
    token_ce_fwd.route = plan["route"]
    return loss, stats, totals


token_ce_fwd.launches = 0
token_ce_fwd.route = None


def token_ce_bwd(x, labels, stats, g, totals, ignore, smoothing, reduction):
    """dx [N, V] in x's dtype for the row-loss gradient ``g`` ([N] for
    reduction "none", else a 0-dim f32 of the sum or mean). A CPU tensor
    runs the plain version; a CUDA tensor launches the backward kernel
    (counted in ``token_ce_bwd.launches``) or raises."""
    if not L.on_cuda("token_ce_bwd", x):
        return token_ce_bwd_plain(x, labels, stats, g, totals, ignore,
                                  smoothing, reduction)
    _check("token_ce_bwd", x, labels)
    n, vocab = x.shape
    g = g.to(torch.float32).contiguous()
    if g.numel() != (n if reduction == "none" else 1):
        raise ValueError("token_ce_bwd: g does not match the reduction")
    dx = torch.empty((n, vocab), dtype=x.dtype, device=x.device)
    rc = L.entry("token_ce", "token_ce_bwd")(
        L.dtype_code("token_ce_bwd", x), int(_vec(x) and _vec(dx)),
        x.data_ptr(), labels.data_ptr(), stats.data_ptr(), g.data_ptr(),
        totals.data_ptr(), dx.data_ptr(), n, x.stride(0), vocab, int(ignore),
        float(1 - smoothing), float(smoothing), _GMODE[reduction],
        L.stream(x))
    L.raise_on("token_ce_bwd", rc)
    token_ce_bwd.launches += 1
    return dx


token_ce_bwd.launches = 0


class TokenCrossEntropy(torch.autograd.Function):
    """Kernel C with autograd: x [N, V], labels [N] -> the loss per row
    ("none"), or its sum or mean over the rows kept. ``token_ce_fwd`` /
    ``token_ce_bwd`` are looked up at call time."""

    @staticmethod
    def forward(ctx, x, labels, ignore, smoothing, reduction):
        loss, stats, totals = token_ce_fwd(x, labels, ignore, smoothing)
        ctx.save_for_backward(x, labels, stats, totals)
        ctx.args = (ignore, smoothing, reduction)
        ctx.mark_non_differentiable(labels)
        if reduction == "none":
            return loss
        return totals[0] if reduction == "sum" else totals[2]

    @staticmethod
    def backward(ctx, g):
        x, labels, stats, totals = ctx.saved_tensors
        ignore, smoothing, reduction = ctx.args
        dx = token_ce_bwd(x, labels, stats, g, totals, ignore, smoothing,
                          reduction)
        return dx, None, None, None, None


def token_cross_entropy(logits, labels, ignore_index=-100, reduction="mean",
                        label_smoothing=0.0):
    """Softmax cross entropy of ``logits`` [..., V] against int labels
    [...] (or [..., 1]) through kernel C: f32 loss per row (reduction
    "none", shape [...]), or its sum, or its mean over the rows whose label
    is not ``ignore_index`` (at least 1)."""
    vocab = logits.shape[-1]
    lbl = labels.to(torch.int64)
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(-1)
    lead = lbl.shape
    x = logits.reshape(-1, vocab)
    if x.stride(-1) != 1:
        x = x.contiguous()
    if reduction not in ("mean", "sum"):
        reduction = "none"
    out = TokenCrossEntropy.apply(x, lbl.reshape(-1).contiguous(),
                                  int(ignore_index), float(label_smoothing),
                                  reduction)
    return out.reshape(lead) if reduction == "none" else out
