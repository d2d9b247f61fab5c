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

The vocab-sharded form (fleet's ``ParallelCrossEntropy`` and the mesh
step's vocab-parallel LM head): x [N, V_r] holds the vocabulary columns
[start, start + V_r) of a V split evenly over the model-parallel ranks.
``token_ce_fwd_partial`` (one launch, the forward's route) writes each
row's partials f32 [N, 3]: (m_r, s_r = sum exp(x - m_r), t_r = x[label -
start] where the label falls in the shard, else 0).
``combine_partials`` merges the ranks' partials with the caller's
collectives (an all_reduce MAX of m, then one all_reduce SUM of (s_r
exp(m_r - M), t_r - M on the rank holding the label)) into the loss, log
S - (x[label] - M) as JAX's ``ParallelCrossEntropy`` takes it on shifted
logits (0 on ignored rows), and the stats (M, S) with which
``token_ce_bwd(..., start=)`` writes the shard's dx = g (exp(x - M) / S -
[x is the label]). No label smoothing: the JAX layer has none.

The forward takes one of three routes, chosen by ``fwd_plan`` from the
logits' dtype and V alone and passed to the kernel, which runs that route
or refuses it: "rows" (a block a row, the row kept in shared memory
between the max and the exp-sum), "cluster" (2, 4 or 8 blocks a row over
DSMEM) and "two-pass" (a block a row, read twice: rows wider than 512
KB). ``token_ce_fwd.route`` names the route of the last launch.
"""
import torch

from . import _launch as L
from . import work as _work

__all__ = ["token_cross_entropy", "token_ce_fwd", "token_ce_bwd",
           "token_ce_fwd_plain", "token_ce_bwd_plain", "fwd_plan",
           "token_ce_fwd_partial", "token_ce_fwd_partial_plain",
           "combine_partials"]

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
                       reduction, start=0):
    """dx [N, V] in x's dtype, in plain PyTorch; ``start`` the first
    vocabulary column x holds (the vocab-sharded form)."""
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
    hit = (cols[None, :] + start == labels[:, None]).to(torch.float32)
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
    if _work.counting():
        _work.note("token_ce_fwd", *_work.token_ce_fwd(n, vocab,
                                                        x.element_size()))
    return loss, stats, totals


token_ce_fwd.launches = 0
token_ce_fwd.route = None


def token_ce_bwd(x, labels, stats, g, totals, ignore, smoothing, reduction,
                 start=0):
    """dx [N, V] in x's dtype for the row-loss gradient ``g`` ([N] for
    reduction "none", else a 0-dim f32 of the sum or mean); ``start`` the
    first vocabulary column x holds (the vocab-sharded form, with the
    combined stats; ``totals`` is read for "mean" only). A CPU tensor runs
    the plain version; a CUDA tensor launches the backward kernel
    (counted in ``token_ce_bwd.launches``) or raises."""
    if not L.on_cuda("token_ce_bwd", x):
        return token_ce_bwd_plain(x, labels, stats, g, totals, ignore,
                                  smoothing, reduction, start)
    _check("token_ce_bwd", x, labels)
    n, vocab = x.shape
    g = g.to(torch.float32).contiguous()
    if g.numel() != (n if reduction == "none" else 1):
        raise ValueError("token_ce_bwd: g does not match the reduction")
    dx = torch.empty((n, vocab), dtype=x.dtype, device=x.device)
    rc = L.entry("token_ce", "token_ce_bwd")(
        L.dtype_code("token_ce_bwd", x), int(_vec(x) and _vec(dx)),
        x.data_ptr(), labels.data_ptr(), stats.data_ptr(), g.data_ptr(),
        L.ptr(totals), dx.data_ptr(), n, x.stride(0), vocab, int(ignore),
        int(start), float(1 - smoothing), float(smoothing),
        _GMODE[reduction], L.stream(x))
    L.raise_on("token_ce_bwd", rc)
    token_ce_bwd.launches += 1
    if _work.counting():
        _work.note("token_ce_bwd", *_work.token_ce_bwd(n, vocab,
                                                        x.element_size()))
    return dx


token_ce_bwd.launches = 0


def token_ce_fwd_partial_plain(x, labels, start):
    """The shard's partials [N, 3] f32 (m_r, s_r, t_r) in plain PyTorch."""
    vocab = x.shape[1]
    m = x.amax(dim=-1, keepdim=True)
    s = torch.exp((x - m).to(torch.float32)).sum(-1)
    local = labels - start
    inr = (local >= 0) & (local < vocab)
    t = torch.gather(x, 1, local.clamp(0, vocab - 1)[:, None])[:, 0]
    t = torch.where(inr, t.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=x.device))
    return torch.stack([m[:, 0].to(torch.float32), s, t], dim=-1)


def token_ce_fwd_partial(x, labels, start):
    """The shard's partials [N, 3] f32 for logits x [N, V_r] holding the
    vocabulary columns [start, start + V_r). A CPU tensor runs the plain
    version; a CUDA tensor launches the forward kernel on ``fwd_plan``'s
    route (counted in ``token_ce_fwd_partial.launches``, the route in
    ``.route``) or raises."""
    if not L.on_cuda("token_ce_fwd_partial", x):
        return token_ce_fwd_partial_plain(x, labels, start)
    _check("token_ce_fwd_partial", x, labels)
    n, vocab = x.shape
    plan = fwd_plan(n, vocab, x.dtype)
    part = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    rc = L.entry("token_ce", "token_ce_fwd_partial")(
        L.dtype_code("token_ce_fwd_partial", x), int(_vec(x)), x.data_ptr(),
        labels.data_ptr(), part.data_ptr(), n, x.stride(0), vocab,
        int(start), plan["chunks"], plan["cluster"], L.stream(x))
    L.raise_on("token_ce_fwd_partial", rc)
    token_ce_fwd_partial.launches += 1
    token_ce_fwd_partial.route = plan["route"]
    if _work.counting():
        _work.note("token_ce_fwd_partial", *_work.token_ce_fwd_partial(
            n, vocab, x.element_size()))
    return part


token_ce_fwd_partial.launches = 0
token_ce_fwd_partial.route = None


def combine_partials(part, labels, start, vocab_local, ignore, reduce_max,
                     reduce_sum):
    """(loss [N] f32, stats [N, 2] f32 (M, S)) of the whole rows from this
    rank's partials; ``reduce_max`` / ``reduce_sum`` reduce a float32
    tensor in place over the ranks that hold the vocabulary's shards (the
    identity on one rank). The loss is JAX's ``ParallelCrossEntropy``'s:
    log S less the label's shifted logit (0 where no shard holds the
    label), 0 on rows labelled ``ignore``."""
    m_r = part[:, 0]
    big_m = reduce_max(m_r.clone())
    local = labels - start
    hit = (local >= 0) & (local < vocab_local)
    st = torch.stack([part[:, 1] * torch.exp(m_r - big_m),
                      torch.where(hit, part[:, 2] - big_m,
                                  torch.zeros_like(m_r))], dim=-1)
    st = reduce_sum(st)
    loss = torch.log(st[:, 0]) - st[:, 1]
    loss = torch.where(labels == ignore, torch.zeros_like(loss), loss)
    return loss, torch.stack([big_m, st[:, 0]], dim=-1)


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
