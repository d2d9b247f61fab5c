"""Context parallelism of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/context_parallel.py``): ring attention and
Ulysses attention over the sequence axis, ``split_sequence`` and
``SegmentParallel``.

The JAX package runs both attentions inside a ``shard_map`` over the
sequence axis of its mesh: the ring rotates K/V blocks with
``lax.ppermute`` and folds each into an f32 online softmax of einsums,
and Ulysses swaps the sharded dim from sequence to heads with
``lax.all_to_all`` around ``_sdpa_ref``. Here every rank is a process
(or, in tests, a thread) holding its contiguous block of the sequence,
``[B, S_loc, H, D]``, and the axis is a ``torch.distributed`` group: the
mesh's "sp" group (``mesh=`` a port ``Mesh`` or a ``ProcessMesh`` over
one, with ``axis_name``; fleet's "sep" is the mesh's "sp"), or the hybrid
group's sep group. Attention runs on the port's flash kernels.

Ring (``ring_attention``, a ``torch.autograd.Function``). Rank i sees
block i first, then the block of rank i - t after t hops (K/V travel at
their own kv heads, packed into one message a hop, to the next rank
over ``collective.batch_isend_irecv``). Each block it sees is one call
of the flash forward (K1) on (q_i, k_j, v_j): causal on the diagonal
block, full on an earlier one, none on a later one under ``causal``;
the block outputs are folded by their lse in f32 (the online softmax
of the JAX fold, a block at a time). The blocks still rotate all p - 1
hops, as the JAX scan does. The backward sends the blocks round the
ring again, each with its f32 dk / dv accumulator: every rank adds the
flash backward's (K2's) partials of its queries for the block it holds,
from the saved global o and lse, and sums its dq in f32 across the
blocks (``flash_bwd(..., dq_acc=)``); one last hop returns each
accumulator to its owner. Grouped kv heads are repeated up to the query
heads for each block, as ``flash_attention_bshd`` repeats them, and
their gradients summed back over each group in f32. A rank's attention
memory is linear in its block: the kernels never hold a [S_loc, S_loc]
score matrix. ``ring_attention_fwd`` / ``ring_attention_bwd`` are the
two passes without autograd (the Function runs them; ranks that are
threads on one card call them directly, since the autograd engine runs
every thread's CUDA backward on one device thread, where a ring's
blocking exchange would wait on itself). ``ring_attention_plain`` is the
JAX fold itself in torch on the whole sequence (f32 online softmax, the
-1e30 mask), the plain version the tests and the card's gate hold the
ring to.

Ulysses (``ulysses_attention``): an all_to_all ``autograd.Function``
(its backward the inverse all_to_all) turns ``[B, S_loc, H, D]`` into
``[B, S, H/p, D]``, the flash kernels attend over the whole sequence for
those heads, and the inverse all_to_all brings the output back. K/V
cross at their own head count when p divides it, else repeated to H
first (the JAX rule); H must divide by p.

The collectives of both land in the caller's ``stats`` ({"op,axis":
{"calls", "bytes"}}, the training step's tally) under the axis "sp".
On the CPU the flash entry points run their plain versions, as
everywhere in the port.
"""
import math

import torch

from .. import collective
from ...ops import flash_attention as _fa

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_plain",
           "ring_attention_fwd", "ring_attention_bwd", "split_sequence",
           "SegmentParallel"]

_NEG = -1e30  # finite mask value; -inf breaks online-softmax edge cases


class _Axis:
    """The context-parallel axis of this rank: its group (None for one
    rank), size, this rank's index and the tally's label."""

    def __init__(self, group, size, index, label="sp"):
        self.group, self.size, self.index, self.label = \
            group, int(size), int(index), label


def _sep_axis(mesh=None, axis_name=None, hcg=None):
    """The axis from ``mesh`` / ``axis_name``, else from the hybrid
    group's sep axis (``fleet.init(..., sep_degree=)``)."""
    if mesh is None or axis_name is None:
        if hcg is None:
            from .topology import get_hcg
            hcg = get_hcg()
        if hcg is None:
            raise RuntimeError(
                "context parallelism needs a mesh: call fleet.init with "
                "sep_degree>1, or pass mesh=/axis_name= explicitly")
        mesh, axis_name = hcg.mesh, "sp"
    axis = "sp" if axis_name == "sep" else axis_name
    port = getattr(mesh, "mesh", None)
    if port is None and hasattr(mesh, "groups"):
        port = mesh
    if port is None or axis not in port.shape:
        raise ValueError(
            f"context parallelism: axis {axis_name!r} needs a port Mesh "
            "(make_mesh(..., group=)) or a ProcessMesh over one")
    return _Axis(port.groups.get(axis), port.shape[axis], port.coords[axis],
                 axis)


def _fold(x):
    """[B, S, H, D] -> contiguous [B*H, S, D]."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unfold(x, b):
    """[B*H, S, D] -> [B, S, H, D] (a view)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _repeat(x, b, rep):
    """kv heads [B*KVH, S, D] repeated up to [B*H, S, D] (head h reads kv
    head h // rep)."""
    if rep == 1:
        return x
    bk, s, d = x.shape
    return x.reshape(b, bk // b, 1, s, d).expand(b, bk // b, rep, s, d) \
        .reshape(b * (bk // b) * rep, s, d)


def _unrepeat(g, b, rep):
    """The f32 gradient of ``_repeat``: [B*H, S, D] summed over each group
    of ``rep`` query heads to [B*KVH, S, D]."""
    bh, s, d = g.shape
    g = g.float()
    if rep == 1:
        return g
    return g.reshape(b, bh // b // rep, rep, s, d).sum(2) \
        .reshape(bh // rep, s, d)


def _pack(*ts):
    """One flat byte tensor of the given tensors (one message a hop)."""
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in ts])


def _unpack(buf, like):
    """The tensors of ``_pack`` back, shaped and typed as ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).view(t.shape))
        off += n
    return out


def _shift(buf, axis, stats):
    """``buf`` sent to the next rank of the ring; the previous rank's
    returned. One send and one receive, started together."""
    p, i = axis.size, axis.index
    out = torch.empty_like(buf)
    works = collective.batch_isend_irecv(
        [collective.P2POp(collective.isend, buf, (i + 1) % p, axis.group),
         collective.P2POp(collective.irecv, out, (i - 1) % p, axis.group)],
        axis=axis.label, stats=stats)
    for w in works:
        w.wait()
    return out


def _visible(causal, src, idx):
    """(whether rank idx attends to block src, whether causally)."""
    if causal and src > idx:
        return False, False
    return True, causal and src == idx


def _ring_fwd(q, k, v, axis, causal, scale, stats):
    """(q folded [B*H, S, D], o [B*H, S, D] in q's dtype, lse [B*H, S]
    f32, the K/V block folded) for the backward."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    p, idx = axis.size, axis.index
    qf = _fold(q)
    kv = torch.stack([_fold(k), _fold(v)])         # travels: [2, B*KVH, S, D]
    cur = kv
    o_acc = lse_acc = None
    for t in range(p):
        if t:
            cur = _unpack(_shift(_pack(cur), axis, stats), [kv])[0]
        seen, diag = _visible(causal, (idx - t) % p, idx)
        if not seen:
            continue
        o_j, lse_j = _fa.flash_fwd(qf, _repeat(cur[0], b, rep),
                                   _repeat(cur[1], b, rep), scale, diag)
        if o_acc is None:
            o_acc, lse_acc = o_j.float(), lse_j
            continue
        lse_new = torch.logaddexp(lse_acc, lse_j)
        o_acc = o_acc * torch.exp(lse_acc - lse_new)[..., None] \
            + o_j.float() * torch.exp(lse_j - lse_new)[..., None]
        lse_acc = lse_new
    return qf, o_acc.to(q.dtype), lse_acc, kv


def _ring_bwd(qf, kv, o, lse, do, b, rep, axis, causal, scale, stats):
    """(dq [B*H, S, D] f32, [dk, dv] [2, B*KVH, S, D] f32) of this rank's
    block, from the folded q, K/V block, o and lse of ``_ring_fwd``."""
    p, idx = axis.size, axis.index
    dof = _fold(do)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    cur = kv
    acc = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    for t in range(p):
        if t:
            cur, acc = _unpack(_shift(_pack(cur, acc), axis, stats),
                               [kv, acc])
        seen, diag = _visible(causal, (idx - t) % p, idx)
        if not seen:
            continue
        dq, dk_j, dv_j = _fa.flash_bwd(
            qf, _repeat(cur[0], b, rep), _repeat(cur[1], b, rep), o, lse,
            dof, scale, diag, dq_acc=dq)
        acc[0] += _unrepeat(dk_j, b, rep)
        acc[1] += _unrepeat(dv_j, b, rep)
    if p > 1:           # the accumulator home to the block's owner
        acc = _unpack(_shift(_pack(acc), axis, stats), [acc])[0]
    return dq, acc


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, stats):
        qf, o, lse, kv = _ring_fwd(q, k, v, axis, causal, scale, stats)
        ctx.save_for_backward(qf, kv, o, lse)
        ctx.args = (axis, causal, scale, stats, q.shape[0],
                    q.shape[2] // k.shape[2], k.dtype)
        return _unfold(o, q.shape[0])

    @staticmethod
    def backward(ctx, do):
        qf, kv, o, lse = ctx.saved_tensors
        axis, causal, scale, stats, b, rep, kdtype = ctx.args
        dq, acc = _ring_bwd(qf, kv, o, lse, do, b, rep, axis, causal, scale,
                            stats)
        return (_unfold(dq.to(qf.dtype), b), _unfold(acc[0].to(kdtype), b),
                _unfold(acc[1].to(kdtype), b), None, None, None, None)


def ring_attention_fwd(query, key, value, causal=True, scale=None,
                       mesh=None, axis_name=None, stats=None):
    """The ring's forward without autograd (what ``ring_attention``
    runs): (o [B, S_loc, H, D], lse [B*H, S_loc] f32) of this rank's
    block."""
    _check_qkv("ring_attention_fwd", query, key, value)
    axis = _sep_axis(mesh, axis_name)
    _, o, lse, _ = _ring_fwd(query, key, value, axis, bool(causal),
                             _scale(query, scale), stats)
    return _unfold(o, query.shape[0]), lse


def ring_attention_bwd(query, key, value, out, lse, dout, causal=True,
                       scale=None, mesh=None, axis_name=None, stats=None):
    """The ring's backward without autograd (what ``ring_attention``'s
    backward runs): (dq, dk, dv) of this rank's block from its q, k, v,
    the forward's o and lse and the upstream gradient, each in its
    input's dtype."""
    _check_qkv("ring_attention_bwd", query, key, value)
    axis = _sep_axis(mesh, axis_name)
    b = query.shape[0]
    kv = torch.stack([_fold(key), _fold(value)])
    dq, acc = _ring_bwd(_fold(query), kv, _fold(out), lse, dout, b,
                        query.shape[2] // key.shape[2], axis, bool(causal),
                        _scale(query, scale), stats)
    return (_unfold(dq.to(query.dtype), b), _unfold(acc[0].to(key.dtype), b),
            _unfold(acc[1].to(key.dtype), b))


def _scale(query, scale):
    return float(1.0 / math.sqrt(query.shape[-1]) if scale is None
                 else scale)


def _check_qkv(name, q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[1] != k.shape[1] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} must be [B, S_loc, H, D], [B, S_loc, KVH, D] "
            "with KVH dividing H")


def ring_attention(query, key, value, causal=True, scale=None, mesh=None,
                   axis_name=None, stats=None):
    """Ring attention over the context-parallel axis. Inputs are this
    rank's contiguous block of the sequence, [batch, seqlen_local,
    num_heads, head_dim] (k / v at their own kv heads); returns this
    rank's block of the attention output. GQA supported. ``stats``: the
    caller's collective tally."""
    _check_qkv("ring_attention", query, key, value)
    axis = _sep_axis(mesh, axis_name)
    return _Ring.apply(query, key, value, axis, bool(causal),
                       _scale(query, scale), stats)


def ring_attention_plain(query, key, value, ring, causal=True, scale=None):
    """The ring's plain version: the JAX package's fold
    (``_ring_attention_local``) in torch on the WHOLE sequence, for each of
    ``ring`` ranks' contiguous blocks in turn. [B, S, H, D] with S a
    multiple of ``ring``; f32 logits, running max, sum and accumulator,
    blocks folded in the ring's order (the diagonal first), masked
    logits -1e30. Differentiable by autograd; returns o in query's
    dtype."""
    b, s, h, d = query.shape
    kvh = key.shape[2]
    rep = h // kvh
    if s % ring:
        raise ValueError(f"ring_attention_plain: S={s} is not a multiple "
                         f"of the ring ({ring})")
    n = s // ring
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = query.device
    outs = []
    for idx in range(ring):
        qt = query[:, idx * n:(idx + 1) * n].transpose(1, 2).float() \
            .reshape(b, kvh, rep, n, d)
        q_pos = idx * n + torch.arange(n, device=dev)
        m = torch.full((b, kvh, rep, n), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, rep, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, rep, n, d), dtype=torch.float32,
                          device=dev)
        for t in range(ring):
            src = (idx - t) % ring
            kc = key[:, src * n:(src + 1) * n].transpose(1, 2).float()
            vc = value[:, src * n:(src + 1) * n].transpose(1, 2).float()
            logits = torch.einsum("bgrsd,bgtd->bgrst", qt, kc) * sc
            if causal:
                k_pos = src * n + torch.arange(n, device=dev)
                keep = q_pos[:, None] >= k_pos[None, :]
                logits = torch.where(keep, logits, _NEG)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            probs = torch.exp(logits - m_new[..., None])
            if causal:
                probs = torch.where(keep, probs, 0.0)
            l = l * alpha + probs.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrst,bgtd->bgrsd", probs, vc)
            m = m_new
        outs.append((acc / l[..., None]).reshape(b, h, n, d).transpose(1, 2))
    return torch.cat(outs, 1).to(query.dtype)


class _SeqToHeads(torch.autograd.Function):
    """[B, S_loc, X, D] -> [B, p * S_loc, X / p, D]: rank j gets heads
    [j X/p, (j + 1) X/p) of every rank's block, in rank order. Backward:
    the inverse exchange."""

    @staticmethod
    def forward(ctx, x, axis, stats):
        ctx.args = (axis, stats)
        return _seq_to_heads(x, axis, stats)

    @staticmethod
    def backward(ctx, g):
        axis, stats = ctx.args
        return _heads_to_seq(g, axis, stats), None, None


class _HeadsToSeq(torch.autograd.Function):
    """The inverse of ``_SeqToHeads``."""

    @staticmethod
    def forward(ctx, x, axis, stats):
        ctx.args = (axis, stats)
        return _heads_to_seq(x, axis, stats)

    @staticmethod
    def backward(ctx, g):
        axis, stats = ctx.args
        return _seq_to_heads(g, axis, stats), None, None


def _exchange(parts, axis, stats):
    out = torch.empty_like(parts)
    collective.all_to_all_single(out, parts, group=axis.group,
                                 axis=axis.label, stats=stats)
    return out


def _seq_to_heads(x, axis, stats):
    b, s, hx, d = x.shape
    p = axis.size
    parts = x.reshape(b, s, p, hx // p, d).permute(2, 0, 1, 3, 4) \
        .contiguous()
    out = _exchange(parts, axis, stats)          # [p (source), B, S, X/p, D]
    return out.permute(1, 0, 2, 3, 4).reshape(b, p * s, hx // p, d)


def _heads_to_seq(x, axis, stats):
    b, s, hc, d = x.shape
    p = axis.size
    parts = x.reshape(b, p, s // p, hc, d).permute(1, 0, 2, 3, 4) \
        .contiguous()
    out = _exchange(parts, axis, stats)          # [p (head chunk), B, S/p, ..]
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // p, p * hc, d)


def ulysses_attention(query, key, value, causal=True, scale=None, mesh=None,
                      axis_name=None, stats=None):
    """Ulysses sequence parallelism: all_to_all head<->sequence exchange,
    then attention over the whole sequence for H/p heads (the flash
    kernels), then the exchange back. num_heads must be divisible by the
    axis size; K/V heads are repeated to num_heads first when the axis
    size does not divide them."""
    _check_qkv("ulysses_attention", query, key, value)
    axis = _sep_axis(mesh, axis_name)
    p = axis.size
    if query.shape[2] % p != 0:
        raise ValueError(
            f"ulysses_attention needs num_heads ({query.shape[2]}) divisible "
            f"by the context-parallel degree ({p}); use ring_attention for "
            "head counts smaller than the ring")
    if p == 1:
        return _fa.flash_attention_bshd(query, key, value, causal=causal,
                                        scale=scale)
    if key.shape[2] % p != 0:
        rep = query.shape[2] // key.shape[2]
        key = torch.repeat_interleave(key, rep, dim=2)
        value = torch.repeat_interleave(value, rep, dim=2)
    q, k, v = (_SeqToHeads.apply(t, axis, stats)
               for t in (query, key, value))
    out = _fa.flash_attention_bshd(q, k, v, causal=causal, scale=scale)
    return _HeadsToSeq.apply(out, axis, stats)


# ---------------------------------------------------------------------------
# SegmentParallel wrapper + helpers
# ---------------------------------------------------------------------------
def split_sequence(x, seq_axis=1, mesh=None, axis_name=None):
    """This rank's contiguous block of a tensor's sequence dim (the entry
    point into a context-parallel region): block ``index`` of ``size``
    equal blocks of the axis."""
    axis = _sep_axis(mesh, axis_name)
    n = x.shape[seq_axis]
    if n % axis.size:
        raise ValueError(f"split_sequence: length {n} is not a multiple of "
                         f"the context-parallel degree ({axis.size})")
    k = n // axis.size
    return x.narrow(seq_axis, axis.index * k, k)


class SegmentParallel(torch.nn.Module):
    """Reference meta_parallel/segment_parallel.py:26: wraps a model whose
    attention is context-parallel. Each shardable input (a tensor with a
    sequence dim above 1 that the sep degree divides; masks, labels and
    scalars pass as they are, as the JAX wrapper decides) is cut to this
    rank's block. What the JAX package's single controller needs no code
    for, the wrapper does as the reference's does: on the first forward
    it broadcasts rank 0's parameters over the sep group and, from then
    on, averages the gradients over it during each backward
    (``fleet.reducer.EagerReducer``). The average is the gradient of the
    mean loss over the whole sequence when each rank's loss is a mean
    over an equal block."""

    def __init__(self, layers, hcg=None, strategy=None, seq_axis=1):
        super().__init__()
        self._layers = layers
        self._seq_axis = seq_axis
        self._hcg = hcg
        # the mesh is looked up at the first forward: the reference allows
        # wrapping before fleet.init, and an explicit hcg= takes priority
        self._axis_cache = None
        self._reducer = None

    @property
    def _axis(self):
        if self._axis_cache is None:
            self._axis_cache = _sep_axis(hcg=self._hcg)
            group = self._axis_cache.group
            if group is not None and group.size() > 1:
                from ..parallel import _sync_params_buffers
                from .reducer import EagerReducer
                _sync_params_buffers(self._layers, group)
                self._reducer = EagerReducer(self._layers.parameters(),
                                             group)
        return self._axis_cache

    @property
    def _degree(self):
        return self._axis.size

    def _shardable(self, x):
        return (isinstance(x, torch.Tensor) and x.dim() > self._seq_axis
                and x.shape[self._seq_axis] > 1
                and x.shape[self._seq_axis] % self._degree == 0)

    def forward(self, *inputs, **kwargs):
        axis = self._axis
        k = self._seq_axis
        inputs = tuple(
            x.narrow(k, axis.index * (x.shape[k] // axis.size),
                     x.shape[k] // axis.size) if self._shardable(x) else x
            for x in inputs)
        return self._layers(*inputs, **kwargs)
