"""Pipeline-parallel schedules of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/pipeline_schedule.py``; reference
fleet/meta_parallel/pipeline_parallel.py:684 (1F1B), :1308 (interleaved
VPP), passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62 (ZB-H1)).

The JAX package compiles each schedule into one program: a ``lax.scan``
over ticks whose activations move between stages with ``ppermute``. The
port drives the schedule from the host, as Paddle's reference does: a
rank holds its stage's layers (with VPP, its ``V`` chunks: chunk ``c``
of rank ``d`` is global stage ``g = c * S + d``) and runs, in its
schedule's order, the forward ``F`` and the backward ``B`` of each
micro-batch (ZB-H1 also ``W``, the deferred weight gradients), each
stage's forward and backward an eager autograd pass. Activations and
their gradients travel between neighbouring stages with the port's
point-to-point collectives on the mesh's pp group
(``collective.batch_isend_irecv``): a send is started and left to
finish while the rank computes on (its works are waited for at the end
of the run), a receive is waited for before the op that reads it, and
every wait raises within the group's timeout. The steady state of 1F1B
pairs "send the forward output / receive the backward gradient" (and
"send the input gradient / receive the next forward input") in one
``batch_isend_irecv``, as the reference's ``p2p_communication`` does.
On a gloo group a CUDA tensor goes through pinned host memory
(``collective.GLOO_STAGED``).

A stage's output (a tensor, or a tuple of tensors of one dtype: the
Llama decoder's (hidden, residual) pair) crosses to the next stage as
one packed buffer; its shapes and dtype go once ahead of it (a small
int64 "meta" message, as the reference's ``SendRecvMeta``), and a runner
reuses them while the micro-batches keep their shape (``meta_key``).

``schedule_ops(kind, S, M, stage, V)`` is each rank's order of ops;
every order is one the reference runs and none can deadlock
(``check_orders`` executes all ranks' orders against their dependencies:
a forward needs the previous stage's forward of that micro-batch, a
backward the next stage's backward). A stashed stage input and its
output live from the op's F to its B (ZB-H1: its W); the largest number
of them alive at once on a rank is the schedule's memory bound
(``in_flight_bound``), which every runner reports as ``max_in_flight``:

- 1F1B: min(S - i, M) on stage i (Paddle's warm-up of S - i - 1
  forwards, then one forward and one backward at a time);
- FThenB (GPipe): M, every forward before the first backward;
- VPP: min(2 (S - i - 1) + (V - 1) S + 1, M V) micro-batch chunks on
  rank i (Megatron's interleaved order, micro-batches in groups of S
  through the V chunks); M must be a multiple of S;
- ZB-H1: min(S, M): 1F1B's order of F and B with stage i's W deferred
  by i micro-batches (its warm-up one forward longer), so that the last
  stages fill their drain with weight gradients.

The JAX 1F1B re-runs each stage's forward in its backward, the price of
its memory bound in one XLA program; the port stashes the activations
instead: the same numbers, one forward a micro-batch.

``pipeline_gpipe`` / ``pipeline_1f1b`` / ``pipeline_interleaved`` /
``pipeline_zero_bubble`` keep the JAX names: ``runner = pipeline_1f1b(
stage_fn, mesh)`` and ``runner(params, micro, loss_fn)`` runs forward
and backward on this rank (``stage_fn(params, x)`` a stage's function of
this rank's parameters; ``loss_fn(y, m)`` the last stage's scalar of
micro-batch m's output, default its sum), the gradients landing on the
parameters' ``.grad``; the result holds the last stage's outputs and
losses, the first stage's input gradients and ``max_in_flight``.
``stack_stage_params`` stacks per-stage parameter dicts, as JAX's does.
"""
import collections
import contextlib
import math

import torch

from .. import collective

__all__ = ["SCHEDULES", "schedule_ops", "in_flight_bound", "check_orders",
           "PipelineResult", "PipelineEngine", "pipeline_gpipe",
           "pipeline_1f1b", "pipeline_interleaved", "pipeline_zero_bubble",
           "stack_stage_params"]

SCHEDULES = ("1F1B", "FThenB", "VPP", "ZBH1")

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_META_LEN = 32        # int64 words of a meta message


# -- the orders ---------------------------------------------------------------

def _vpp_pos(k, S, V, backward):
    """(micro-batch, chunk) of the k-th forward (or backward) of a rank
    in the interleaved order."""
    c = (k // S) % V
    if backward:
        c = V - 1 - c
    return (k // (S * V)) * S + k % S, c


def schedule_ops(kind, S, M, stage, V=1):
    """Stage `stage`'s ops in order, each ("F" | "B" | "W", micro-batch,
    chunk), of schedule `kind` over S stages (V chunks a rank for VPP)
    and M micro-batches."""
    if kind not in SCHEDULES:
        raise ValueError(f"schedule_mode must be one of {SCHEDULES}, got "
                         f"{kind!r}")
    ops = []
    if kind == "FThenB":
        ops += [("F", m, 0) for m in range(M)]
        ops += [("B", m, 0) for m in range(M)]
    elif kind == "1F1B":
        warm = min(S - stage - 1, M)
        ops += [("F", m, 0) for m in range(warm)]
        for j in range(M - warm):
            ops += [("F", warm + j, 0), ("B", j, 0)]
        ops += [("B", m, 0) for m in range(M - warm, M)]
    elif kind == "VPP":
        if V < 2:
            raise ValueError("VPP schedule needs vpp_degree >= 2")
        if M % S:
            raise ValueError(f"VPP: accumulate_steps={M} must be a multiple "
                             f"of pp={S} (micro-batches run in groups of "
                             "the pipeline's depth)")
        total = M * V
        warm = min(2 * (S - stage - 1) + (V - 1) * S, total)
        ops += [("F",) + _vpp_pos(k, S, V, False) for k in range(warm)]
        for j in range(total - warm):
            ops += [("F",) + _vpp_pos(warm + j, S, V, False),
                    ("B",) + _vpp_pos(j, S, V, True)]
        ops += [("B",) + _vpp_pos(k, S, V, True)
                for k in range(total - warm, total)]
    else:                                   # ZBH1
        warm = min(S - stage, M)
        ops += [("F", m, 0) for m in range(warm)]
        pending = collections.deque()
        nxt = warm
        for j in range(M):
            ops.append(("B", j, 0))
            pending.append(j)
            if len(pending) > stage:
                ops.append(("W", pending.popleft(), 0))
            if nxt < M:
                ops.append(("F", nxt, 0))
                nxt += 1
        ops += [("W", m, 0) for m in pending]
    return ops


def in_flight_bound(kind, S, M, stage, V=1):
    """The schedule's memory bound on `stage`: the most micro-batches (VPP:
    micro-batch chunks) whose stage input is stashed at once."""
    if kind == "FThenB":
        return M
    if kind == "1F1B":
        return min(S - stage, M)
    if kind == "VPP":
        return min(2 * (S - stage - 1) + (V - 1) * S + 1, M * V)
    if kind == "ZBH1":
        return min(S, M)
    raise ValueError(f"schedule_mode must be one of {SCHEDULES}, got "
                     f"{kind!r}")


def _max_alive(ops):
    last = "W" if any(op[0] == "W" for op in ops) else "B"
    alive = peak = 0
    for op in ops:
        if op[0] == "F":
            alive += 1
            peak = max(peak, alive)
        elif op[0] == last:
            alive -= 1
    return peak


def check_orders(kind, S, M, V=1):
    """Run every stage's order against the ops' dependencies (a forward
    after the previous global stage's forward of its micro-batch, a
    backward after the next one's backward; sends never block) and
    raise ``RuntimeError`` if the ranks would wait on each other for
    ever. Returns the orders."""
    orders = [schedule_ops(kind, S, M, d, V) for d in range(S)]
    G = S * V
    done = set()
    pos = [0] * S
    progress = True
    while progress:
        progress = False
        for d in range(S):
            while pos[d] < len(orders[d]):
                kind_, m, c = orders[d][pos[d]]
                g = c * S + d
                if kind_ == "F" and g > 0 and ("F", m, g - 1) not in done:
                    break
                if kind_ == "B" and (("F", m, g) not in done or (
                        g < G - 1 and ("B", m, g + 1) not in done)):
                    break
                done.add((kind_, m, g))
                pos[d] += 1
                progress = True
    stuck = [d for d in range(S) if pos[d] < len(orders[d])]
    if stuck:
        raise RuntimeError(f"{kind}: stages {stuck} wait for ever "
                           f"(S={S}, M={M}, V={V})")
    return orders


# -- the carry on the wire ------------------------------------------------------

def _parts(carry):
    return tuple(carry) if isinstance(carry, (tuple, list)) else (carry,)


def _pack(carry):
    """(one flat contiguous buffer, meta) of a carry of one dtype."""
    parts = _parts(carry)
    dtype = parts[0].dtype
    if any(p.dtype != dtype for p in parts):
        raise NotImplementedError(
            "pipeline: a stage's output crosses as one buffer of one dtype; "
            f"got {[p.dtype for p in parts]}")
    flat = torch.cat([p.detach().reshape(-1) for p in parts]) \
        if len(parts) > 1 else parts[0].detach().reshape(-1).contiguous()
    meta = (dtype, isinstance(carry, (tuple, list)),
            tuple(tuple(p.shape) for p in parts))
    return flat, meta


def _meta_tensor(meta):
    dtype, is_tuple, shapes = meta
    words = [_DTYPES.index(dtype), int(is_tuple), len(shapes)]
    for shp in shapes:
        words += [len(shp), *shp]
    if len(words) > _META_LEN:
        raise NotImplementedError("pipeline: a stage's output has too many "
                                  "parts or dims to describe")
    return torch.tensor(words + [0] * (_META_LEN - len(words)),
                        dtype=torch.int64)


def _meta_from(t):
    w = t.tolist()
    dtype, is_tuple, n = _DTYPES[w[0]], bool(w[1]), w[2]
    shapes, i = [], 3
    for _ in range(n):
        k = w[i]
        shapes.append(tuple(w[i + 1:i + 1 + k]))
        i += 1 + k
    return dtype, is_tuple, tuple(shapes)


def _numel(meta):
    return sum(math.prod(shp) for shp in meta[2])


def _unpack(flat, meta):
    _, is_tuple, shapes = meta
    out, off = [], 0
    for shp in shapes:
        k = math.prod(shp)
        out.append(flat[off:off + k].view(shp))
        off += k
    return tuple(out) if is_tuple else out[0]


# -- the engine -----------------------------------------------------------------

def _tag(g, what):
    """The message tag of what global stage g receives: its forward input
    (0), its output's gradient (1), the meta of its input (2). Between
    two ranks the messages of one tag go in micro-batch order on both
    sides."""
    return 3 * g + {"x": 0, "dy": 1, "meta": 2}[what]


class PipelineResult:
    """What a run leaves on this rank: ``outputs`` {micro-batch: the last
    global stage's output, detached} and ``losses`` {micro-batch: its
    loss, detached} (on the rank holding the last stage), ``input_grads``
    {micro-batch: the gradient of the first stage's input} (where that
    input needed one), ``max_in_flight`` and the ``ops`` run."""

    def __init__(self, ops):
        self.outputs, self.losses, self.input_grads = {}, {}, {}
        self.max_in_flight = 0
        self.ops = ops


class PipelineEngine:
    """One rank's executor of a schedule over the pp ``group`` (this rank
    is stage ``stage`` of ``S``, with ``V`` chunks). ``stats`` receives
    the runs' sends and receives by "op,pp" (the collectives' tally),
    ``meta_stats`` the meta messages'. The meta of each boundary is
    kept per ``meta_key`` across runs of one engine."""

    def __init__(self, kind, S, stage, group, V=1, stats=None,
                 meta_stats=None):
        if kind not in SCHEDULES:
            raise ValueError(f"schedule_mode must be one of {SCHEDULES}, "
                             f"got {kind!r}")
        self.kind, self.S, self.stage, self.V = kind, S, stage, V
        self.group = group
        self.stats = {} if stats is None else stats
        self.meta_stats = {} if meta_stats is None else meta_stats
        self._sent_meta, self._got_meta = set(), {}
        self._pending = []

    def _rank(self, g):
        return g % self.S

    # -- point to point -------------------------------------------------
    def _exchange(self, sends, recvs):
        """Start `sends` and `recvs` ([(tensor, peer, tag)]) together in
        one ``batch_isend_irecv``; wait for the receives and keep the
        sends' works for later (each waited for once it completes, the
        rest at the end of the run)."""
        ops = [collective.P2POp(collective.isend, t, p, self.group, tag)
               for t, p, tag in sends]
        ops += [collective.P2POp(collective.irecv, t, p, self.group, tag)
                for t, p, tag in recvs]
        works = collective.batch_isend_irecv(ops, axis="pp",
                                             stats=self.stats)
        self._pending += [(w, t) for w, (t, _, _) in zip(works, sends)]
        for w in works[len(sends):]:
            w.wait()
        keep = []
        for w, t in self._pending:
            if w.is_completed():
                w.wait()
            else:
                keep.append((w, t))
        self._pending = keep

    def _send_meta(self, g, key, meta):
        """The meta of global stage g's input, once per `key`."""
        if (g, key) in self._sent_meta:
            return
        self._sent_meta.add((g, key))
        t = _meta_tensor(meta)
        self._pending.append((collective.isend(
            t, self._rank(g), self.group, axis="pp", stats=self.meta_stats,
            tag=_tag(g, "meta")), t))

    def _recv_meta(self, g, key):
        meta = self._got_meta.get((g, key))
        if meta is None:
            t = torch.empty(_META_LEN, dtype=torch.int64)
            collective.recv(t, self._rank(g - 1), self.group, axis="pp",
                            stats=self.meta_stats, tag=_tag(g, "meta"))
            meta = self._got_meta[(g, key)] = _meta_from(t)
        return meta

    # -- the run ----------------------------------------------------------
    def run(self, M, chunk_fn, first_input, last_loss=None, device=None,
            backward=True, meta_key=None, wgrad_store=None):
        """Run this rank's ops of the schedule over M micro-batches.

        ``chunk_fn(c, x)``: chunk c's forward (the whole stage without
        VPP) of carry x. ``first_input(m)``: micro-batch m's input of
        global stage 0. ``last_loss(m, y)``: on the last global stage,
        the loss that micro-batch m's backward runs from (None: the
        output's sum). ``device``: where received activations land.
        ``backward`` False runs the forwards alone. ``wgrad_store``
        (ZB-H1): a ``WeightGradStore``; the run is inside
        ``split_weight_grad(wgrad_store)``, each B leaves its weight
        gradients there and W runs them. Returns a ``PipelineResult``."""
        S, V, stage = self.S, self.V, self.stage
        self._G, self._key, self._dev = S * V, meta_key, device
        self._backward = backward
        if backward:
            ops = schedule_ops(self.kind, S, M, stage, V)
        elif self.kind == "VPP":
            ops = [("F",) + _vpp_pos(k, S, V, False) for k in range(M * V)]
        else:
            ops = [("F", m, 0) for m in range(M)]
        res = PipelineResult(ops)
        self._held, self._dys, self._outmeta = {}, {}, {}
        split = contextlib.nullcontext()
        if wgrad_store is not None:
            from .pipeline_parallel import split_weight_grad
            split = split_weight_grad(wgrad_store)
        stash, wjobs, alive = {}, {}, 0
        try:
            with split:
                for i, (kind, m, c) in enumerate(ops):
                    nxt = ops[i + 1] if i + 1 < len(ops) else None
                    g = c * S + stage
                    if kind == "F":
                        top, x, leaf = self._forward(
                            g, m, c, chunk_fn, first_input, last_loss,
                            res, nxt)
                        if backward:
                            stash[(m, c)] = (x, leaf, top)
                            alive += 1
                            res.max_in_flight = max(res.max_in_flight,
                                                    alive)
                    elif kind == "B":
                        x, leaf, top = stash.pop((m, c))
                        n0 = len(wgrad_store._q) if wgrad_store else 0
                        self._backward_op(g, m, c, top)
                        if wgrad_store is not None:
                            wjobs[(m, c)] = wgrad_store._q[n0:]
                            del wgrad_store._q[n0:]
                        else:
                            alive -= 1
                        self._input_grad(g, m, c, x, leaf, res, nxt)
                    else:                               # W
                        for fn in wjobs.pop((m, c)):
                            fn()
                        alive -= 1
            for w, _ in self._pending:
                w.wait()
        finally:
            self._pending = []
            self._held = self._dys = self._outmeta = None
        return res

    def _forward(self, g, m, c, chunk_fn, first_input, last_loss, res,
                 nxt):
        """F(m, c): (what its B runs backward from, its input, the
        received buffer or None)."""
        if g == 0:
            x, leaf = first_input(m), None
        else:
            held = self._held.pop((m, c), None)
            if held is None:
                meta = self._recv_meta(g, self._key)
                held = (torch.empty(_numel(meta), dtype=meta[0],
                                    device=self._dev), meta)
                self._exchange([], [(held[0], self._rank(g - 1),
                                     _tag(g, "x"))])
            leaf, meta = held
            if self._backward and leaf.is_floating_point():
                leaf.requires_grad_(True)
            x = _unpack(leaf, meta)
        with torch.set_grad_enabled(self._backward):
            y = chunk_fn(c, x)
            if g == self._G - 1:
                loss = (last_loss(m, y) if last_loss is not None
                        else sum(t.sum() for t in _parts(y)))
        if g == self._G - 1:
            res.outputs[m] = _detach(y)
            res.losses[m] = loss.detach()
            return loss, x, leaf
        flat, meta = _pack(y)
        self._send_meta(g + 1, self._key, meta)
        recvs = []
        if self._backward:
            self._outmeta[(m, c)] = meta
            # 1F1B's steady state: the output goes out with the receive
            # of the gradient the next op (a backward) needs
            if nxt is not None and nxt[0] == "B":
                gb = nxt[2] * self.S + self.stage
                if gb < self._G - 1 and (nxt[1], nxt[2]) in self._outmeta:
                    dy = self._empty(self._outmeta[(nxt[1], nxt[2])])
                    recvs = [(dy, self._rank(gb + 1), _tag(gb, "dy"))]
                    self._dys[(nxt[1], nxt[2])] = dy
        self._exchange([(flat, self._rank(g + 1), _tag(g + 1, "x"))],
                       recvs)
        return y, x, leaf

    def _empty(self, meta):
        return torch.empty(_numel(meta), dtype=meta[0], device=self._dev)

    def _backward_op(self, g, m, c, top):
        if g == self._G - 1:
            top.backward()
            return
        dy = self._dys.pop((m, c), None)
        meta = self._outmeta.pop((m, c))
        if dy is None:
            dy = self._empty(meta)
            self._exchange([], [(dy, self._rank(g + 1), _tag(g, "dy"))])
        _backward(top, _unpack(dy, meta))

    def _input_grad(self, g, m, c, x, leaf, res, nxt):
        """B(m, c)'s input gradient: kept on the first global stage, else
        sent back, with the receive of the next forward's input where one
        follows and its meta is known."""
        if g == 0:
            grads = _input_grads(x)
            if grads is not None:
                res.input_grads[m] = grads
            return
        dx = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        leaf.grad = None
        recvs = []
        if nxt is not None and nxt[0] == "F":
            gf = nxt[2] * self.S + self.stage
            meta = self._got_meta.get((gf, self._key))
            if gf > 0 and meta is not None \
                    and (nxt[1], nxt[2]) not in self._held:
                buf = self._empty(meta)
                recvs = [(buf, self._rank(gf - 1), _tag(gf, "x"))]
                self._held[(nxt[1], nxt[2])] = (buf, meta)
        self._exchange([(dx.detach(), self._rank(g - 1), _tag(g - 1, "dy"))],
                       recvs)


def _detach(y):
    if isinstance(y, (tuple, list)):
        return type(y)(t.detach() for t in y)
    return y.detach()


def _backward(y, dy):
    ys, dys = [], []
    for t, g in zip(_parts(y), _parts(dy)):
        if t.requires_grad:
            ys.append(t)
            dys.append(g)
    if ys:
        torch.autograd.backward(ys, dys)


def _input_grads(x):
    parts = [t for t in _parts(x) if isinstance(t, torch.Tensor)
             and t.requires_grad and t.is_leaf]
    if not parts:
        return None
    grads = [None if t.grad is None else t.grad.detach() for t in parts]
    return grads[0] if len(grads) == 1 else tuple(grads)


# -- the JAX names ----------------------------------------------------------------

def _pipe_axis(mesh, axis="pp"):
    """(pp group, stages, this rank's stage) of a port ``Mesh`` (or a
    ``ProcessMesh`` viewing one); ``axis`` "pp" or Paddle's "pipe"."""
    m = getattr(mesh, "mesh", None) or mesh
    if axis not in ("pp", "pipe"):
        raise ValueError(f"the pipeline axis is 'pp' (or 'pipe'), got "
                         f"{axis!r}")
    return m.groups["pp"], m.shape["pp"], m.coords["pp"]


def _runner(kind, stage_fn, mesh, axis, v_chunks=1):
    group, S, stage = _pipe_axis(mesh, axis)

    def run(params, micro, loss_fn=None, backward=True):
        """Forward and backward of micro-batches `micro` ([M, ...] or a
        list; read on the first stage) through this rank's stage of
        `params` (VPP: a list of its chunks' parameters, chunk c global
        stage c * S + stage); the last stage's ``loss_fn(y, m)`` (default
        the output's sum) starts each backward. Parameters' gradients
        accumulate on their ``.grad``; returns the ``PipelineResult``."""
        eng = PipelineEngine(kind, S, stage, group, V=v_chunks)
        dev = micro[0].device
        store = None
        if kind == "ZBH1":
            from .pipeline_parallel import WeightGradStore
            store = WeightGradStore()

        def chunk(c, x):
            return stage_fn(params[c] if v_chunks > 1 else params, x)

        def first(m):
            t = micro[m].detach()
            return t.requires_grad_(True) if micro[m].requires_grad else t
        last = None if loss_fn is None else (lambda m, y: loss_fn(y, m))
        return eng.run(len(micro), chunk, first, last, device=dev,
                       backward=backward, wgrad_store=store)
    return run


def pipeline_gpipe(stage_fn, mesh, axis="pp"):
    """FThenB (GPipe): every forward, then every backward."""
    return _runner("FThenB", stage_fn, mesh, axis)


def pipeline_1f1b(stage_fn, mesh, axis="pp"):
    """1F1B: S - i - 1 warm-up forwards on stage i, then one forward and
    one backward at a time."""
    return _runner("1F1B", stage_fn, mesh, axis)


def pipeline_interleaved(stage_fn, mesh, v_chunks, axis="pp"):
    """Interleaved VPP over `v_chunks` chunks a rank (chunk c of rank d
    is global stage c * S + d)."""
    if v_chunks < 2:
        raise ValueError("VPP schedule needs vpp_degree >= 2")
    return _runner("VPP", stage_fn, mesh, axis, v_chunks)


def pipeline_zero_bubble(stage_fn, mesh, axis="pp"):
    """ZB-H1: 1F1B whose backward runs the input gradients (B) at once
    and each linear's weight gradient (W, ``split_weight_grad``) up to
    i micro-batches later on stage i."""
    return _runner("ZBH1", stage_fn, mesh, axis)


def stack_stage_params(per_stage_params):
    """A list of per-stage parameter dicts (same keys and shapes) ->
    {key: stacked tensor with a leading stage axis}."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}
