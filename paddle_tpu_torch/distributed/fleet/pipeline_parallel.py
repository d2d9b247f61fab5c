"""Pipeline parallelism of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/pipeline_parallel.py``; reference
fleet/meta_parallel/pp_layers.py:258 ``PipelineLayer`` / ``LayerDesc``,
pipeline_parallel.py:684 1F1B, :1308 VPP, passes/pipeline_scheduler_pass/
pipeline_zero_bubble.py ZB-H1).

A model is a flat list of layers or ``LayerDesc``s (``PipelineLayer``).
One rank of the pp axis holds one stage: ``PipelineLayer`` builds only
the descs of this rank's stage (with VPP its chunks), so that no rank
holds the whole model. The partition is the JAX package's
``CompiledPipelineTrainer``'s: the elements are [pre..., N homogeneous
blocks, ...post] (blocks of one class and arguments, contiguous: else
``ValueError`` "contiguous"), the blocks split evenly over pp x vpp
global stages (else "do not divide into pp=..."), chunk c of rank d is
global stage g = c * S + d, and the pre elements (the embedding) go on
the first global stage and the post elements (norm, head) on the last.
The JAX package runs pre and post replicated outside its ring; Paddle's
reference places them on the first and last stage, as the port does.

``PipelineParallel.train_batch(data, optimizer, lr_scheduler=None,
scaler=None)`` on a pp axis (``fleet.init`` with pp_degree > 1, a
``PipelineLayer`` of more than one stage): ``data`` = (ids, labels) of
this rank's rows (its share over dp, as ``pretrain.shard_batch`` cuts
it), split into ``accumulate_steps`` micro-batches (a batch they do not
divide raises, with the JAX message), run through the schedule of
``pp_configs["schedule_mode"]`` ("1F1B" by default, "FThenB", "VPP"
with ``vpp_degree`` >= 2, "ZBH1"; ``pipeline_schedule``) over the mesh's
pp group. The last stage divides each micro-batch's loss by the global
count of the labels kept (counted over its micro-batches and summed over
dp once, up front; a loss function without a ``denominator`` divides by
the number of micro-batches over dp), so that the step's loss is JAX's
one ``loss_fn`` over the whole output. The gradients are summed over dp
in float32 (one flat all_reduce) and, where mp > 1, computed as the mesh
step computes them: the stage's parameters hold their mp shards under
the model's ``_shard_rules`` (``sharded.plan_params``) and the stage
runs inside ``sharded.bound`` (Megatron operators, the vocab-parallel
head with kernel C's sharded form). Then the wrapped optimizer steps:
its global-norm clip is ``HybridParallelClipGrad`` over mp and pp (every
parameter lives on exactly one stage; on the card the clip's sum of
squares is all_reduced between kernel D's two launches). The loss, the
same on every rank, is all_reduced over pp from the last stage. Every
optimizer (SGD / Adam / AdamW, which the JAX package compiles, and the
rest, which it sends to its eager loop) runs through this one path. With
``scaler=`` the same schedule runs on the scaled loss and the found-inf
flag is all_reduced (MAX) over pp (and mp), so that every stage skips a
step together; the JAX package drops to its whole-model eager loop
there. fsdp > 1 or sp > 1 together with pp > 1 raise
``NotImplementedError`` (ROADMAP Queue 1 item 9).

Without a pp axis (pp = 1, or a ``PipelineLayer`` of one stage)
``train_batch`` is the JAX package's eager micro-batch loop (the whole
model on the rank, each micro-batch's loss scaled by its share of the
batch). ``eval_batch`` and ``forward`` run the forwards through the
stages; ``state_dict`` holds this rank's stage under the JAX names.

``ZeroBubblePipelineParallel`` runs ZB-H1 (on the pp axis) or the eager
loop with the weight-gradient split (without one): inside
``split_weight_grad(store)`` the port's ``linear`` computes its input's
gradient in the backward and queues its weight's (a ``WeightGradStore``
job), which runs later; a derived (non-leaf) weight keeps the joint
path, and so does a linear whose input needs no gradient.
"""
import collections
import contextlib
import inspect
import threading

import numpy as np
import torch

from .. import collective
from ...nn.clip import ClipGradByGlobalNorm
from ...nn.functional import common as _common
from . import sharded
from .hybrid_optimizer import HybridParallelClipGrad
from .pipeline_schedule import SCHEDULES, PipelineEngine
from .topology import get_hcg

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "ZeroBubblePipelineParallel",
           "WeightGradStore", "split_weight_grad", "pipeline_comm"]


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:57): a rank
    builds the descs of its own stage only."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, *args, forward_func=None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func


def _arg_key(a):
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    return ("id", id(a))


def _signature(e):
    """What makes two elements the same block: a desc's class and
    positional arguments, a built layer's class and parameter shapes."""
    if isinstance(e, LayerDesc):
        return (e.layer_cls.__name__,
                tuple(_arg_key(a) for a in e.args))
    return (type(e).__name__,
            tuple((n, tuple(p.shape)) for n, p in
                  sorted(e.named_parameters())))


def partition(elements, S, V=1):
    """The global stages' element indices: [pre | N blocks | post] with
    the blocks split evenly over S * V stages, pre on the first, post on
    the last (the JAX ``CompiledPipelineTrainer``'s partition and
    errors)."""
    G = S * V
    if G == 1:
        return [list(range(len(elements)))]
    sigs = [_signature(e) for e in elements]
    block, _ = collections.Counter(sigs).most_common(1)[0]
    first = sigs.index(block)
    last = len(sigs) - 1 - sigs[::-1].index(block)
    if sigs[first:last + 1] != [block] * (last - first + 1):
        raise ValueError(
            "pipeline blocks must be contiguous and homogeneous (same class "
            f"+ parameter shapes); got a gap in {[s[0] for s in sigs]}")
    n = last - first + 1
    if n % G:
        raise ValueError(f"{n} pipeline blocks do not divide into pp={S} x "
                         f"vpp={V} stages")
    per = n // G
    out = []
    for g in range(G):
        lo = 0 if g == 0 else first + g * per
        hi = len(elements) if g == G - 1 else first + (g + 1) * per
        out.append(list(range(lo, hi)))
    return out


def _pp_configs(strategy):
    if strategy is None:
        return {}
    cfg = strategy.hybrid_configs.get("pp_configs", {}) or {}
    return cfg if isinstance(cfg, dict) else {}


class PipelineLayer(torch.nn.Module):
    """A model as a flat list of layers / ``LayerDesc``s, partitioned into
    ``num_stages`` stages (reference pp_layers.py:258). Under a pp axis
    (this thread's ``fleet.init`` with pp_degree = num_stages > 1) the
    rank builds its stage's elements only (with the VPP schedule its
    ``num_virtual_pipeline_stages`` chunks, default the strategy's
    ``vpp_degree``); otherwise all of them. ``layers`` holds the built
    elements under their index in the list, so their parameters carry
    the JAX ``PipelineLayer``'s names (``layers.{i}.…``). ``segments``
    are the global stages' element indices, ``stage_layers(g)`` global
    stage g's elements (built where this rank holds them),
    ``run_function`` this rank's built elements in order."""

    def __init__(self, layers, num_stages=None, loss_fn=None, topology=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._descs = list(layers)
        self._num_stages = num_stages or 1
        self._loss_fn = loss_fn
        hcg = get_hcg()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        cfg = _pp_configs(getattr(hcg, "strategy", None))
        vpp = num_virtual_pipeline_stages
        if vpp is None:
            vpp = int(cfg.get("vpp_degree", 1) or 1) \
                if cfg.get("schedule_mode") == "VPP" else 1
        self._vpp = int(vpp)
        self._segments = None
        if pp > 1:
            if self._num_stages != pp:
                raise ValueError(f"PipelineLayer: num_stages="
                                 f"{self._num_stages} on a pp axis of {pp}")
            stage = hcg.get_stage_id()
            self._segments = partition(self._descs, pp, self._vpp)
            self._chunks = [self._segments[c * pp + stage]
                            for c in range(self._vpp)]
            self._stage = stage
        else:
            self._chunks = [list(range(len(self._descs)))]
            self._stage = 0
        self._pipelined = pp > 1
        self.layers = torch.nn.ModuleDict()
        for idx in sorted(i for ch in self._chunks for i in ch):
            d = self._descs[idx]
            self.layers[str(idx)] = d.build_layer() \
                if isinstance(d, LayerDesc) else d
        self.run_function = [self.layers[str(i)] for ch in self._chunks
                             for i in ch]
        self._plans, self._split = {}, set()   # mp shards (PipelineParallel)

    @property
    def segments(self):
        if self._segments is None:
            self._segments = partition(self._descs, self._num_stages,
                                       self._vpp)
        return self._segments

    def get_num_stages(self):
        return self._num_stages

    def stage_layers(self, stage_id):
        return [self.layers[str(i)] if str(i) in self.layers
                else self._descs[i] for i in self.segments[stage_id]]

    def forward_chunk(self, c, x):
        """This rank's chunk c (its whole stage without VPP) on carry x."""
        for i in self._chunks[c]:
            x = self.layers[str(i)](x)
        return x

    def forward(self, x):
        if self._pipelined:
            raise RuntimeError(
                "PipelineLayer: this rank holds one stage; run the model "
                "through fleet.distributed_model(...)'s train_batch / "
                "eval_batch")
        return self.forward_chunk(0, x)


# -- the weight-gradient split (ZB-H1) -------------------------------------

_tls = threading.local()


class WeightGradStore:
    """Deferred weight-gradient jobs (reference:
    pipeline_zero_bubble.py WeightGradStore): each is a function that
    adds one linear's weight gradient to its ``.grad``. The class-level
    API works on a store per thread; ``ZeroBubblePipelineParallel`` and
    the ZB-H1 runners own a store each."""

    def __init__(self):
        self._q = []

    def _put(self, fn):
        self._q.append(fn)

    def _size(self):
        return len(self._q)

    def _flush(self):
        q, self._q = self._q, []
        for fn in q:
            fn()

    def _clear(self):
        self._q = []

    @classmethod
    def _default(cls):
        store = getattr(_tls, "wgs", None)
        if store is None:
            store = _tls.wgs = cls()
        return store

    @classmethod
    def put(cls, fn):
        cls._default()._put(fn)

    @classmethod
    def size(cls):
        return cls._default()._size()

    @classmethod
    def flush(cls):
        cls._default()._flush()

    @classmethod
    def clear(cls):
        cls._default()._clear()


class _LinearDx(torch.autograd.Function):
    """``x @ w`` whose backward returns the input's gradient and queues
    the weight's on the store."""

    @staticmethod
    def forward(ctx, x, w, weight, store):
        ctx.save_for_backward(x)
        ctx.w, ctx.weight, ctx.store = w, weight, store
        ctx.dtype = torch.promote_types(x.dtype, w.dtype)
        return _common.plain_linear(x, w)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w, weight, store, dtype = ctx.w, ctx.weight, ctx.store, ctx.dtype
        dx = torch.matmul(g, w.to(dtype).t()).to(x.dtype)

        @torch.no_grad()
        def dw():
            k = x.shape[-1]
            gw = torch.matmul(x.to(dtype).reshape(-1, k).t(),
                              g.reshape(-1, g.shape[-1])).to(weight.dtype)
            if weight.grad is None:
                weight.grad = gw
            else:
                weight.grad.add_(gw)
        store._put(dw)
        return dx, None, None, None


@contextlib.contextmanager
def split_weight_grad(store=None):
    """While active on this thread, the port's ``linear`` records only
    the input's gradient path; each weight's gradient x^T g is queued on
    `store` (default the thread's ``WeightGradStore``) and lands on the
    weight's ``.grad`` when the store's job runs (reference
    split_matmul_grad_to_matmul)."""
    target = store if store is not None else WeightGradStore._default()

    def zb_linear(x, weight):
        if not x.requires_grad or not weight.requires_grad \
                or not weight.is_leaf:
            # nothing to defer: the input needs no gradient (the weight's
            # would come in this backward anyway), or the weight is
            # derived (a cast / gathered temporary: its derivation stays
            # on the tape so the parameter gets the gradient)
            return _common.plain_linear(x, weight)
        return _LinearDx.apply(x, weight.detach(), weight, target)

    prev = getattr(_common.weight_grad_split, "fn", None)
    _common.weight_grad_split.fn = zb_linear
    try:
        yield
    finally:
        _common.weight_grad_split.fn = prev


# -- the pipeline ------------------------------------------------------------------

def _takes(fn, name):
    f = fn.forward if isinstance(fn, torch.nn.Module) else fn
    try:
        return name in inspect.signature(f).parameters
    except (TypeError, ValueError):
        return False


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    v = getattr(v, "numpy", lambda: v)()
    return torch.as_tensor(np.asarray(v)).to(device)


def _base_optimizer(opt):
    seen = set()
    while opt is not None and id(opt) not in seen:
        seen.add(id(opt))
        nxt = getattr(opt, "__dict__", {}).get("_inner") \
            or getattr(opt, "__dict__", {}).get("_inner_opt")
        if nxt is None or nxt is opt:
            break
        opt = nxt
    return opt


def _shard_stage(pipe, mesh):
    """Cut this rank's stage parameters to their mp shards under the
    model's ``_shard_rules`` (``pretrain.spec_for_param``,
    ``sharded.plan_params``); returns (plans, split). Nothing to cut
    with mp 1 or without rules."""
    rules = getattr(pipe, "_shard_rules", None)
    config = getattr(pipe, "_config", None)
    if mesh.shape["mp"] == 1 or not rules or config is None:
        return {}, set()
    from ...models.pretrain import spec_for_param
    named = dict(pipe.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    specs = {n: spec_for_param(n, s, mesh, rules) for n, s in shapes.items()}
    head = next((n[:-len(".weight")] for n in named
                 if n.endswith("lm_head.weight")), sharded.HEAD)
    plans, split = sharded.plan_params(config, shapes, specs, mesh.shape,
                                       head=head)
    with torch.no_grad():
        for n, p in named.items():
            if any(a is not None for a in specs[n]):
                p.data = plans[n].layout.take(p.data, mesh.coords)
            p.is_distributed = "mp" in specs[n]
    return plans, split


class PipelineParallel(torch.nn.Module):
    """The pipeline wrapper ``fleet.distributed_model`` gives at pp > 1
    (module docstring). ``comm`` holds the last step's collectives on
    this rank by "op,axis" (sends and receives, the loss's and the
    gradients' all_reduces, the clip's; ``meta_comm`` the meta messages),
    ``max_in_flight`` the last step's most micro-batches stashed at once
    (``pipeline_schedule.in_flight_bound``)."""

    _schedule = None        # a subclass's fixed schedule

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hcg()
        self._strategy = strategy or getattr(self._hcg, "strategy", None)
        cfg = _pp_configs(self._strategy)
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1) or 1)
        self.schedule_mode = self._schedule or cfg.get("schedule_mode") \
            or "1F1B"
        if self.schedule_mode not in SCHEDULES:
            raise ValueError(f"schedule_mode must be one of {SCHEDULES}, "
                             f"got {self.schedule_mode!r}")
        self.vpp_degree = int(cfg.get("vpp_degree", 1) or 1)
        if self.schedule_mode == "VPP" and self.vpp_degree < 2:
            raise ValueError("VPP schedule needs vpp_degree >= 2")
        hcg = self._hcg
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self._pipelined = (pp > 1 and isinstance(layers, PipelineLayer)
                           and layers.get_num_stages() > 1)
        self.comm, self.meta_comm = {}, {}
        self.max_in_flight = 0
        self._wgs = WeightGradStore()
        if not self._pipelined:
            return
        if hcg.get_sharding_parallel_world_size() > 1 \
                or hcg.get_sep_parallel_world_size() > 1:
            raise NotImplementedError(
                "PipelineParallel: the sharding (fsdp) and sep (sp) axes "
                "together with pp > 1 are not ported yet (ROADMAP Queue 1 "
                "item 9)")
        V = self.vpp_degree if self.schedule_mode == "VPP" else 1
        if layers._vpp != V:
            raise ValueError(f"PipelineParallel: the PipelineLayer was "
                             f"built with {layers._vpp} chunks a rank, the "
                             f"{self.schedule_mode} schedule runs {V}")
        self.mesh = hcg.mesh
        self._S, self._stage = pp, hcg.get_stage_id()
        self._engine = PipelineEngine(self.schedule_mode, pp, self._stage,
                                      self.mesh.groups["pp"], V,
                                      stats=self.comm,
                                      meta_stats=self.meta_comm)
        layers._plans, layers._split = _shard_stage(layers, self.mesh)

    # -- helpers -------------------------------------------------------
    @property
    def _last(self):
        return self._stage == self._S - 1

    def _group(self, axis):
        return self.mesh.groups[axis]

    def _size(self, axis):
        return self.mesh.shape[axis]

    def _loss(self, out, labels, count, n_micro):
        net = self._layers
        fn = net._loss_fn
        if fn is None:
            return out.to(torch.float32).mean() / \
                (n_micro * self._size("dp"))
        kw = {}
        if _takes(fn, "denominator"):
            kw["denominator"] = count
        if _takes(fn, "vocab_parallel"):
            vp = getattr(net.run_function[-1], "vocab_parallel", None)
            kw["vocab_parallel"] = vp() if vp is not None else None
        loss = fn(out, labels, **kw).to(torch.float32)
        if "denominator" not in kw:
            loss = loss / (n_micro * self._size("dp"))
        return loss

    def _sum(self, t, axis):
        if self._size(axis) > 1:
            collective.all_reduce(t, group=self._group(axis), axis=axis,
                                  stats=self.comm)
        return t

    def _clip(self, optimizer):
        """The base optimizer's global-norm clip, made the hybrid one
        (over mp and pp) where it is not yet."""
        base = _base_optimizer(optimizer)
        clip = getattr(base, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm) \
                and not isinstance(clip, HybridParallelClipGrad):
            clip = base._grad_clip = HybridParallelClipGrad(clip, self._hcg)
        return clip if isinstance(clip, HybridParallelClipGrad) else None

    def _run(self, data, backward, scaler=None, compute_loss=True):
        """One pass of the schedule over ``data``'s micro-batches: (the
        last stage's summed micro-batch losses, its outputs)."""
        dev = self.mesh.device
        x, y = data
        x = _as_tensor(x, dev)
        M = self.accumulate_steps
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accumulate_steps={M}")
        xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        losses, count = [], None
        ys = None
        if self._last and compute_loss:
            y = _as_tensor(y, dev)
            ys = y.reshape((M, y.shape[0] // M) + tuple(y.shape[1:]))
            if _takes(self._layers._loss_fn, "denominator"):
                count = self._sum((y != -100).sum().to(
                    torch.float32).reshape(1), "dp").clamp_min(1.0)[0]

        def last_loss(m, out):
            if not compute_loss:
                return torch.zeros((), device=dev)
            loss = self._loss(out, ys[m], count, M)
            losses.append(loss.detach())
            if scaler is not None:
                return scaler.scale(loss)
            return loss

        store = None
        if backward and self.schedule_mode == "ZBH1":
            store = self._wgs
            store._clear()
        net = self._layers
        bind = sharded.bound(net, self.mesh, net._plans, net._split, None,
                             self.comm) if net._plans \
            else contextlib.nullcontext()
        with bind:
            res = self._engine.run(
                M, net.forward_chunk, lambda m: xs[m], last_loss,
                device=dev, backward=backward,
                meta_key=tuple(xs.shape[1:]), wgrad_store=store)
        self.max_in_flight = res.max_in_flight
        total = torch.zeros(1, dtype=torch.float32, device=dev)
        if self._last and losses:
            total = torch.stack(losses).sum().reshape(1)
            self._sum(total, "dp")
        return total, res

    # -- the API -------------------------------------------------------
    def forward(self, *args, **kwargs):
        if not self._pipelined:
            return self._layers(*args, **kwargs)
        return self.eval_batch((args[0], None), compute_loss=False)

    def _backward_context(self):
        return contextlib.nullcontext()

    def _before_step(self):
        pass

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One training step over ``data`` = (ids, labels), this rank's
        rows; returns the step's loss, a 0-dim float32 tensor, the same on
        every rank (module docstring)."""
        if not self._pipelined:
            return self._micro_loop(data, optimizer, lr_scheduler, scaler)
        self.comm.clear()
        clip = self._clip(optimizer)
        total, _ = self._run(data, True, scaler=scaler)
        collective.all_reduce(total, group=self._group("pp"), axis="pp",
                              stats=self.comm)
        self._reduce_grads()
        if clip is not None:
            clip.stats = self.comm
        try:
            if scaler is not None:
                prev = scaler._group
                groups = [self._group("pp")] + (
                    [self._group("mp")] if self._size("mp") > 1 else [])
                scaler._group = groups
                try:
                    scaler.step(optimizer)
                    scaler.update()
                finally:
                    scaler._group = prev
            else:
                optimizer.step()
        finally:
            if clip is not None:
                clip.stats = None
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total[0]

    def _reduce_grads(self):
        """Every gradient summed over dp, one flat float32 all_reduce."""
        if self._size("dp") == 1:
            return
        params = [p for p in self._layers.parameters() if p.grad is not None]
        if not params:
            return
        flat = torch.cat([p.grad.reshape(-1).to(torch.float32)
                          for p in params])
        self._sum(flat, "dp")
        off = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n

    def _micro_loop(self, data, optimizer, lr_scheduler, scaler):
        """The JAX package's eager micro-batch loop (no pp axis)."""
        net = self._layers
        dev = next((p.device for p in net.parameters()), None)
        x, y = (_as_tensor(v, dev) for v in data)
        n_micro = max(self.accumulate_steps, 1)
        bsz = x.shape[0]
        micro = max(bsz // n_micro, 1)
        total = None
        loss_fn = getattr(net, "_loss_fn", None)
        with self._backward_context():
            for i in range(0, bsz, micro):
                out = net(x[i:i + micro])
                loss = loss_fn(out, y[i:i + micro]) if loss_fn is not None \
                    else out.mean()
                scaled = loss * (micro / bsz)
                if scaler is not None:
                    scaler.scale(scaled).backward()
                else:
                    scaled.backward()
                v = float(scaled.detach())
                total = v if total is None else total + v
        self._before_step()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(np.float32(total))

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forwards over ``data``'s micro-batches; the loss (the same
        on every rank) or, with ``compute_loss`` False, the last stage's
        outputs in batch order (None on the other stages: the JAX
        package's one controller returns them everywhere)."""
        if not self._pipelined:
            x, y = data
            net = self._layers
            dev = next((p.device for p in net.parameters()), None)
            out = net(_as_tensor(x, dev))
            loss_fn = getattr(net, "_loss_fn", None)
            if compute_loss and loss_fn is not None:
                return loss_fn(out, _as_tensor(y, dev))
            return out
        total, res = self._run(data, False, compute_loss=compute_loss)
        if compute_loss:
            collective.all_reduce(total, group=self._group("pp"),
                                  axis="pp")
            return total[0]
        if not self._last:
            return None
        outs = [res.outputs[m] for m in sorted(res.outputs)]
        return torch.cat(outs) if isinstance(outs[0], torch.Tensor) \
            else outs

    def set_state_dict(self, state, *a, **k):
        return self.load_state_dict(state, *a, **k)


class ZeroBubblePipelineParallel(PipelineParallel):
    """ZB-H1 on a pp axis (``pipeline_schedule``: each linear's input
    gradient in B, its weight gradient in W, up to i micro-batches later
    on stage i); without one, the JAX package's eager zero-bubble loop:
    each micro-batch's backward under ``split_weight_grad``, the weight
    gradients flushed before the optimizer steps."""

    _schedule = "ZBH1"

    def _backward_context(self):
        self._wgs._clear()
        return split_weight_grad(store=self._wgs)

    def _before_step(self):
        self._wgs._flush()


# -- closed form -------------------------------------------------------------------

def pipeline_comm(schedule, S, V, M, stage, carry_bytes, dp=1, mp=1,
                  grad_elems=0, clip=True, plans=None, split=(),
                  tokens=0, hidden=0, act_bytes=2, compute_bytes=2):
    """The collectives of one ``train_batch`` on stage `stage` in closed
    form, {"op,axis": {"calls", "bytes"}}, as ``comm`` counts them (meta
    messages apart): a send and a receive of the packed carry
    (`carry_bytes` a micro-batch) for each forward into a next global
    stage and each backward into a previous one (VPP: V chunks a rank);
    the loss's all_reduce over pp (4 bytes) and, with the global-norm
    `clip`, its sum of squares over pp and mp (8 bytes each); with
    dp > 1 the gradients' flat f32 all_reduce (`grad_elems` this rank's
    gradient elements) and, on the last stage, the label count and the
    loss over dp. With mp > 1, the stage's Megatron operators each
    micro-batch (``plans`` / ``split`` of ``_shard_stage``, ``tokens``
    a micro-batch's rows x positions): two all_reduces of [tokens,
    hidden] activations a split module, three for a vocab-parallel head
    (its input's gradient, the cross entropy's maxima [tokens] f32 and
    sums [tokens, 2] f32), and an all_gather of each weight the plan
    gathers."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule_mode must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    V = V if schedule == "VPP" else 1
    out = {}

    def add(op, ax, calls, nbytes):
        row = out.setdefault(f"{op},{ax}", {"calls": 0, "bytes": 0})
        row["calls"] += calls
        row["bytes"] += int(nbytes)

    hops = M * (2 * V - int(stage == 0) - int(stage == S - 1))
    add("send", "pp", hops, hops * carry_bytes)
    add("recv", "pp", hops, hops * carry_bytes)
    add("all_reduce", "pp", 1, 4)
    if clip:
        add("all_reduce", "pp", 1, 8)
        if mp > 1:
            add("all_reduce", "mp", 1, 8)
    if dp > 1:
        add("all_reduce", "dp", 1, 4 * grad_elems)
        if stage == S - 1:
            add("all_reduce", "dp", 2, 8)
    if mp > 1 and plans:
        act = tokens * hidden * act_bytes
        blocks = [p for p in split if not p.endswith("lm_head")]
        add("all_reduce", "mp", 2 * M * len(blocks),
            2 * M * len(blocks) * act)
        if len(blocks) != len(split):
            add("all_reduce", "mp", 3 * M, M * (act + tokens * (4 + 8)))
        for plan in plans.values():
            numel = int(np.prod(plan.layout.local_shape))
            for _, ax, _ in plan.steps:
                numel *= mp
                add("all_gather", ax, M, M * numel * compute_bytes)
    return out
