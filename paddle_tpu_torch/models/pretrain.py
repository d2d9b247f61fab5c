"""The pretraining step of the PyTorch port (counterpart of
``paddle_tpu/models/pretrain.py``), on one card or on a mesh.

The JAX package jits one sharded program over a mesh; the port runs the
same step eagerly. On one card (``mesh`` None, or ``make_mesh(1)``): an
AMP-O2 forward (parameters with
ndim >= 2 cast to bf16 when ``config.dtype`` is "bfloat16", so the
gradients land on the float32 masters), autograd, then AdamW with a
global-norm clip (kernel D of ``ops.adamw`` on the card: two launches a
step). The optimizer updates the masters and moments in place, where the
JAX package returns new arrays: one copy of each lives on the card.

In-step telemetry (``telemetry=True``, implied by ``monitor=``) adds the
packed per-layer-group health vector to the step: kernel D computes it
inside its two launches (``ops.adamw``), and ``run()`` fetches it in one
device-to-host copy on the telemetry cadence and hands it to the
``TrainHealthMonitor`` (``observability.train_health``). ``run(...,
lr_scale=)`` scales one step's learning rate (the fault injector's lr
spike).

On a mesh (``make_mesh(n, dp=, fsdp=, mp=, group=)``, one process or
thread a rank over a ``torch.distributed`` world group): the JAX package's
sharding rules (``llama_sharding_rules`` and ``spec_for_param``) place
each float32 master and its two moments on the ranks
(``make_train_state``: each rank holds the JAX device's shard), the
forward gathers the weights just before use (ZeRO-3 over fsdp) and
splits the attention heads and FFN columns over mp (Megatron), as
``distributed.fleet.sharded`` sets out; the loss is the global mean over
the labels kept (each rank's sum over the global count, both summed over
the data group), gradients are summed over the data group in float32,
and kernel D runs on the local shards with the clip norm's sum of squares
all_reduced between its two launches. ``shard_batch`` gives a rank its
rows of the batch.

The mesh's ``sp`` axis is context parallelism: ``shard_batch`` also
gives a rank its contiguous block of the sequence, the model (which
needs ``LlamaConfig(context_parallel=True)``) attends over the axis
(``fleet.context_parallel``: ring or Ulysses, RoPE at the block's global
positions), and the loss, its count and the gradients of every
parameter (each replicated over sp) are summed over the data axes and
sp together (the mesh's group over sp and the data axes above 1:
``sharded.batch_group``). ``make_mesh(pp=)`` builds the pipeline axis
(its group is ``mesh.groups["pp"]``), which the pipeline's
``fleet.distributed_model(LlamaForCausalLMPipe(...))`` trains on
(``distributed.fleet.pipeline_parallel``); ``make_train_step`` on a mesh
with pp > 1 raises, naming it (the JAX step has no pp handling).
"""
import re
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..distributed import collective
from ..distributed.fleet import sharded
from ..distributed.mesh import AXES, Mesh, ProcessMesh, get_mesh, set_mesh
from ..observability import costs as _costs
from ..observability import instrument as _metrics
from ..ops import adamw

__all__ = ["flagship_config", "llama_sharding_rules", "gpt_sharding_rules",
           "ernie_sharding_rules", "spec_for_param", "make_mesh",
           "make_train_state", "make_train_step", "shard_batch",
           "shard_state_from_numpy", "gather_state_to_numpy",
           "batch_to_device"]


def flagship_config(on_tpu=True):
    """The headline training shape: (LlamaConfig, batch, seq), with the JAX
    package's signature. ``on_tpu`` False gives the CPU smoke form (tiny
    config in float32, 4 x 64); True the full shape, which the port runs on
    the card."""
    from .llama import LlamaConfig
    if not on_tpu:
        return LlamaConfig.tiny(dtype="float32"), 4, 64
    cfg = LlamaConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816,
        num_hidden_layers=24, num_attention_heads=16,
        num_key_value_heads=16, max_position_embeddings=2048,
        dtype="bfloat16", fuse_attention_qkv=True, fuse_attention_ffn=True)
    return cfg, 8, 2048


# (name-regex, spec-template), first match wins: the JAX package's tables
# (paddle_tpu/models/pretrain.py:55-101). 'mp' is tensor parallel, 'fsdp'
# the ZeRO shard axis; a template dim that does not divide its mesh axis
# is replicated.
def llama_sharding_rules():
    return [
        (r".*embed_tokens\.weight$",        ("fsdp", "mp")),
        (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj|qkv_proj|"
         r"gate_up_fused_proj)\.weight$",
                                            ("fsdp", "mp")),   # column [in, out]
        (r".*(o_proj|down_proj)\.weight$",  ("mp", "fsdp")),   # row [in, out]
        (r".*lm_head\.weight$",             ("fsdp", "mp")),
        (r".*norm.*\.weight$",              (None,)),
        (r".*",                             (None,)),
    ]


def gpt_sharding_rules():
    return [
        (r".*word_embeddings\.weight$",     ("fsdp", "mp")),
        (r".*position_embeddings\.weight$", (None, "mp")),
        (r".*(qkv_proj|linear1)\.weight$",  ("fsdp", "mp")),
        (r".*(out_proj|linear2)\.weight$",  ("mp", "fsdp")),
        (r".*(qkv_proj|linear1)\.bias$",    ("mp",)),
        (r".*",                             (None,)),
    ]


def ernie_sharding_rules():
    """TP plan for the BERT/ERNIE encoder family (q/k/v/linear1 column-
    parallel, out_proj/linear2 row-parallel)."""
    return [
        (r".*word_embeddings\.weight$",      ("fsdp", "mp")),
        (r".*(position|token_type)_embeddings\.weight$", (None, "mp")),
        (r".*(q_proj|k_proj|v_proj|linear1)\.weight$",   ("fsdp", "mp")),
        (r".*(out_proj|linear2)\.weight$",   ("mp", "fsdp")),
        (r".*(q_proj|k_proj|v_proj|linear1)\.bias$",     ("mp",)),
        (r".*",                              (None,)),
    ]


def _axis_sizes(mesh):
    shape = mesh.shape
    return {a: int(shape[a]) for a in mesh.axis_names}


def spec_for_param(name, shape, mesh, rules):
    """The spec of one parameter: a tuple of mesh axis names (or None) of
    the parameter's rank, the JAX ``PartitionSpec``'s entries. An axis
    that does not divide its dim, or has size 1, is dropped (the dim is
    replicated)."""
    sizes = _axis_sizes(mesh)
    for pat, template in rules:
        if re.match(pat, name):
            dims = []
            for d, ax in enumerate(template):
                if (ax is not None and ax in sizes and d < len(shape)
                        and shape[d] % sizes[ax] == 0 and sizes[ax] > 1):
                    dims.append(ax)
                else:
                    dims.append(None)
            dims += [None] * (len(shape) - len(dims))
            return tuple(dims[: len(shape)])
    return (None,) * len(shape)


def make_mesh(n_devices=None, dp=None, fsdp=None, mp=None, sp=1, pp=1,
              group=None, device="cuda", timeout=None):
    """This rank's view of a mesh with the canonical axis order (pp, dp,
    fsdp, sp, mp), the JAX ``make_mesh``'s arguments. ``group`` is the
    caller's world group (``collective.new_group`` or any
    ``torch.distributed`` group whose store is known), ``device`` this
    rank's device (the card unless the caller names the CPU), ``timeout``
    the axis groups' bound in seconds (default: the world group's).
    ``n_devices`` defaults to the group's size (1 without one):
    ``make_mesh(1)`` is the single-rank mesh, on which the step is the
    one-card step. sp > 1 splits each row's sequence into contiguous
    blocks (context parallelism); pp > 1 is the pipeline's axis, the
    slowest-varying one (``fleet.pipeline_parallel``)."""
    n = n_devices or (group.size() if group is not None else 1)
    mp = 1 if mp is None else mp
    fsdp = 1 if fsdp is None else fsdp
    if dp is None:
        dp = n // (mp * fsdp * sp * pp)
    assert pp * dp * fsdp * mp * sp == n, \
        f"pp{pp}*dp{dp}*fsdp{fsdp}*mp{mp}*sp{sp} != {n}"
    return Mesh(dict(pp=pp, dp=dp, fsdp=fsdp, sp=sp, mp=mp), group=group,
                device=device, timeout=timeout)


def _on_mesh(mesh):
    """Whether ``mesh`` takes the sharded path (more than one rank)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"pretrain: a mesh is make_mesh(...)'s, not "
                        f"{type(mesh).__name__}")
    if mesh is None or mesh.size == 1:
        return False
    if mesh.layout_only:
        raise ValueError("a mesh of more than one rank needs the world "
                         "group (make_mesh(..., group=))")
    return True


def _hyper(lr, betas, eps, weight_decay, grad_clip):
    return dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                grad_clip=grad_clip)


def make_train_state(model, mesh=None, rules=None, lr=3e-4,
                     betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                     grad_clip=1.0):
    """(params, opt_state, meta): float32 master copies of the model's
    parameters, zero AdamW moments and the step count, and the optimizer
    settings. The JAX package's argument order: ``mesh`` None (or a mesh
    of one rank) is the single-device case; on a larger mesh each is this
    rank's shard under ``rules`` (default ``llama_sharding_rules``) on
    the mesh's device, and ``meta`` holds the specs and the plan."""
    hyper = _hyper(lr, betas, eps, weight_decay, grad_clip)
    if not _on_mesh(mesh):
        params = {n: p.detach().to(torch.float32).clone()
                  for n, p in model.named_parameters()}
        opt_state = {"m": {n: torch.zeros_like(p)
                           for n, p in params.items()},
                     "v": {n: torch.zeros_like(p)
                           for n, p in params.items()},
                     "count": 0}
        return params, opt_state, hyper
    return _shard_state(dict(model.named_parameters()), model.config, mesh,
                        rules, hyper)


def _shard_state(whole, config, mesh, rules, hyper):
    rules = rules or llama_sharding_rules()
    shapes = {n: tuple(p.shape) for n, p in whole.items()}
    specs = {n: spec_for_param(n, s, mesh, rules) for n, s in shapes.items()}
    plans, split = sharded.plan_params(config, shapes, specs,
                                       _axis_sizes(mesh))
    params = {}
    for n, p in whole.items():
        t = torch.as_tensor(p).detach().to(torch.float32)
        # a copy of its own: the masters are updated in place
        params[n] = plans[n].layout.take(t, mesh.coords).to(
            mesh.device, copy=True)
    opt_state = {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                 "v": {n: torch.zeros_like(p) for n, p in params.items()},
                 "count": 0}
    meta = dict(hyper, specs=specs, rules=rules, plans=plans, split=split,
                shapes=shapes)
    return params, opt_state, meta


def shard_state_from_numpy(params_np, mesh, rules=None, config=None,
                           lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                           weight_decay=0.1, grad_clip=1.0):
    """``make_train_state`` from whole numpy arrays ({name: array}, the
    JAX ``state_arrays`` names; ``config`` the model's LlamaConfig): this
    rank's float32 shards, zero moments and ``meta``."""
    if config is None:
        raise ValueError("shard_state_from_numpy: the model's config is "
                         "needed (the heads of the fused weights)")
    hyper = _hyper(lr, betas, eps, weight_decay, grad_clip)
    whole = {n: torch.from_numpy(np.array(a, dtype=np.float32))
             for n, a in params_np.items()}
    if not _on_mesh(mesh):
        dev = mesh.device if mesh is not None else torch.device("cpu")
        params = {n: t.to(dev) for n, t in whole.items()}
        return params, {"m": {n: torch.zeros_like(p)
                              for n, p in params.items()},
                        "v": {n: torch.zeros_like(p)
                              for n, p in params.items()},
                        "count": 0}, hyper
    return _shard_state(whole, config, mesh, rules, hyper)


def gather_state_to_numpy(tree, mesh, meta):
    """{name: whole float32 numpy array} from every rank's shards of
    ``tree`` (the params, or a moment dict) in the layouts of ``meta``;
    the inverse of ``shard_state_from_numpy``. A collective over the
    world group: every rank calls it and gets the whole arrays."""
    if not _on_mesh(mesh):
        return {n: t.detach().to(torch.float32).cpu().numpy()
                for n, t in tree.items()}
    grid = [mesh.shape[a] for a in AXES]
    out = {}
    for n in sorted(tree):
        layout = meta["plans"][n].layout
        parts = collective.all_gather([], tree[n].detach().contiguous(),
                                      group=mesh.world)
        whole = np.empty(layout.shape, np.float32)
        for r, part in enumerate(parts):
            coords = dict(zip(AXES, np.unravel_index(r, grid)))
            layout.put(whole, part.cpu().numpy(), coords)
        out[n] = whole
    return out


def _adamw(params, grads, opt_state, lr, b1, b2, eps, wd, clip,
           step_fn=None, telemetry=None, mesh=None):
    """AdamW with global-norm clipping, the JAX package's math: grads
    scaled by min(1, clip / (gnorm + 1e-6)), bias-corrected moments, eps
    outside the square root, decoupled decay on parameters with
    ndim >= 2 only. Updates params and opt_state (moments and count) in
    place; returns (params, opt_state, gnorm) with gnorm a 0-dim float32
    tensor. On the card the update is kernel D (``ops.adamw``: two
    launches a step), on the CPU its plain version. ``telemetry`` =
    (spec, loss) also returns the packed vector of ``_pack_telemetry``'s
    layout, from the same two launches: (params, opt_state, gnorm,
    vec). ``mesh`` = (owned, reduce) runs the mesh form: ``owned[i]``
    whether tensor i's shard counts on this rank, ``reduce`` the
    all_reduce of the norm's (and the telemetry's) sums over the
    world."""
    names = list(params)
    ps = [params[n] for n in names]
    count = opt_state["count"] + 1
    kw = {}
    if telemetry is not None:
        spec, loss = telemetry
        group_of = {n: j for j, (_, ns) in enumerate(spec.groups)
                    for n in ns}
        kw = dict(groups=[group_of[n] for n in names], loss=loss)
    if mesh is not None:
        kw.update(owned=mesh[0], reduce=mesh[1])
    out = (step_fn or adamw.adamw_step)(
        ps, [grads[n] for n in names], [opt_state["m"][n] for n in names],
        [opt_state["v"][n] for n in names], [p.dim() >= 2 for p in ps], lr,
        b1, b2, eps, wd, clip, count, **kw)
    opt_state["count"] = count
    if telemetry is None:
        return params, opt_state, out
    return (params, opt_state) + tuple(out)


def _adamw_plain(params, grads, opt_state, lr, b1, b2, eps, wd, clip):
    """``_adamw`` through the plain foreach passes on any device, kernel D's
    plain version (the tests' reference)."""
    return _adamw(params, grads, opt_state, lr, b1, b2, eps, wd, clip,
                  step_fn=adamw.adamw_step_plain)


def make_train_step(model, mesh, meta, donate=True, telemetry=False,
                    telemetry_every=1, monitor=None, catalog=None):
    """``run(params, opt_state, batch, lr_scale=None) -> (params,
    opt_state, loss, gnorm)``: one AMP-O2 training step of ``model`` on
    the params' device. ``batch`` = {input_ids: [B, S], labels: [B, S]}
    tensors (``batch_to_device``). loss and gnorm come back as 0-dim
    float32 tensors without a host sync.

    Each call lands the train metrics of ``observability.instrument``:
    train_step_seconds, dispatch_seconds{program="pretrain_step"},
    train_steps_total, train_tokens_total and train_tokens_per_s. The
    step is eager, so its host wall covers the enqueue of every kernel;
    it reaches the device time once the launch queue backs up.

    ``telemetry=True`` (implied by ``monitor=``) computes the packed
    per-layer-group health vector every step (kernel D's telemetry, no
    extra pass), records the ``train_host`` / ``train_step`` spans and
    the data-wait / host / dispatch split, and every
    ``telemetry_every`` steps fetches the vector in one device-to-host
    copy, lands the train_group_* gauges and hands the unpacked dict to
    ``monitor`` when one is attached. Losses, parameters and moments are
    the same bits with telemetry on and off. ``lr_scale`` makes that
    step's learning rate the f32 product of lr and the scale, as the JAX
    step's ``lr * jnp.float32(lr_scale)`` rounds it.

    While the cost catalog (``catalog``, default the process's
    ``observability.costs.get_cost_catalog()``; ranks that are threads
    give one rank a catalog of its own) is enabled, the first step runs
    counted as ``pretrain_step`` (forward, backward and AdamW:
    flops, bytes, peak memory, the kernels' own counts) and every later
    one is timed on the device into
    ``program_device_seconds{program="pretrain_step"}``.

    The JAX package's argument order: ``mesh`` None (or a mesh of one
    rank) is the single-device case. On a larger mesh every rank calls
    ``run`` with its own state (``make_train_state``) and its rows of the
    batch (``shard_batch``); loss and gnorm are the global ones on every
    rank, and ``run.comm`` holds the step's collectives on this rank
    ({"op,axis": {"calls", "bytes"}}, the last step's).
    ``donate`` is accepted and does nothing: the eager step already
    updates the masters and moments in place, where the JAX step donates
    its input buffers."""
    on_mesh = _on_mesh(mesh)
    if on_mesh and mesh.shape["pp"] > 1:
        raise NotImplementedError(
            "make_train_step: a mesh with pp > 1 is the pipeline's; train "
            "it through fleet.distributed_model(LlamaForCausalLMPipe(...))"
            ".train_batch")
    lr, (b1, b2) = meta["lr"], meta["betas"]
    eps, wd, clip = meta["eps"], meta["weight_decay"], meta["grad_clip"]
    telemetry = telemetry or monitor is not None
    spec = None
    if telemetry:
        from ..observability import train_health as _th
        spec = _th.build_telemetry_spec(
            {n: p.dim() for n, p in model.named_parameters()})
    bf16_compute = getattr(getattr(model, "config", None), "dtype",
                           None) == "bfloat16"
    # step-phase bookkeeping (telemetry): the host time between steps
    # less the data wait the instrumented loader reported
    phase = {"step": 0, "last_exit": None}
    attributed = []     # cost catalog: the step is counted once

    comm = {}           # this rank's collectives of the last step
    plans, split = meta.get("plans", {}), meta.get("split", set())
    owned = {n: sharded.owned(plans[n], mesh) for n in plans}
    # the ranks the batch is split over: its rows over (dp, fsdp), each
    # row's sequence over sp
    red = sharded.batch_group(mesh.shape) if on_mesh else None
    if on_mesh and mesh.shape["sp"] > 1 and not getattr(
            getattr(model, "config", None), "context_parallel", False):
        raise ValueError(
            "make_train_step: a mesh with sp > 1 splits the sequence; the "
            "model needs LlamaConfig(context_parallel=True)")
    cdtype = torch.bfloat16 if bf16_compute else None

    def data_sum(t):
        if red is not None:
            collective.all_reduce(t, group=mesh.groups[red], axis=red,
                                  stats=comm)
        return t

    def world_sum(t):
        return collective.all_reduce(t, group=mesh.world, axis="world",
                                     stats=comm)

    def step(params, opt_state, batch, eff_lr):
        """The step itself: (params, opt_state, loss, gnorm[, vec]). A
        weight of ndim >= 2 that the mesh gathers is cast at each use
        (``sharded.bound``); every other one is cast once here, as the
        JAX step casts its tree. One rank (no plans) is the one-card
        step: no collective, the model's own mean loss, kernel D's
        one-device form."""
        comm.clear()
        was_training = model.training
        model.train()
        try:
            names = list(params)
            leaves = [params[n].detach().requires_grad_(True) for n in names]
            fwd = {n: (p.to(cdtype) if cdtype is not None and p.dim() >= 2
                       and not (n in plans and plans[n].steps) else p)
                   for n, p in zip(names, leaves)}
            kw = {"labels": batch["labels"]}
            if red is not None:
                # the global mean: each rank's sum over the count of the
                # labels kept on every rank of the batch's split
                count = data_sum((batch["labels"] != -100).sum().to(
                    torch.float32).reshape(1))
                kw["loss_denominator"] = count.clamp_min(1.0)[0]
            with sharded.bound(model, mesh, plans, split, cdtype, comm,
                               context_parallel=on_mesh
                               and mesh.shape["sp"] > 1):
                _, loss = torch.func.functional_call(
                    model, fwd, (batch["input_ids"],), kw)
                loss = loss.to(torch.float32)
                grads = torch.autograd.grad(loss, leaves)
            grads = sharded.reduce_grads(names, grads, plans, mesh, comm)
            loss = data_sum(loss.detach().reshape(1).clone())[0]
            out = _adamw(params, dict(zip(names, grads)), opt_state, eff_lr,
                         b1, b2, eps, wd, clip,
                         telemetry=None if spec is None else (spec, loss),
                         mesh=([owned[n] for n in names], world_sum)
                         if on_mesh else None)
            return out[:2] + (loss,) + out[2:]
        finally:
            if not was_training:
                model.eval()

    def run(params, opt_state, batch, lr_scale=None):
        if mesh is None:
            return _run(params, opt_state, batch, lr_scale)
        prev = get_mesh()
        set_mesh(ProcessMesh(mesh))
        try:
            return _run(params, opt_state, batch, lr_scale)
        finally:
            set_mesh(prev)

    def _run(params, opt_state, batch, lr_scale):
        tokens = batch["input_ids"].numel()
        data_wait_s = 0.0
        if spec is not None:
            from ..observability import train_health as _th
            from ..observability import tracing as _tracing
            enter = time.perf_counter()
            data_wait_s = _th.pop_data_wait()
            if phase["last_exit"] is not None:
                gap = enter - phase["last_exit"]
                host_s = max(0.0, gap - data_wait_s)
                _metrics.train_host_seconds().observe(host_s)
                _tracing.get_tracer().record_span(
                    "train_host", (enter - host_s) * 1e6, host_s * 1e6,
                    request="train", step=phase["step"])
        eff_lr = lr if lr_scale is None else float(
            np.float32(lr) * np.float32(lr_scale))
        cat = catalog if catalog is not None else _costs.get_cost_catalog()
        timer = None
        t0 = time.monotonic()
        if cat.enabled and not attributed:
            # once: the whole step (forward, backward, AdamW) counted as
            # it runs, under `pretrain_step`
            attributed.append(True)
            out, _ = cat.count_call(
                "pretrain_step", step, (params, opt_state, batch, eff_lr))
        else:
            if cat.enabled:
                timer = cat.start_timer(batch["input_ids"].device)
            out = step(params, opt_state, batch, eff_lr)
            if timer is not None:
                cat.stop_timer("pretrain_step", timer)
        dur = time.monotonic() - t0
        _metrics.train_step_seconds().observe(dur)
        _metrics.dispatch_seconds().labels(
            program="pretrain_step").observe(dur)
        _metrics.train_steps_total().inc()
        tok_per_s = None
        if tokens:
            _metrics.train_tokens_total().inc(tokens)
            if dur > 0:
                tok_per_s = tokens / dur
                _metrics.train_tokens_per_s().set(tok_per_s)
        if spec is not None:
            out = _telemetry_hook(out, dur, tok_per_s, data_wait_s)
        return out

    def _telemetry_hook(out, dispatch_s, tok_per_s, data_wait_s):
        """The host tail of one telemetry step: the train_step span every
        step, the one bulk fetch of the vector on the cadence only.
        Returns the caller's 4-tuple."""
        from ..observability import train_health as _th
        from ..observability import tracing as _tracing
        i = phase["step"]
        phase["step"] = i + 1
        end = time.perf_counter()
        _tracing.get_tracer().record_span(
            "train_step", (end - dispatch_s) * 1e6, dispatch_s * 1e6,
            request="train", step=i, data_wait_s=data_wait_s)
        params_out, opt_out, loss, gnorm, vec = out
        if i % max(1, int(telemetry_every)) == 0:
            unpacked = spec.unpack(vec.cpu().tolist())  # one D2H copy
            if monitor is not None:
                monitor.observe_step(i, unpacked["loss"], unpacked["gnorm"],
                                     groups=unpacked["groups"],
                                     tokens_per_s=tok_per_s)
            else:
                _th.record_telemetry(unpacked)
        phase["last_exit"] = time.perf_counter()
        return params_out, opt_out, loss, gnorm

    run._step = step
    run._telemetry_spec = spec
    run._monitor = monitor
    run.comm = comm
    return run


def shard_batch(batch, mesh):
    """This rank's part of a host batch dict of integer arrays, as int64
    tensors on the mesh's device: the batch dim split over (dp, fsdp) in
    the row-major order of JAX's combined axis (data index
    dp_idx * fsdp + fsdp_idx), and the sequence dim (dim 1) over sp in
    contiguous blocks, block ``coords["sp"]`` (JAX's P(("dp", "fsdp"),
    "sp")). The labels are already shifted, so no shift crosses a
    block's edge. ``mesh`` None is ``batch_to_device`` on the card."""
    if mesh is None:
        return batch_to_device(batch)
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        n = mesh.data_size
        if a.shape[0] % n:
            raise ValueError(f"shard_batch: {k} has {a.shape[0]} rows, "
                             f"not a multiple of dp * fsdp = {n}")
        rows = a.shape[0] // n
        part = a[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        sp = mesh.shape["sp"]
        if sp > 1 and part.ndim >= 2:
            if part.shape[1] % sp:
                raise ValueError(f"shard_batch: {k} has {part.shape[1]} "
                                 f"positions, not a multiple of sp = {sp}")
            cols = part.shape[1] // sp
            i = mesh.coords["sp"]
            part = part[:, i * cols:(i + 1) * cols]
        out[k] = torch.as_tensor(part, dtype=torch.int64).to(mesh.device)
    return out


def batch_to_device(batch, device="cuda"):
    """A host batch dict of integer arrays as int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64).to(dev)
            for k, v in batch.items()}
