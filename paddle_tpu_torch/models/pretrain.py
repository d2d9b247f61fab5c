"""Single-device pretraining step for the PyTorch port (counterpart of
``paddle_tpu/models/pretrain.py``).

The JAX package jits one sharded program over a mesh; the port runs the
same step eagerly on one card: an AMP-O2 forward (parameters with
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

Not ported in this slice (they raise ``NotImplementedError``): the mesh
and its sharding rules. ``shard_batch`` becomes ``batch_to_device``.
"""
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import instrument as _metrics
from ..ops import adamw

__all__ = ["flagship_config", "make_train_state", "make_train_step",
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


def _later_slice(what):
    raise NotImplementedError(f"pretrain: {what} is a later slice of the "
                              "port (single device only)")


def make_train_state(model, mesh=None, rules=None, lr=3e-4,
                     betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                     grad_clip=1.0):
    """(params, opt_state, meta): float32 master copies of the model's
    parameters, zero AdamW moments and the step count, and the optimizer
    settings. The JAX package's argument order: ``mesh`` None is the
    single-device case; a mesh or sharding ``rules`` raise."""
    if mesh is not None:
        _later_slice("a mesh")
    if rules is not None:
        _later_slice("sharding rules")
    params = {n: p.detach().to(torch.float32).clone()
              for n, p in model.named_parameters()}
    opt_state = {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                 "v": {n: torch.zeros_like(p) for n, p in params.items()},
                 "count": 0}
    meta = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                grad_clip=grad_clip)
    return params, opt_state, meta


def _adamw(params, grads, opt_state, lr, b1, b2, eps, wd, clip,
           step_fn=None, telemetry=None):
    """AdamW with global-norm clipping, the JAX package's math: grads
    scaled by min(1, clip / (gnorm + 1e-6)), bias-corrected moments, eps
    outside the square root, decoupled decay on parameters with
    ndim >= 2 only. Updates params and opt_state (moments and count) in
    place; returns (params, opt_state, gnorm) with gnorm a 0-dim float32
    tensor. On the card the update is kernel D (``ops.adamw``: two
    launches a step), on the CPU its plain version. ``telemetry`` =
    (spec, loss) also returns the packed vector of ``_pack_telemetry``'s
    layout, from the same two launches: (params, opt_state, gnorm,
    vec)."""
    names = list(params)
    ps = [params[n] for n in names]
    count = opt_state["count"] + 1
    kw = {}
    if telemetry is not None:
        spec, loss = telemetry
        group_of = {n: j for j, (_, ns) in enumerate(spec.groups)
                    for n in ns}
        kw = dict(groups=[group_of[n] for n in names], loss=loss)
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
                    telemetry_every=1, monitor=None):
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

    The JAX package's argument order: ``mesh`` None is the single-device
    case, a mesh raises. ``donate`` is accepted and does nothing: the eager
    step already updates the masters and moments in place, where the JAX
    step donates its input buffers."""
    if mesh is not None:
        _later_slice("a mesh")
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

    def step(params, opt_state, batch, eff_lr):
        """The step itself: (params, opt_state, loss, gnorm[, vec])."""
        was_training = model.training
        model.train()
        try:
            names = list(params)
            leaves = [params[n].detach().requires_grad_(True) for n in names]
            fwd = {n: (p.to(torch.bfloat16)
                       if bf16_compute and p.dim() >= 2 else p)
                   for n, p in zip(names, leaves)}
            _, loss = torch.func.functional_call(
                model, fwd, (batch["input_ids"],),
                {"labels": batch["labels"]})
            loss = loss.to(torch.float32)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            out = _adamw(params, dict(zip(names, grads)), opt_state, eff_lr,
                         b1, b2, eps, wd, clip,
                         telemetry=None if spec is None else (spec, loss))
            return out[:2] + (loss,) + out[2:]
        finally:
            if not was_training:
                model.eval()

    def run(params, opt_state, batch, lr_scale=None):
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
        t0 = time.monotonic()
        out = step(params, opt_state, batch, eff_lr)
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
    return run


def batch_to_device(batch, device="cuda"):
    """A host batch dict of integer arrays as int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64).to(dev)
            for k, v in batch.items()}
