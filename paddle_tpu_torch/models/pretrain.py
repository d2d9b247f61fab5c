"""Single-device pretraining step for the PyTorch port (counterpart of
``paddle_tpu/models/pretrain.py``).

The JAX package jits one sharded program over a mesh; the port runs the
same step eagerly on one card: an AMP-O2 forward (parameters with
ndim >= 2 cast to bf16 when ``config.dtype`` is "bfloat16", so the
gradients land on the float32 masters), autograd, then AdamW with a
global-norm clip (kernel D of ``ops.adamw`` on the card: two launches a
step). The optimizer updates the masters and moments in place, where the
JAX package returns new arrays: one copy of each lives on the card.

Not ported in this slice (they raise ``NotImplementedError``): the mesh
and its sharding rules, in-graph telemetry / the health monitor, and
``lr_scale`` fault injection. ``shard_batch`` becomes ``batch_to_device``.
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
           step_fn=None):
    """AdamW with global-norm clipping, the JAX package's math: grads
    scaled by min(1, clip / (gnorm + 1e-6)), bias-corrected moments, eps
    outside the square root, decoupled decay on parameters with
    ndim >= 2 only. Updates params and opt_state (moments and count) in
    place; returns (params, opt_state, gnorm) with gnorm a 0-dim float32
    tensor. On the card the update is kernel D (``ops.adamw``: two
    launches a step), on the CPU its plain version."""
    names = list(params)
    ps = [params[n] for n in names]
    count = opt_state["count"] + 1
    gnorm = (step_fn or adamw.adamw_step)(
        ps, [grads[n] for n in names], [opt_state["m"][n] for n in names],
        [opt_state["v"][n] for n in names], [p.dim() >= 2 for p in ps], lr,
        b1, b2, eps, wd, clip, count)
    opt_state["count"] = count
    return params, opt_state, gnorm


def _adamw_plain(params, grads, opt_state, lr, b1, b2, eps, wd, clip):
    """``_adamw`` through the plain foreach passes on any device, kernel D's
    plain version (the tests' reference)."""
    return _adamw(params, grads, opt_state, lr, b1, b2, eps, wd, clip,
                  step_fn=adamw.adamw_step_plain)


def make_train_step(model, mesh, meta, donate=True, telemetry=False,
                    telemetry_every=1, monitor=None):
    """``run(params, opt_state, batch) -> (params, opt_state, loss,
    gnorm)``: one AMP-O2 training step of ``model`` on the params'
    device. ``batch`` = {input_ids: [B, S], labels: [B, S]} tensors
    (``batch_to_device``). loss and gnorm come back as 0-dim float32
    tensors without a host sync.

    Each call lands the train metrics of ``observability.instrument``:
    train_step_seconds, dispatch_seconds{program="pretrain_step"},
    train_steps_total, train_tokens_total and train_tokens_per_s. The
    step is eager, so its host wall covers the enqueue of every kernel;
    it reaches the device time once the launch queue backs up.

    The JAX package's argument order: ``mesh`` None is the single-device
    case, a mesh raises. ``donate`` is accepted and does nothing: the eager
    step already updates the masters and moments in place, where the JAX
    step donates its input buffers. ``telemetry_every`` only matters with
    ``telemetry``, which raises."""
    if mesh is not None:
        _later_slice("a mesh")
    if telemetry or monitor is not None:
        _later_slice("in-step telemetry and the health monitor")
    lr, (b1, b2) = meta["lr"], meta["betas"]
    eps, wd, clip = meta["eps"], meta["weight_decay"], meta["grad_clip"]
    bf16_compute = getattr(getattr(model, "config", None), "dtype",
                           None) == "bfloat16"

    def run(params, opt_state, batch, lr_scale=None):
        if lr_scale is not None:
            _later_slice("lr_scale")
        was_training = model.training
        model.train()
        try:
            ids = batch["input_ids"]
            tokens = ids.numel()
            t0 = time.monotonic()
            names = list(params)
            leaves = [params[n].detach().requires_grad_(True) for n in names]
            fwd = {n: (p.to(torch.bfloat16)
                       if bf16_compute and p.dim() >= 2 else p)
                   for n, p in zip(names, leaves)}
            _, loss = torch.func.functional_call(
                model, fwd, (ids,), {"labels": batch["labels"]})
            loss = loss.to(torch.float32)
            grads = torch.autograd.grad(loss, leaves)
            params, opt_state, gnorm = _adamw(
                params, dict(zip(names, grads)), opt_state, lr, b1, b2, eps,
                wd, clip)
            dur = time.monotonic() - t0
            _metrics.train_step_seconds().observe(dur)
            _metrics.dispatch_seconds().labels(
                program="pretrain_step").observe(dur)
            _metrics.train_steps_total().inc()
            if tokens:
                _metrics.train_tokens_total().inc(tokens)
                if dur > 0:
                    _metrics.train_tokens_per_s().set(tokens / dur)
            return params, opt_state, loss.detach(), gnorm
        finally:
            if not was_training:
                model.eval()

    return run


def batch_to_device(batch, device="cuda"):
    """A host batch dict of integer arrays as int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64).to(dev)
            for k, v in batch.items()}
