"""The eager training loop of the PyTorch port (``loss.backward()``,
``optimizer.AdamW`` with ``nn.ClipGradByGlobalNorm``, ``step``,
``clear_grad``) on the tiny Llama in f32, held against the JAX model
trained by ``paddle_tpu.optimizer.AdamW`` with the same clip, from the
same weights (``llama_state_from_numpy``) and batches; then the same
loop through ``fleet.distributed_model`` / ``distributed_optimizer`` at
dp 2 on gloo thread ranks, each rank on its half of the batch.

AdamW decays the matrices only (``apply_decay_param_fun`` by name; the
JAX parameters carry the same names), at the pretrain step's rate 3e-4.
Tolerance: the losses within rtol 1e-5; after 3 steps 99.9% of each
parameter tensor's elements within 1e-5 of its largest element, and
every element within ATOL (5e-6). The two frameworks reduce in another
order, so a gradient agrees to about 1e-7 of its tensor's largest
element; Adam divides each element by its running RMS plus eps (1e-8),
so where a gradient element is near 0 (embedding rows, cancelling sums)
that noise reaches the update with a gain up to 1 / eps. Measured on the
CPU: one element in three tensors past 1e-5 of the scale, by at most
1.9x; the worst element 1.48e-6 off (one rank) and 1.55e-6 (dp 2), so
ATOL is about 3x the worst reading."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models.llama import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.distributed import DataParallel  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig  # noqa: E402
from paddle_tpu_torch.models import llama_state_from_numpy  # noqa: E402
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

RTOL = 1e-5
BULK = 0.999
ATOL = 5e-6
STEPS, B, S, V = 3, 4, 16, 128
HYPER = dict(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
             weight_decay=0.1)
CLIP = 1.0


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (B, S)).astype(np.int64),
             rng.integers(0, V, (B, S)).astype(np.int64))
            for _ in range(STEPS)]


def _decay_fun(ndims):
    return lambda name: ndims[name] >= 2


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's weights before training, and its losses and
    parameters after the eager loop."""
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(dtype="float32"))
    named = list(jm.named_parameters())
    for n, p in named:
        p.name = n
    init = {n: p.numpy().copy() for n, p in named}
    ndims = {n: a.ndim for n, a in init.items()}
    opt = paddle.optimizer.AdamW(
        parameters=jm.parameters(), apply_decay_param_fun=_decay_fun(ndims),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP), **HYPER)
    losses = []
    for ids, labels in _batches():
        _, loss = jm(paddle.to_tensor(ids.astype(np.int32)),
                     labels=paddle.to_tensor(labels.astype(np.int32)))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return init, ndims, losses, {n: p.numpy() for n, p in named}


def _port_model(init):
    return llama_state_from_numpy(init, LlamaConfig.tiny(dtype="float32"),
                                  device="cpu")


def _port_optimizer(model, ndims):
    return topt.AdamW(parameters=model.named_parameters(),
                      apply_decay_param_fun=_decay_fun(ndims),
                      grad_clip=tnn.ClipGradByGlobalNorm(CLIP), **HYPER)


def _check(losses, params, jax_run):
    _, _, jlosses, jparams = jax_run
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert sorted(params) == sorted(jparams)
    for n in jparams:
        d = np.abs(params[n] - jparams[n])
        within = (d <= RTOL * np.abs(jparams[n]).max()).mean()
        assert within >= BULK and d.max() <= ATOL, \
            (n, within, d.max())


def test_eager_loop_matches_jax(jax_run):
    init, ndims, _, _ = jax_run
    model = _port_model(init)
    opt = _port_optimizer(model, ndims)
    losses = []
    for ids, labels in _batches():
        _, loss = model(torch.tensor(ids), labels=torch.tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        assert all(p.grad is None for p in model.parameters())
    # kernel D's step: the clip inside it, its grad norm kept
    assert opt._last_grad_norm is not None and opt._step_count == STEPS
    _check(losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}, jax_run)


def test_fleet_data_parallel_loop_matches_jax(jax_run):
    """dp 2: each rank's mean loss over its two rows (no ignored labels,
    so the mean of the ranks' means is the whole batch's), gradients
    averaged by DataParallel's reducer, the clip through
    HybridParallelClipGrad."""
    init, ndims, _, _ = jax_run

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"dp_degree": 2})
        fleet.init(is_collective=True, strategy=s, group=group,
                   device="cpu")
        inner = _port_model(init)
        model = fleet.distributed_model(inner)
        assert isinstance(model, DataParallel)
        opt = fleet.distributed_optimizer(_port_optimizer(inner, ndims))
        assert isinstance(opt._inner._grad_clip, fleet.HybridParallelClipGrad)
        losses = []
        for ids, labels in _batches():
            rows = slice(r * B // 2, (r + 1) * B // 2)
            _, loss = model(torch.tensor(ids[rows]),
                            labels=torch.tensor(labels[rows]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            whole = loss.detach().clone()
            torch.distributed.all_reduce(whole, group=group)
            losses.append(float(whole) / 2)
        model.cleanup()
        return losses, {n: p.detach().numpy()
                        for n, p in inner.named_parameters()}
    for losses, params in run_thread_ranks(2, rank):
        _check(losses, params, jax_run)
