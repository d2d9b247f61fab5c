"""The port's ``DataParallel`` and its bucketed reducer
(``paddle_tpu_torch.distributed.parallel``, ``fleet.reducer``) held
against the JAX package's ``DataParallel`` and ``EagerReducer``.

The JAX side is one program on the 8 virtual CPU devices of
``tests/conftest.py`` (``fleet.init`` dp 2 x mp 4, as its own tests run
it): the gradients of the loss over the whole batch. The port's side is 2
or 4 gloo thread ranks (``testing.run_thread_ranks``), each with its own
module loaded from the JAX module's weights and its own batch, the
gradients averaged over the ranks by the reducer. Tolerance: f32 rtol
1e-5 (the averaged sums run in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet.reducer import EagerReducer  # noqa
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
BATCH = 8


@pytest.fixture
def jhcg():
    s = jfleet.DistributedStrategy()
    s.hybrid_configs.update({"dp_degree": 2, "mp_degree": 4})
    return jfleet.init(is_collective=True, strategy=s)


class _Net(torch.nn.Module):
    """Linear(8, 16) -> tanh -> Linear(16, 4) with the JAX layers'
    [in, out] weights."""

    def __init__(self, arrays):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (
            torch.nn.Parameter(torch.tensor(a)) for a in arrays)

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _jax_net():
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    return net, [p.numpy().copy() for p in net.parameters()]


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 8)).astype(np.float32),
            rng.standard_normal((BATCH, 4)).astype(np.float32))


def _jax_grads(reduction):
    """The JAX DataParallel's gradients of the whole batch's loss."""
    net, arrays = _jax_net()
    x, y = _batch()
    dp = jdist.DataParallel(net)
    out = dp(paddle.to_tensor(x))
    diff = out - paddle.to_tensor(y)
    loss = (diff * diff).mean() if reduction == "mean" \
        else (diff * diff).sum()
    loss.backward()
    return arrays, [p.grad.numpy() for p in net.parameters()]


def _port_grads(arrays, world, reduction, split):
    """Each thread rank's averaged gradients: its rows of the batch
    (``split``) or the whole batch, the loss taken with ``reduction``."""
    x, y = _batch()

    def rank(r, group):
        tdist.init_parallel_env(group=group, device="cpu")
        net = _Net(arrays)
        dp = tdist.DataParallel(net)
        rows = slice(r * BATCH // world, (r + 1) * BATCH // world) \
            if split else slice(None)
        diff = dp(torch.tensor(x[rows])) - torch.tensor(y[rows])
        loss = (diff * diff).mean() if reduction == "mean" \
            else (diff * diff).sum()
        loss.backward()
        dp.cleanup()
        return [p.grad.numpy() for p in net.parameters()]
    return run_thread_ranks(world, rank)


def _close(got, want, rtol=RTOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_mean_loss_on_split_batches_matches_jax(jhcg, world):
    arrays, want = _jax_grads("mean")
    for grads in _port_grads(arrays, world, "mean", split=True):
        _close(grads, want)


@pytest.mark.parametrize("world", [2, 4])
def test_sum_loss_every_rank_whole_batch_matches_jax(jhcg, world):
    """The JAX tests' case: every rank holds the whole batch."""
    arrays, want = _jax_grads("sum")
    for grads in _port_grads(arrays, world, "sum", split=False):
        _close(grads, want)


def test_sum_loss_on_split_batches_is_the_jax_gradient_over_nranks(jhcg):
    """The contract the port keeps on purpose (ROADMAP Queue 3): the
    reducer averages over the ranks, as the reference's does, where the
    JAX package's single controller takes the gradient of the global
    loss. A sum loss over split batches gives 1 / nranks of it."""
    arrays, want = _jax_grads("sum")
    for world in (2, 4):
        for grads in _port_grads(arrays, world, "sum", split=True):
            _close(grads, [w / world for w in want])



@pytest.mark.parametrize("world", [2, 4])
def test_replicas_initialised_apart_start_from_rank_0(jhcg, world):
    """Each rank builds its module from other weights and buffer;
    DataParallel copies rank 0's to every rank, so the averaged gradients
    of the mean loss on split batches are the JAX ones of rank 0's
    weights."""
    arrays, want = _jax_grads("mean")
    x, y = _batch()

    def rank(r, group):
        tdist.init_parallel_env(group=group, device="cpu")
        net = _Net([a * (1 + r) for a in arrays])
        net.register_buffer("seen", torch.full((3,), float(r)))
        dp = tdist.DataParallel(net)
        rows = slice(r * BATCH // world, (r + 1) * BATCH // world)
        diff = dp(torch.tensor(x[rows])) - torch.tensor(y[rows])
        (diff * diff).mean().backward()
        dp.cleanup()
        return ([p.detach().numpy() for p in net.parameters()],
                net.seen.numpy(), [p.grad.numpy() for p in net.parameters()])
    for params, seen, grads in run_thread_ranks(world, rank):
        _close(params, arrays, rtol=0)
        np.testing.assert_array_equal(seen, np.zeros(3, np.float32))
        _close(grads, want)

# -- the reducer ---------------------------------------------------------

def _linear_weights(n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((16, 16)).astype(np.float32) * 0.3
            for _ in range(n)]


def test_bucket_count_matches_jax_and_one_call_a_bucket():
    """The JAX test's parameters and buffer: six [16, 16] f32 weights and
    2.5 KB, two weights a bucket, three buckets."""
    from paddle_tpu.distributed.fleet.reducer import EagerReducer as JRed
    from paddle_tpu.distributed.mesh import ProcessMesh
    jparams = [jnn.Linear(16, 16).weight for _ in range(6)]
    jred = JRed(jparams, mesh=ProcessMesh(np.arange(8), dim_names=["dp"]),
                axis="dp", comm_buffer_size_mb=2.5 / 1024)
    try:
        want_buckets = len(jred.buckets)
    finally:
        jred.remove()
    ws = _linear_weights(6)

    def rank(r, group):
        ps = [torch.nn.Parameter(torch.tensor(w)) for w in ws]
        red = EagerReducer(ps, group, comm_buffer_size_mb=2.5 / 1024)
        h = torch.ones(2, 16) * (r + 1)
        for p in ps:
            h = torch.tanh(h @ p)
        h.sum().backward()
        red.remove()
        return (len(red.buckets), red.stats["allreduce_calls"],
                red.stats["bytes"], [p.grad.numpy() for p in ps])
    out = run_thread_ranks(2, rank)
    assert want_buckets == 3
    for n_buckets, calls, nbytes, _ in out:
        assert (n_buckets, calls, nbytes) == (3, 3, 6 * 16 * 16 * 4)
    # every rank holds the average of the two ranks' gradients
    _close(out[0][3], out[1][3], rtol=0)


def test_first_bucket_dispatched_before_the_last_grads_arrive():
    ws = _linear_weights(4, seed=3)

    def rank(r, group):
        ps = [torch.nn.Parameter(torch.tensor(w)) for w in ws]
        red = EagerReducer(ps, group, comm_buffer_size_mb=2.5 / 1024)
        seen = {}
        # the reducer's hook runs first: at w1's (the third gradient to
        # arrive) bucket 0 (w3, w2) has been dispatched, bucket 1 not
        def snapshot(p):
            seen["w1"] = list(red.stats["events"])
        ps[1].register_post_accumulate_grad_hook(snapshot)
        h = torch.ones(2, 16)
        for p in ps:
            h = torch.tanh(h @ p)
        h.sum().backward()
        red.remove()
        return seen["w1"], list(red.stats["events"])
    for at_w1, events in run_thread_ranks(2, rank):
        assert at_w1 == [("allreduce", 0)]
        assert events == [("allreduce", 0), ("allreduce", 1)]


def test_no_sync_accumulates_then_reduces():
    """The JAX test: a no_sync backward, then synced ones: 2x, then 3x
    the first gradients, on every parameter."""
    net, arrays = _jax_net()

    def rank(r, group):
        tdist.init_parallel_env(group=group, device="cpu")
        model = _Net(arrays)
        dp = tdist.DataParallel(model)
        x = torch.ones(BATCH, 8)
        with dp.no_sync():
            dp(x).sum().backward()
        g1 = [p.grad.clone() for p in model.parameters()]
        dp(x).sum().backward()
        g2 = [p.grad.clone() for p in model.parameters()]
        dp(x).sum().backward()
        g3 = [p.grad.clone() for p in model.parameters()]
        dp.cleanup()
        return g1, g2, g3
    for g1, g2, g3 in run_thread_ranks(2, rank):
        for a, b, c in zip(g1, g2, g3):
            np.testing.assert_allclose(b.numpy(), 2 * a.numpy(), rtol=1e-5)
            np.testing.assert_allclose(c.numpy(), 3 * a.numpy(), rtol=1e-5)


def test_find_unused_parameters():
    """Unused parameters get the reduced gradient (zeros from the ranks
    that did not use them) and are listed; a parameter one rank used
    gets half that rank's gradient on both."""
    ws = _linear_weights(3, seed=4)

    def rank(r, group):
        ps = [torch.nn.Parameter(torch.tensor(w)) for w in ws]
        red = EagerReducer(ps, group, find_unused_parameters=True)
        h = torch.ones(2, 16) @ ps[0]
        if r == 0:
            h = h @ ps[1]           # only rank 0 uses w1; nobody uses w2
        h.sum().backward()
        red.remove()
        return red.stats["unused"], [None if p.grad is None else
                                     p.grad.numpy() for p in ps]
    (u0, g0), (u1, g1) = run_thread_ranks(2, rank)
    assert u0 == [2] and u1 == [1, 2]
    np.testing.assert_array_equal(g0[2], np.zeros((16, 16), np.float32))
    _close(g0, g1, rtol=0)
    x0 = torch.ones(2, 16) @ torch.tensor(ws[0])
    want_w1 = (x0.t() @ torch.ones(2, 16)).numpy() / 2
    np.testing.assert_allclose(g1[1], want_w1, rtol=1e-5)


def test_autograd_grad_leaves_grad_alone():
    ws = _linear_weights(2, seed=5)

    def rank(r, group):
        ps = [torch.nn.Parameter(torch.tensor(w)) for w in ws]
        red = EagerReducer(ps, group, find_unused_parameters=True)
        x = torch.ones(2, 16, requires_grad=True)
        (gx,) = torch.autograd.grad((x @ ps[0] @ ps[1]).sum(), [x])
        red.remove()
        return [p.grad for p in ps], red.stats["allreduce_calls"], gx
    for grads, calls, gx in run_thread_ranks(2, rank):
        assert grads == [None, None] and calls == 0
        assert gx.shape == (2, 16)


# -- the environment and fleet --------------------------------------------

def test_parallel_env_and_backend():
    def rank(r, group):
        env = tdist.init_parallel_env(group=group, device="cpu")
        out = (tdist.get_rank(), tdist.get_world_size(), env.rank,
               env.world_size, tdist.get_backend(), tdist.is_initialized())
        tdist.destroy_process_group()
        return out + (tdist.is_initialized(),)
    for r, got in enumerate(run_thread_ranks(2, rank)):
        assert got == (r, 2, r, 2, "gloo", True, False)
    assert tdist.is_available()


def test_fleet_distributed_model_is_data_parallel_at_dp_only(jhcg):
    """fleet.distributed_model with no model or pipe axis returns
    DataParallel over the data-parallel group, as the JAX package does;
    its gradients are the JAX DataParallel's of the mean loss."""
    _, want = _jax_grads("mean")
    s = jfleet.DistributedStrategy()
    s.hybrid_configs.update({"dp_degree": 8})
    jfleet.init(is_collective=True, strategy=s)
    jnet, arrays = _jax_net()
    assert isinstance(jfleet.distributed_model(jnet), jdist.DataParallel)
    x, y = _batch()

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"dp_degree": 2})
        fleet.init(is_collective=True, strategy=s, group=group,
                   device="cpu")
        model = fleet.distributed_model(_Net(arrays))
        assert isinstance(model, tdist.DataParallel)
        rows = slice(r * BATCH // 2, (r + 1) * BATCH // 2)
        diff = model(torch.tensor(x[rows])) - torch.tensor(y[rows])
        (diff * diff).mean().backward()
        model.cleanup()
        return [p.grad.numpy() for p in model._layers.parameters()]
    for grads in run_thread_ranks(2, rank):
        _close(grads, want)
