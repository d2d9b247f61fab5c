"""The port's incubating optimizers (``paddle_tpu_torch.incubate.
optimizer``: LookAhead, ModelAverage, DistributedFusedLamb and the
functional BFGS / L-BFGS minimizers) held against the JAX package.

Both start from the same numpy weights and batches, made from a seed.
Parameters after each step at rtol 1e-5 (atol 1e-7) in f32; the
minimizers' convergence flags and objective-call counts exactly, their
positions, values and gradients at rtol 1e-5 (atol 1e-6), with stopping
tolerances above f32's noise floor at the minimum (below it the count
of line-search halvings follows the last bits of each framework's sums:
both then end at the same point, after other counts; in Rosenbrock's
valley the roundings grow, 1e-6 apart in the position after 11
L-BFGS iterations with a 3-pair history and 1e-3 after 27, so the
rolling-history case stops at 6).
DistributedFusedLamb on dp 2 runs two gloo thread ranks
(``testing.run_thread_ranks``) through ``fleet.init``, each with half of
the batch; the JAX side is one rank on the whole batch (the mean of the
halves' gradients is the whole batch's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
import paddle_tpu.incubate.optimizer as JO  # noqa: E402
from paddle_tpu.distributed.fleet import topology as jtopo  # noqa: E402
from paddle_tpu.incubate.optimizer import functional as JFn  # noqa: E402
import paddle_tpu_torch.incubate as tinc  # noqa: E402
import paddle_tpu_torch.incubate.optimizer as TO  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import topology as ttopo  # noqa
from paddle_tpu_torch.incubate.optimizer import functional as TFn  # noqa
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _one_rank():
    """No hybrid group on either side unless a test builds one."""
    before = jtopo.get_hcg()
    jtopo.set_hcg(None)
    ttopo.set_hcg(None)
    yield
    jtopo.set_hcg(before)
    ttopo.set_hcg(None)


class _Net(torch.nn.Module):
    """x @ w + b with Paddle's [in, out] weight."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(w))
        self.bias = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return x @ self.weight + self.bias


def _nets(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    jnet = jnn.Linear(6, 3)
    jnet.weight.set_value(w)
    jnet.bias.set_value(b)
    return jnet, _Net(w, b)


def _batches(n, rows=8, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, 6)).astype(np.float32),
             rng.standard_normal((rows, 3)).astype(np.float32))
            for _ in range(n)]


def _jax_loss(net, x, t):
    d = net(paddle.to_tensor(x)) - paddle.to_tensor(t)
    return (d * d).mean()


def _torch_loss(net, x, t):
    d = net(torch.tensor(x)) - torch.tensor(t)
    return (d * d).mean()


def _close_params(jnet, tnet):
    for (n, jp), tp in zip(jnet.named_parameters(), tnet.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _train(jnet, jopt, tnet, topt_, batches, check_each=True):
    for x, t in batches:
        _jax_loss(jnet, x, t).backward()
        jopt.step()
        jopt.clear_grad()
        _torch_loss(tnet, x, t).backward()
        topt_.step()
        topt_.clear_grad()
        if check_each:
            _close_params(jnet, tnet)


@pytest.mark.parametrize("alpha,k", [(0.5, 2), (0.2, 3)])
def test_lookahead_equals_jax(alpha, k):
    jnet, tnet = _nets()
    jopt = JO.LookAhead(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jnet.parameters()), alpha=alpha, k=k)
    topt_ = TO.LookAhead(topt.SGD(learning_rate=0.1,
                                  parameters=tnet.parameters()),
                         alpha=alpha, k=k)
    _train(jnet, jopt, tnet, topt_, _batches(7))
    assert tinc.LookAhead is TO.LookAhead


@pytest.mark.parametrize("window", [3, 100])
def test_model_average_equals_jax(window):
    jnet, tnet = _nets()
    jopt = JO.ModelAverage(paddle.optimizer.Momentum(
        learning_rate=0.05, parameters=jnet.parameters()),
        min_average_window=2, max_average_window=window)
    topt_ = TO.ModelAverage(topt.Momentum(
        learning_rate=0.05, parameters=tnet.parameters()),
        min_average_window=2, max_average_window=window)
    _train(jnet, jopt, tnet, topt_, _batches(5))
    jopt.apply()
    topt_.apply()
    _close_params(jnet, tnet)
    jopt.restore()
    topt_.restore()
    _close_params(jnet, tnet)
    assert tinc.ModelAverage is TO.ModelAverage


def test_model_average_over_parameters_alone():
    jnet, tnet = _nets()
    jopt = JO.ModelAverage(0.1, parameters=jnet.parameters(),
                           max_average_window=2)
    topt_ = TO.ModelAverage(0.1, parameters=tnet.parameters(),
                            max_average_window=2)
    for _ in range(3):
        jopt.step()
        topt_.step()
    jopt.apply()
    topt_.apply()
    _close_params(jnet, tnet)


def test_lbfgs_alias():
    assert TO.LBFGS is topt.LBFGS


@pytest.mark.parametrize("acc,clip_after", [(1, True), (2, True),
                                            (2, False)])
def test_distributed_fused_lamb_one_rank_equals_jax(acc, clip_after):
    jnet, tnet = _nets()
    jopt = JO.DistributedFusedLamb(
        learning_rate=0.05, parameters=jnet.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5),
        clip_after_allreduce=clip_after, gradient_accumulation_steps=acc)
    topt_ = TO.DistributedFusedLamb(
        learning_rate=0.05, parameters=tnet.parameters(),
        grad_clip=tnn.ClipGradByGlobalNorm(0.5),
        clip_after_allreduce=clip_after, gradient_accumulation_steps=acc)
    _train(jnet, jopt, tnet, topt_, _batches(6))


def test_distributed_fused_lamb_dp2_equals_jax_on_the_whole_batch():
    jnet, _ = _nets()
    w0 = [p.numpy().copy() for p in jnet.parameters()]
    jopt = JO.DistributedFusedLamb(learning_rate=0.05,
                                   parameters=jnet.parameters(),
                                   gradient_accumulation_steps=2)
    batches = _batches(4, rows=8)
    for x, t in batches:
        _jax_loss(jnet, x, t).backward()
        jopt.step()
        jopt.clear_grad()

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2}
        fleet.init(is_collective=True, strategy=s, group=group,
                   device="cpu")
        net = _Net(*w0)
        opt = TO.DistributedFusedLamb(learning_rate=0.05,
                                      parameters=net.parameters(),
                                      gradient_accumulation_steps=2)
        for x, t in batches:
            half = slice(4 * r, 4 * r + 4)
            _torch_loss(net, x[half], t[half]).backward()
            opt.step()
            opt.clear_grad()
        return [p.detach().numpy() for p in net.parameters()]

    for got in run_thread_ranks(2, rank):
        for g, jp in zip(got, jnet.parameters()):
            np.testing.assert_allclose(g, jp.numpy(), rtol=RTOL, atol=1e-6)


def _quadratic(lib, n=5, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    cv, wv = lib(c), lib(w)
    return (lambda x: (wv * (x - cv) ** 2).sum() + 0.1 * (x ** 4).sum()), \
        np.zeros(n, np.float32)


def _rosenbrock(lib, n=4):
    def f(x):
        a, b = x[1:], x[:-1]
        return (100.0 * (a - b * b) ** 2 + (1.0 - b) ** 2).sum()
    return f, np.full(n, -0.5, np.float32)


# stopping tolerances above f32's noise floor at the minimum, where
# whether an Armijo test passes is decided by the last bits of the two
# frameworks' sums (and each failed test costs another call)
TOL = {"tolerance_grad": 1e-3, "tolerance_change": 1e-6}
MINIMIZE_CASES = [
    (which, problem, kw) for which in ("bfgs", "lbfgs")
    for problem, kw in (("quadratic", TOL),
                        ("rosenbrock", dict(TOL, max_iters=60)),
                        ("rosenbrock", {"max_iters": 5}))
] + [("lbfgs", "quadratic", dict(TOL, history_size=2)),
     ("lbfgs", "rosenbrock", {"history_size": 3, "max_iters": 6})]


@pytest.mark.parametrize("which,problem,kw", MINIMIZE_CASES)
def test_minimizers_equal_jax(which, problem, kw):
    make = {"quadratic": _quadratic, "rosenbrock": _rosenbrock}[problem]
    jf, x0 = make(paddle.to_tensor)
    tf, _ = make(torch.tensor)
    jfn = JFn.minimize_bfgs if which == "bfgs" else JFn.minimize_lbfgs
    tfn = TFn.minimize_bfgs if which == "bfgs" else TFn.minimize_lbfgs
    jc, jn, jx, jv, jg = jfn(jf, paddle.to_tensor(x0), **kw)
    tc, tn, tx, tv, tg = tfn(tf, torch.tensor(x0), **kw)
    assert bool(tc) == bool(np.asarray(jc.numpy()))
    assert int(tn) == int(np.asarray(jn.numpy()))
    for got, ref in ((tx, jx), (tv, jv), (tg, jg)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=1e-6)


def test_minimize_bfgs_initial_inverse_hessian():
    jf, x0 = _quadratic(paddle.to_tensor)
    tf, _ = _quadratic(torch.tensor)
    h0 = np.eye(5, dtype=np.float32) * 0.5
    jc, jn, jx, _, _ = JFn.minimize_bfgs(
        jf, paddle.to_tensor(x0),
        initial_inverse_hessian_estimate=paddle.to_tensor(h0), **TOL)
    tc, tn, tx, _, _ = TFn.minimize_bfgs(
        tf, torch.tensor(x0), initial_inverse_hessian_estimate=h0, **TOL)
    assert bool(tc) == bool(np.asarray(jc.numpy()))
    assert int(tn) == int(np.asarray(jn.numpy()))
    np.testing.assert_allclose(tx.numpy(), jx.numpy(), rtol=RTOL, atol=1e-6)


def test_incubate_top_level_functions():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 6, 6)) < 0.3, -1e4, 0.0).astype(
        np.float32)
    import paddle_tpu.incubate as jinc
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse(torch.tensor(x), torch.tensor(mask)).numpy(),
        jinc.softmax_mask_fuse(paddle.to_tensor(x),
                               paddle.to_tensor(mask)).numpy(),
        rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        tinc.softmax_mask_fuse_upper_triangle(torch.tensor(x)).numpy(),
        jinc.softmax_mask_fuse_upper_triangle(paddle.to_tensor(x)).numpy(),
        rtol=RTOL, atol=1e-7)
    for red in ("none", "sum", "mean", 0, 1, 2):
        np.testing.assert_allclose(
            tinc.identity_loss(torch.tensor(x), red).numpy(),
            jinc.identity_loss(paddle.to_tensor(x), red).numpy(),
            rtol=RTOL)
