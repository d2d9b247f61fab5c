"""The port's main-grad mixed precision
(``distributed.fleet.utils.mix_precision_utils``) held against the JAX
package's classes on the CPU, and the port's ``GradScaler`` on sharded
gradients.

* ``MixPrecisionLayer``: after two backward passes of a bf16 model each
  parameter's f32 ``main_grad`` equals JAX's (the two bf16 gradients
  summed in f32; values exact up to the frameworks' bf16 rounding of the
  same products, MAIN_RTOL), and ``.grad`` still accumulates in bf16;
  ``MixPrecisionOptimizer`` then steps from ``main_grad`` (the parameters
  equal JAX's after the step) and clears it.
* ``GradScaler`` under ``group_sharded_parallel`` (ZeRO stages 1-3) on two
  gloo thread ranks, an ``inf`` planted in rank 1's gradient alone: the
  found-inf flag is all-reduced over the sharding group, so both ranks
  skip the step (parameters unchanged, scale halved) and then step
  together again; one host read a step on each rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.distributed.fleet.utils import (  # noqa: E402
    mix_precision_utils as jmp)
from paddle_tpu_torch import amp, optimizer  # noqa: E402
from paddle_tpu_torch.distributed.fleet.utils import (  # noqa: E402
    mix_precision_utils as tmp)
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

MAIN_RTOL = 2e-2    # bf16 gradients, rounded by each framework


class _Net(torch.nn.Module):
    """JAX's Linear(8, 16) -> tanh -> Linear(16, 4), paddle layouts."""

    def __init__(self, arrays, dtype=torch.float32):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (
            torch.nn.Parameter(torch.tensor(a).to(dtype)) for a in arrays)

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _jax_net():
    paddle.seed(1)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    return net, [p.numpy().copy() for p in net.parameters()]


def _batches():
    rng = np.random.default_rng(2)
    return [rng.standard_normal((6, 8)).astype(np.float32)
            for _ in range(2)]


def test_main_grad_accumulates_in_f32_like_jax():
    jnet, arrays = _jax_net()
    for p in jnet.parameters():
        p._data = p._data.astype("bfloat16")
    jlayer = jmp.MixPrecisionLayer(jnet, dtype="bfloat16")
    tnet = _Net(arrays, torch.bfloat16)
    tlayer = tmp.MixPrecisionLayer(tnet, dtype="bfloat16")
    for x in _batches():
        jlayer(paddle.to_tensor(x).astype("bfloat16")).astype(
            "float32").sum().backward()
        tlayer(torch.as_tensor(x).to(torch.bfloat16)).float().sum() \
            .backward()
    for jp, tp in zip(jnet.parameters(), tnet.parameters()):
        assert tp.main_grad.dtype == torch.float32
        assert tp.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(
            tp.main_grad.numpy(), np.asarray(jp.main_grad.data),
            rtol=MAIN_RTOL, atol=MAIN_RTOL * float(
                np.abs(np.asarray(jp.main_grad.data)).max()))
    assert [n for n, _ in tlayer.named_parameters()] == \
        ["w1", "b1", "w2", "b2"]
    assert set(tlayer.state_dict()) == {"w1", "b1", "w2", "b2"}


def test_main_grad_optimizer_steps_from_main_grad():
    jnet, arrays = _jax_net()
    jlayer = jmp.MixPrecisionLayer(jnet, dtype="float32")
    tnet = _Net(arrays)
    tlayer = tmp.MixPrecisionLayer(tnet, dtype="float32")
    jo = jmp.MixPrecisionOptimizer(jopt.SGD(learning_rate=0.1,
                                            parameters=jnet.parameters()))
    to = tmp.MixPrecisionOptimizer(optimizer.SGD(
        learning_rate=0.1, parameters=tnet.parameters()))
    for x in _batches():
        jlayer(paddle.to_tensor(x)).sum().backward()
        tlayer(torch.as_tensor(x)).sum().backward()
    # f32 end to end: main_grad is the summed gradient
    for tp in tnet.parameters():
        torch.testing.assert_close(tp.main_grad, tp.grad, rtol=0, atol=0)
        tp.grad.mul_(100.0)          # the step must not read .grad
    jo.step()
    to.step()
    for jp, tp in zip(jnet.parameters(), tnet.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert tp.main_grad is None
    to.clear_grad()
    assert all(p.grad is None and p.main_grad is None
               for p in tnet.parameters())
    assert to.get_lr() == 0.1        # the inner optimizer's surface


# -- GradScaler on sharded gradients -----------------------------------------------

LEVELS = ("os", "os_g", "p_g_os")
STEPS = 4          # clean, inf on rank 1 only, clean, clean


def _sharded_rank(level):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((8, 16), (16,), (16, 4), (4,))]
    x = rng.standard_normal((4, 8)).astype(np.float32)

    def rank_fn(rank, group):
        from paddle_tpu_torch.distributed import fleet, sharding
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"sharding_degree": 2})
        net = _Net(arrays)
        inner = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                incr_every_n_steps=2)
        model, opt, scaler = sharding.group_sharded_parallel(
            net, inner, level, scaler=scaler, group=group)
        assert scaler._group is group
        rows = torch.as_tensor(x[rank * 2:(rank + 1) * 2])
        out = []
        for step in range(STEPS):
            before = {n: p.detach().clone() for n, p in net.named_parameters()}
            loss = model(rows).pow(2).mean()
            scaler.scale(loss).backward()
            if step == 1 and rank == 1:
                # the inf lands in rank 1's own gradient alone
                next(iter(net.parameters())).grad.view(-1)[0] = float("inf")
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            same = all(torch.equal(before[n], p.detach())
                       for n, p in net.named_parameters())
            out.append((same, scaler._scale))
        whole = model.state_dict() if level == "p_g_os" else \
            {n: p.detach().clone() for n, p in net.named_parameters()}
        return out, scaler.host_reads, {n: t.clone() for n, t in whole.items()}
    return rank_fn


@pytest.mark.parametrize("level", LEVELS)
def test_scaler_skips_on_every_rank_when_one_rank_overflows(level):
    (r0, reads0, p0), (r1, reads1, p1) = run_thread_ranks(
        2, _sharded_rank(level))
    assert r0 == r1
    assert [same for same, _ in r0] == [False, True, False, False]
    assert [scale for _, scale in r0] == [2.0 ** 10, 2.0 ** 9, 2.0 ** 9,
                                          2.0 ** 10]
    assert reads0 == reads1 == STEPS
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
