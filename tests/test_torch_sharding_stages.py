"""The port's ZeRO stages (``paddle_tpu_torch.distributed.fleet.sharding``
and ``distributed.sharding``) and ``HybridParallelClipGrad`` held against
the JAX package's ``DygraphShardingOptimizer`` / ``group_sharded_parallel``
on its ``hcg_sharding`` problem (``tests/test_distributed.py``:
Linear(16, 32) -> tanh -> Linear(32, 8), mse against a seeded target).

The JAX side runs on the 8 virtual CPU devices (dp 2 x sharding 4) with
the whole batch; the port's on 2 or 4 gloo thread ranks of a sharding
group, each on its rows of the batch with the mean loss, so the averaged
gradients are the JAX ones. An "uneven" problem (Linear(16, 30) ->
Linear(30, 8)) keeps tensors whose dim 0 the group does not divide whole
on every rank, as the JAX rule does. Tolerance: f32 rtol 1e-5 after 5
steps (averaged gradients summed in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed import sharding as tsharding  # noqa: E402
from paddle_tpu_torch.testing import ThreadRankSet, run_thread_ranks  # noqa: E402,E501

RTOL, ATOL = 1e-5, 1e-7
STEPS = 5
BATCH = 8
WIDTH = {"even": 32, "uneven": 30}
OPTS = {
    "adam": (jopt.Adam, topt.Adam, dict(learning_rate=0.05), None),
    "adamw_clip": (jopt.AdamW, topt.AdamW,
                   dict(learning_rate=0.05, weight_decay=0.1), 0.05),
    "lamb": (jopt.Lamb, topt.Lamb, dict(learning_rate=0.05), None),
}


@pytest.fixture
def hcg_sharding():
    s = jfleet.DistributedStrategy()
    s.hybrid_configs.update({"dp_degree": 2, "mp_degree": 1,
                             "sharding_degree": 4})
    return jfleet.init(is_collective=True, strategy=s)


class _Net(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (
            torch.nn.Parameter(torch.tensor(a)) for a in arrays)

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _problem(width):
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(16, width), jnn.Tanh(),
                         jnn.Linear(width, 8))
    rng = np.random.default_rng(0)
    x = rng.random((BATCH, 16), dtype=np.float32)
    y = rng.random((BATCH, 8), dtype=np.float32)
    return net, [p.numpy().copy() for p in net.parameters()], x, y


def _optimizer(side, name, params):
    jcls, tcls, kw, clip = OPTS[name]
    mod = paddle.nn if side == "jax" else tnn
    grad_clip = mod.ClipGradByGlobalNorm(clip) if clip else None
    cls = jcls if side == "jax" else tcls
    return cls(parameters=params, grad_clip=grad_clip, **kw)


def _jax_run(level, name, width):
    net, arrays, x, y = _problem(width)
    inner = _optimizer("jax", name, net.parameters())
    model, optim, _ = jfleet.group_sharded_parallel(net, inner, level)
    for _ in range(STEPS):
        JF.mse_loss(model(paddle.to_tensor(x)),
                    paddle.to_tensor(y)).backward()
        optim.step()
        optim.clear_grad()
    state = {k: (v.numpy() if hasattr(v, "numpy") else v)
             for k, v in inner.state_dict().items()}
    return arrays, x, y, [p.numpy() for p in net.parameters()], state


def _port_run(world, level, name, arrays, x, y, out_dir=None):
    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"sharding_degree": world})
        fleet.init(is_collective=True, strategy=s, group=group,
                   device="cpu")
        net = _Net(arrays)
        inner = _optimizer("torch", name, net.parameters())
        model, optim, _ = tsharding.group_sharded_parallel(net, inner, level)
        rows = slice(r * BATCH // world, (r + 1) * BATCH // world)
        for _ in range(STEPS):
            out = model(torch.tensor(x[rows]))
            torch.nn.functional.mse_loss(out, torch.tensor(
                y[rows])).backward()
            optim.step()
            optim.clear_grad()
        whole = model.state_dict() if level == "p_g_os" else \
            net.state_dict()
        params = [whole[k].numpy() for k in ("w1", "b1", "w2", "b2")]
        state_bytes = sum(t.numel() * t.element_size()
                          for st in inner._accumulators.values()
                          for t in st.values())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in net.parameters())
        state = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in optim.state_dict().items()}
        if out_dir is not None:
            tsharding.save_group_sharded_model(model, out_dir, optim)
        return params, state, state_bytes, param_bytes
    # one forward and backward at a rank's shapes on this thread first: the
    # CPU BLAS picks its small-matrix kernels at first use, and first uses
    # from every rank thread at once gave other sums in a few runs of ten
    # (Adam's 1 / eps gain then moves a parameter past rtol 1e-5); a
    # process a rank, as deployed, has no such race
    warm = _Net(arrays)
    rows = BATCH // world
    torch.nn.functional.mse_loss(warm(torch.tensor(x[:rows])),
                                 torch.tensor(y[:rows])).backward()
    return run_thread_ranks(world, rank)


def _close(got, want, rtol=RTOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("name", ["adam", "adamw_clip"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_stage_matches_jax(hcg_sharding, level, world, name):
    arrays, x, y, want, jstate = _jax_run(level, name, WIDTH["even"])
    whole_params = sum(a.size * 4 for a in arrays)
    for params, state, sbytes, pbytes in _port_run(world, level, name,
                                                   arrays, x, y):
        _close(params, want)
        # the state_dict is whole and equal to the JAX optimizer's
        assert sorted(state) == sorted(jstate)
        assert state["@step"] == jstate["@step"] == STEPS
        _close([state[k] for k in sorted(jstate) if k != "@step"],
               [jstate[k] for k in sorted(jstate) if k != "@step"])
        # every tensor splits here: a rank holds 1 / world of the moments
        assert sbytes == 2 * whole_params // world
        assert pbytes == (whole_params // world if level == "p_g_os"
                          else whole_params)



def test_meshes_on_fresh_stores_rendezvous():
    """fleet.init on 2 ranks, then on 4, each time over a new store: a
    new store may take a freed one's address, and its meshes must still
    start from the same prefix on every rank (keyed by the store's id,
    ranks 0-1 carried the 2-rank run's count and ranks 2-3 did not, and
    the 4 ranks waited on different keys until the timeout)."""
    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"sharding_degree": group.size()})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        return hcg.get_sharding_parallel_group().size()
    for _ in range(8):
        for world in (2, 4):
            assert ThreadRankSet(world, rank, timeout=10.0).join(40.0) == \
                {r: world for r in range(world)}

@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_uneven_tensors_stay_whole(hcg_sharding, level):
    """Linear(16, 30): b1 [30] and w2 [30, 8] do not split over 4 ranks
    and stay whole (and are updated) on every rank."""
    arrays, x, y, want, _ = _jax_run(level, "adamw_clip", WIDTH["uneven"])
    split = arrays[0].size + arrays[3].size
    whole = arrays[1].size + arrays[2].size
    for params, _, sbytes, pbytes in _port_run(4, level, "adamw_clip",
                                               arrays, x, y):
        _close(params, want)
        assert sbytes == 2 * 4 * (split // 4 + whole)
        if level == "p_g_os":
            assert pbytes == 4 * (split // 4 + whole)


def test_lamb_whole_tensor_norms_on_chunks(hcg_sharding):
    """Lamb's trust ratio needs the whole tensor's norms: the chunks'
    sums are all_reduced over the group."""
    arrays, x, y, want, _ = _jax_run("os", "lamb", WIDTH["even"])
    for params, *_ in _port_run(2, "os", "lamb", arrays, x, y):
        _close(params, want)


def test_stage_classes_and_save_reload(hcg_sharding, tmp_path):
    """DygraphShardingOptimizer and GroupShardedStage2 called directly
    equal group_sharded_parallel's levels; save_group_sharded_model of a
    stage-3 model loads into a plain module."""
    arrays, x, y, want, _ = _jax_run("p_g_os", "adam", WIDTH["even"])
    out = str(tmp_path / "ckpt")
    ranks = _port_run(2, "p_g_os", "adam", arrays, x, y, out_dir=out)
    plain = _Net([np.zeros_like(a) for a in arrays])
    plain.load_state_dict(torch.load(f"{out}/model.pdmodel"))
    _close([p.detach().numpy() for p in plain.parameters()], want)
    opt_state = torch.load(f"{out}/model.pdopt")
    assert opt_state["@step"] == STEPS
    assert tuple(opt_state["param_0.moment1"].shape) == arrays[0].shape
    _close([opt_state[k].numpy() for k in sorted(opt_state) if k != "@step"],
           [ranks[0][1][k] for k in sorted(opt_state) if k != "@step"],
           rtol=0)

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"sharding_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        got = []
        for wrap in (lambda o: fleet.DygraphShardingOptimizer(o, hcg),
                     lambda o: fleet.GroupShardedStage2(o, hcg)):
            net = _Net(arrays)
            optim = wrap(topt.Adam(learning_rate=0.05,
                                   parameters=net.parameters()))
            rows = slice(r * 4, (r + 1) * 4)
            for _ in range(STEPS):
                torch.nn.functional.mse_loss(net(torch.tensor(x[rows])),
                                             torch.tensor(y[rows])).backward()
                optim.step()
                optim.clear_grad()
            got.append([p.detach().numpy() for p in net.parameters()])
        return got
    for got in run_thread_ranks(2, rank):
        for params in got:
            _close(params, want)


def test_hybrid_clip_over_mp_equals_one_rank():
    """HybridParallelClipGrad over mp 2: a column-parallel weight (its
    shard on each rank) and a replicated bias count once each; the global
    norm and the clipped gradients equal one rank's clip of the whole
    tensors, through the clip object and through AdamW's kernel-D step
    (its plain route on the CPU)."""
    rng = np.random.default_rng(3)
    w, gw = (rng.standard_normal((8, 6)).astype(np.float32)
             for _ in range(2))
    b, gb = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    clip = 0.5
    ref_p = [torch.nn.Parameter(torch.tensor(w)),
             torch.nn.Parameter(torch.tensor(b))]
    ref_pairs = tnn.ClipGradByGlobalNorm(clip)(
        [(ref_p[0], torch.tensor(gw)), (ref_p[1], torch.tensor(gb))])
    ref_opt = topt.AdamW(learning_rate=0.01, parameters=ref_p,
                         grad_clip=tnn.ClipGradByGlobalNorm(clip))
    ref_p[0].grad, ref_p[1].grad = torch.tensor(gw), torch.tensor(gb)
    ref_opt.step()

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"mp_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        col = fleet.ColumnParallelLinear(8, 6, has_bias=False)
        col.weight.data.copy_(torch.tensor(w).chunk(2, 1)[r])
        bias = torch.nn.Parameter(torch.tensor(b))
        assert col.weight.is_distributed is True
        g_w = torch.tensor(gw).chunk(2, 1)[r].contiguous()
        hclip = fleet.HybridParallelClipGrad(tnn.ClipGradByGlobalNorm(clip),
                                             hcg)
        pairs = hclip([(col.weight, g_w), (bias, torch.tensor(gb))])
        opt = fleet.distributed_optimizer(topt.AdamW(
            learning_rate=0.01, parameters=[col.weight, bias],
            grad_clip=tnn.ClipGradByGlobalNorm(clip)))
        col.weight.grad, bias.grad = g_w.clone(), torch.tensor(gb)
        opt.step()
        return ([g.numpy() for _, g in pairs], float(opt._last_grad_norm),
                [col.weight.detach().numpy(), bias.detach().numpy()])
    want_gn = float(np.sqrt(np.sum(gw.astype(np.float64) ** 2)
                            + np.sum(gb.astype(np.float64) ** 2)))
    for r, (clipped, gn, params) in enumerate(run_thread_ranks(2, rank)):
        _close(clipped, [ref_pairs[0][1].chunk(2, 1)[r].numpy(),
                         ref_pairs[1][1].numpy()], rtol=1e-6)
        np.testing.assert_allclose(gn, want_gn, rtol=1e-6)
        np.testing.assert_allclose(gn, float(ref_opt._last_grad_norm),
                                   rtol=1e-6)
        _close(params, [ref_p[0].detach().chunk(2, 1)[r].numpy(),
                        ref_p[1].detach().numpy()], rtol=1e-6)
