"""fleet's tensor-parallel surface of the PyTorch port
(``paddle_tpu_torch.distributed.fleet``: ``init``,
``HybridCommunicateGroup``, the mp and sequence-parallel layers and
``ParallelCrossEntropy`` on kernel C's vocab-sharded form) held against
the JAX package's ``fleet`` on the 8 virtual CPU devices of
``tests/conftest.py``.

Both sides run ``fleet.init`` with dp 2 x mp 4. The JAX side is one
program over the mesh; the port's is eight thread ranks over one gloo
``HashStore`` (``testing.run_thread_ranks``), each with its own layers,
loaded from the JAX layers' whole numpy weights
(``mp_layers.shard_state_from_numpy``) and fed the same seeded inputs.
Gradients are taken of the sum of the output times a seeded cotangent.

Tolerances: f32 rtol 1e-5 / atol 1e-6 everywhere. The cross entropy's
sum of exps is a per-shard sum rescaled by exp(m_r - M) on the port and
one sum of exp(x - M) in JAX: the two differ by a few f32 roundings, far
inside it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu.distributed import Replicate, Shard  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.fleet import sp_layers as jsp  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import mp_layers  # noqa: E402
from paddle_tpu_torch.distributed.fleet import sp_layers  # noqa: E402
from paddle_tpu_torch.ops import token_ce as tc  # noqa: E402
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

DP, MP, WORLD = 2, 4, 8
RTOL, ATOL = 1e-5, 1e-6


def _strategy(mod, **degrees):
    s = mod.DistributedStrategy()
    s.hybrid_configs.update(degrees or {"dp_degree": DP, "mp_degree": MP})
    return s


@pytest.fixture
def jhcg():
    return jfleet.init(is_collective=True, strategy=_strategy(jfleet))


def _ranks(body, world=WORLD, **degrees):
    """``body(rank, hcg)`` on every thread rank after the port's
    ``fleet.init`` (dp 2 x mp 4 unless ``degrees``)."""
    def rank(r, group):
        hcg = fleet.init(is_collective=True, group=group, device="cpu",
                         strategy=_strategy(fleet, **degrees))
        return body(r, hcg)
    return run_thread_ranks(world, rank, timeout=60)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _whole(shards, dim):
    """The whole array from the mp ranks' shards of one dp row."""
    return np.concatenate(shards, axis=dim)


# -- the topology ----------------------------------------------------------

def test_hybrid_group_degrees_and_ranks(jhcg):
    def body(r, hcg):
        return {
            "degrees": (hcg.get_data_parallel_world_size(),
                        hcg.get_model_parallel_world_size(),
                        hcg.get_pipe_parallel_world_size(),
                        hcg.get_sharding_parallel_world_size(),
                        hcg.get_sep_parallel_world_size()),
            "ranks": (hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank(),
                      hcg.get_pipe_parallel_rank(), hcg.get_stage_id(),
                      hcg.get_sharding_parallel_rank(),
                      hcg.get_sep_parallel_rank(), hcg.get_global_rank()),
            "src": hcg.get_model_parallel_group_src_rank(),
            "sizes": (hcg.get_model_parallel_group().size(),
                      hcg.get_data_parallel_group().size(),
                      hcg.get_pipe_parallel_group().size()),
            "topology": (hcg.topology().shape, hcg.topology().dim_names),
            "same": fleet.get_hybrid_communicate_group() is hcg,
        }
    out = _ranks(body)
    jdeg = (jhcg.get_data_parallel_world_size(),
            jhcg.get_model_parallel_world_size(),
            jhcg.get_pipe_parallel_world_size(),
            jhcg.get_sharding_parallel_world_size(),
            jhcg.get_sep_parallel_world_size())
    assert jdeg == (DP, MP, 1, 1, 1)
    jtopo = jhcg.topology()
    for r, got in enumerate(out):
        dp, mp = divmod(r, MP)
        assert got["degrees"] == jdeg
        assert got["ranks"] == (dp, mp, 0, 0, 0, 0, r)
        assert got["src"] == dp * MP
        assert got["sizes"] == (MP, DP, 1)
        assert got["topology"] == (list(jtopo.shape), list(jtopo.dim_names))
        assert got["same"]
    # the JAX package is one controller: its ranks are rank 0's
    assert out[0]["ranks"][:6] == (
        jhcg.get_data_parallel_rank(), jhcg.get_model_parallel_rank(),
        jhcg.get_pipe_parallel_rank(), jhcg.get_stage_id(),
        jhcg.get_sharding_parallel_rank(), jhcg.get_sep_parallel_rank())
    assert out[0]["src"] == jhcg.get_model_parallel_group_src_rank()


# -- the mp layers ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["parallel", "gathered"])
def test_column_row_pair_matches_jax(jhcg, mode):
    """Column -> Row with biases: ``gather_output=False`` into
    ``input_is_parallel=True`` (the Megatron pair), and
    ``gather_output=True`` into a row layer that splits its input."""
    parallel = mode == "parallel"
    paddle.seed(0)
    col = jfleet.ColumnParallelLinear(16, 32, gather_output=not parallel)
    row = jfleet.RowParallelLinear(32, 16, input_is_parallel=parallel)
    rng = np.random.default_rng(1)
    for p in (col.bias, row.bias):
        p.set_value(paddle.to_tensor(
            rng.standard_normal(p.shape).astype(np.float32)))
    x = rng.standard_normal((4, 16)).astype(np.float32)
    ct = rng.standard_normal((4, 16)).astype(np.float32)
    xj = paddle.to_tensor(x, stop_gradient=False)
    out = row(col(xj))
    (out * paddle.to_tensor(ct)).sum().backward()
    want = {"out": out.numpy(), "x": xj.grad.numpy(),
            "cw": col.weight.grad.numpy(), "cb": col.bias.grad.numpy(),
            "rw": row.weight.grad.numpy(), "rb": row.bias.grad.numpy()}
    weights = {"col": {"weight": col.weight.numpy(),
                       "bias": col.bias.numpy()},
               "row": {"weight": row.weight.numpy(),
                       "bias": row.bias.numpy()}}

    def body(r, hcg):
        c = fleet.ColumnParallelLinear(16, 32, gather_output=not parallel)
        w = fleet.RowParallelLinear(32, 16, input_is_parallel=parallel)
        model = fleet.distributed_model(torch.nn.Sequential(c, w))
        assert isinstance(model, fleet.TensorParallel)
        mp_layers.shard_state_from_numpy(c, weights["col"])
        mp_layers.shard_state_from_numpy(w, weights["row"])
        xt = _t(x, grad=True)
        y = model(xt)
        (y * _t(ct)).sum().backward()
        return {"out": y.detach().numpy(), "x": xt.grad.numpy(),
                "cw": c.weight.grad.numpy(), "cb": c.bias.grad.numpy(),
                "rw": w.weight.grad.numpy(), "rb": w.bias.grad.numpy(),
                "shapes": (tuple(c.weight.shape), tuple(w.weight.shape))}
    out = _ranks(body)
    for r, got in enumerate(out):
        assert got["shapes"] == ((16, 32 // MP), (32 // MP, 16))
        for k in ("out", "x", "rb"):
            _close(got[k], want[k])
    for dp in range(DP):
        row_ranks = out[dp * MP:(dp + 1) * MP]
        _close(_whole([g["cw"] for g in row_ranks], 1), want["cw"])
        _close(_whole([g["cb"] for g in row_ranks], 0), want["cb"])
        _close(_whole([g["rw"] for g in row_ranks], 0), want["rw"])


def test_vocab_parallel_embedding_matches_jax(jhcg):
    paddle.seed(3)
    emb = jfleet.VocabParallelEmbedding(32, 8)
    ids = np.array([[0, 7, 8, 15], [16, 23, 24, 31], [5, 5, 30, 9]])
    ct = np.random.default_rng(2).standard_normal((3, 4, 8)).astype(
        np.float32)
    out = emb(paddle.to_tensor(ids))
    (out * paddle.to_tensor(ct)).sum().backward()
    want, wgrad = out.numpy(), emb.weight.grad.numpy()
    table = emb.weight.numpy()

    def body(r, hcg):
        e = mp_layers.shard_state_from_numpy(
            fleet.VocabParallelEmbedding(32, 8), {"weight": table})
        y = e(torch.as_tensor(ids))
        (y * _t(ct)).sum().backward()
        return y.detach().numpy(), e.weight.grad.numpy(), e.start
    out = _ranks(body)
    for r, (y, _, start) in enumerate(out):
        _close(y, want)
        assert start == (r % MP) * (32 // MP)
    _close(_whole([g for _, g, _ in out[:MP]], 0), wgrad)


def _ce_inputs(n=12, v=32, seed=4):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((n, v))).astype(np.float32)
    k = v // MP
    # every shard edge: start - 1, start, start + V_r - 1, and ignored rows
    lab = np.array([0, k - 1, k, 2 * k - 1, 2 * k, 3 * k - 1, 3 * k, v - 1,
                    -100, 5, -100, 2 * k + 1])[:n]
    ct = rng.standard_normal(n).astype(np.float32)
    return x, lab, ct


def test_parallel_cross_entropy_matches_jax(jhcg):
    x, lab, ct = _ce_inputs()
    pce = jfleet.ParallelCrossEntropy()
    xj = paddle.to_tensor(x, stop_gradient=False)
    lsh = jdist.shard_tensor(xj, jhcg.mesh, [Replicate()] * 4 + [Shard(1)])
    loss = pce(lsh, paddle.to_tensor(lab))
    (loss * paddle.to_tensor(ct)).sum().backward()
    want, wgrad = loss.numpy(), xj.grad.numpy()
    assert np.all(want[lab == -100] == 0)

    def body(r, hcg):
        k = x.shape[1] // MP
        mp = r % MP
        xs = _t(x[:, mp * k:(mp + 1) * k], grad=True)
        got = fleet.ParallelCrossEntropy()(xs, torch.as_tensor(lab))
        (got * _t(ct)).sum().backward()
        with pytest.raises(NotImplementedError, match="label smoothing"):
            fleet.parallel_cross_entropy(xs, torch.as_tensor(lab),
                                         mp_layers.model_region(),
                                         label_smoothing=0.1)
        return got.detach().numpy(), xs.grad.numpy()
    out = _ranks(body)
    for got, _ in out:
        _close(got, want)
    _close(_whole([g for _, g in out[:MP]], 1), wgrad)
    assert np.all(wgrad[lab == -100] == 0)


def test_sharded_ce_plain_combines_to_the_whole_rows():
    """token_ce_fwd_partial_plain on each of 4 shards, combined over a
    gloo group, equals token_ce_fwd_plain on the whole rows; the
    backward's plain version with the combined stats and the shard's
    offset gives the whole dx's columns."""
    x, lab, _ = _ce_inputs(v=40, seed=6)
    xt, lt = torch.as_tensor(x), torch.as_tensor(lab)
    loss, stats, totals = tc.token_ce_fwd_plain(xt, lt, -100, 0.0)
    g = torch.as_tensor(np.linspace(0.5, 1.5, len(lab)).astype(np.float32))
    dx = tc.token_ce_bwd_plain(xt, lt, stats, g, totals, -100, 0.0, "none")

    def body(r, hcg):
        region = mp_layers.model_region()
        k = 40 // MP
        xs = xt[:, r * k:(r + 1) * k]
        part = tc.token_ce_fwd_partial(xs, lt, r * k)
        got, st = tc.combine_partials(part, lt, r * k, k, -100,
                                      lambda t: region.all_reduce(t, "max"),
                                      region.all_reduce)
        dxs = tc.token_ce_bwd(xs, lt, st, g, None, -100, 0.0, "none",
                              start=r * k)
        return got.numpy(), st.numpy(), dxs.numpy()
    out = _ranks(body, world=MP, mp_degree=MP)
    for got, st, _ in out:
        _close(got, loss.numpy())
        _close(st, stats.numpy())
    _close(_whole([d for _, _, d in out], 1), dx.numpy())


# -- sequence parallel --------------------------------------------------------

def test_sequence_parallel_round_trip_and_pair_match_jax(jhcg):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    paddle.seed(1)
    col = jfleet.ColumnSequenceParallelLinear(16, 32, has_bias=False)
    row = jfleet.RowSequenceParallelLinear(32, 16, has_bias=False)
    xj = paddle.to_tensor(x)
    g = jsp.all_gather_sequence(jsp.scatter(xj), axis=0)
    np.testing.assert_array_equal(g.numpy(), x)
    out = jsp.all_gather_sequence(row(col(jsp.scatter(xj))), axis=0)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    (out * paddle.to_tensor(ct)).sum().backward()
    want = {"out": out.numpy(), "cw": col.weight.grad.numpy(),
            "rw": row.weight.grad.numpy()}
    weights = (col.weight.numpy(), row.weight.numpy())

    def body(r, hcg):
        c = mp_layers.shard_state_from_numpy(
            fleet.ColumnSequenceParallelLinear(16, 32, has_bias=False),
            {"weight": weights[0]})
        w = mp_layers.shard_state_from_numpy(
            fleet.RowSequenceParallelLinear(32, 16, has_bias=False),
            {"weight": weights[1]})
        xt = torch.as_tensor(x)
        trip = sp_layers.gather(sp_layers.scatter(xt), axis=0)
        y = sp_layers.all_gather_sequence(w(c(sp_layers.scatter(xt))),
                                          axis=0)
        # each rank holds the whole y: its loss term is 1/MP of the sum
        (y * _t(ct)).sum().div(MP).backward()
        return {"trip": trip.numpy(), "out": y.detach().numpy(),
                "cw": c.weight.grad.numpy(), "rw": w.weight.grad.numpy()}
    out = _ranks(body)
    for got in out:
        np.testing.assert_array_equal(got["trip"], x)
        _close(got["out"], want["out"])
    row0 = out[:MP]
    _close(_whole([g["cw"] for g in row0], 1), want["cw"])
    _close(_whole([g["rw"] for g in row0], 0), want["rw"])


def test_row_sequence_parallel_bias_gradient_sums_over_the_model_axis():
    """The row layer adds its whole bias to this rank's S / mp rows: its
    gradient is the sum over every row, on every rank."""
    ct = np.random.default_rng(8).standard_normal((8, 6)).astype(np.float32)

    def body(r, hcg):
        w = fleet.RowSequenceParallelLinear(8, 6)
        assert w.bias.is_sequence_parallel
        x = torch.ones(8, 8 // MP)
        y = w(x)
        k = 8 // MP
        (y * _t(ct[(r % MP) * k:(r % MP + 1) * k])).sum().backward()
        return w.bias.grad.numpy()
    for got in _ranks(body):
        _close(got, ct.sum(0))


# -- refusals ------------------------------------------------------------------

def test_refusals(jhcg):
    # the sep axis is taken (tests/test_torch_context_parallel.py), and
    # the pipeline axis now too (tests/test_torch_pipeline.py):
    # distributed_model gives the pipeline wrapper there
    def pp_only(r, hcg):
        from paddle_tpu_torch.models import (LlamaConfig,
                                             LlamaForCausalLMPipe)
        m = LlamaForCausalLMPipe(LlamaConfig.tiny(dtype="float32"), 2)
        return (hcg.get_pipe_parallel_world_size(), hcg.get_stage_id(),
                type(fleet.distributed_model(m)).__name__)
    assert _ranks(pp_only, world=2, pp_degree=2) == \
        [(2, 0, "PipelineParallel"), (2, 1, "PipelineParallel")]
    with pytest.raises(ValueError):
        jfleet.VocabParallelEmbedding(30, 8)

    def body(r, hcg):
        errors = []
        for make in (lambda: fleet.VocabParallelEmbedding(30, 8),
                     lambda: fleet.ColumnParallelLinear(16, 30),
                     lambda: fleet.RowParallelLinear(30, 16)):
            try:
                make()
            except ValueError as e:
                errors.append("does not split evenly" in str(e))
        return errors
    assert _ranks(body) == [[True] * 3] * WORLD

    # data parallelism alone and the optimizer wrapper are ported: no
    # longer refused
    def dp_only(r, hcg):
        from paddle_tpu_torch.distributed import DataParallel
        from paddle_tpu_torch.optimizer import SGD
        net = torch.nn.Linear(2, 2)
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(SGD(parameters=net.parameters()))
        model.cleanup()
        return (isinstance(model, DataParallel)
                and isinstance(opt, fleet.HybridParallelOptimizer))
    assert all(_ranks(dp_only, world=2, dp_degree=2))
