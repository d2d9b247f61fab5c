"""Pipeline parallelism of the PyTorch port
(``paddle_tpu_torch.distributed.fleet.pipeline_parallel`` /
``pipeline_schedule``) held against the JAX package's pipeline on the 8
virtual CPU devices of ``tests/conftest.py``.

The port's ranks are threads over one gloo ``HashStore``
(``testing.run_thread_ranks``), each holding its stage; the JAX side is
one program over the mesh. Each JAX schedule runs once, in a module
fixture.

- Runners: ``pipeline_1f1b`` / ``pipeline_gpipe`` / ``pipeline_zero_bubble``
  / ``pipeline_interleaved`` on ``tests/test_pipeline.py``'s tanh stage,
  outputs and every stage parameter's gradient of sum(y ** 2) against
  JAX's runners, rtol 1e-5 / atol 1e-6 (f32; 8-wide dot products summed
  in another order).
- The fleet product path (``fleet.init`` -> ``distributed_model(
  LlamaForCausalLMPipe)`` -> ``distributed_optimizer`` -> ``train_batch``)
  on pp 2 x dp 2 x mp 2, the tiny Llama of ``TestFleetProductPath`` from
  the JAX model's initial weights: three losses within rtol 1e-5 of
  JAX's; the trained parameters after ``sync_to_model``: 99.9% of each
  tensor's elements within 1e-5 of its largest element and every element
  within PARAM_ATOL. The two frameworks sum gradients in another order
  (mp shards, micro-batches of other rows), which reaches an element of
  about 1e-7 of its tensor's scale; Adam divides each element by its
  running RMS plus eps, so an element whose gradient is near 0 carries
  that noise into the update with a gain up to 1 / eps (the worst
  element read on the CPU: 1.73e-6 at lr 1e-3, three steps, at most
  0.05% of a tensor's elements past 1e-5 of its scale; PARAM_ATOL is
  about 3x that). SGD and Momentum have no such gain (worst element
  3.7e-9): every element within 1e-6.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.fleet import pipeline_parallel as jpp  # noqa
from paddle_tpu.distributed.fleet import pipeline_schedule as jps  # noqa
from paddle_tpu.distributed.mesh import ProcessMesh as JMesh  # noqa: E402
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu.models.llama import LlamaForCausalLMPipe as JPipe  # noqa
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.distributed import collective  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import pipeline_parallel as tpp  # noqa
from paddle_tpu_torch.distributed.fleet import pipeline_schedule as tps  # noqa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLMPipe, llama_pipe_state_from_numpy,
    llama_pipe_state_to_numpy, llama_state_to_numpy)
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
BULK, PARAM_REL, PARAM_ATOL = 0.999, 1e-5, 5e-6
D = 8


# -- the runners ----------------------------------------------------------------

def _jax_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _port_stage(p, x):
    h = torch.tanh(F.linear(x, p["w1"]) + p["b1"])
    return F.linear(h, p["w2"]) + p["b2"]


def _stage_params(rng, n):
    return [{"w1": rng.standard_normal((D, D)).astype(np.float32) * 0.3,
             "b1": rng.standard_normal(D).astype(np.float32) * 0.1,
             "w2": rng.standard_normal((D, D)).astype(np.float32) * 0.3,
             "b2": rng.standard_normal(D).astype(np.float32) * 0.1}
            for _ in range(n)]


RUNNER_CASES = [("1F1B", 2, 1, 3), ("1F1B", 4, 1, 8), ("FThenB", 2, 1, 3),
                ("FThenB", 4, 1, 8), ("ZBH1", 2, 1, 3), ("ZBH1", 4, 1, 8),
                ("VPP", 2, 2, 4)]


def _jax_runner(kind, S, V, M):
    rng = np.random.default_rng(S * 100 + M * 10 + V)
    per = _stage_params(rng, S * V)
    micro = rng.standard_normal((M, 2, D)).astype(np.float32)
    mesh = JMesh(np.arange(S), dim_names=["pipe"])
    build = {"1F1B": jps.pipeline_1f1b, "FThenB": jps.pipeline_gpipe,
             "ZBH1": jps.pipeline_zero_bubble}
    run = jps.pipeline_interleaved(_jax_stage, mesh, v_chunks=V) \
        if kind == "VPP" else build[kind](_jax_stage, mesh)
    stacked = jps.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per])
    xs = jnp.asarray(micro)
    out = np.asarray(jax.jit(run)(stacked, xs))
    grads, dxs = jax.jit(jax.grad(lambda p, x: (run(p, x) ** 2).sum(),
                                  argnums=(0, 1)))(stacked, xs)
    return per, micro, out, {k: np.asarray(v) for k, v in grads.items()}, \
        np.asarray(dxs)


@pytest.fixture(scope="module")
def jax_runners():
    return {case: _jax_runner(*case) for case in RUNNER_CASES}


def _port_runner(kind, S, V, M, per, micro, timeout=30):
    def rank(r, group):
        mesh = tpre.make_mesh(S, pp=S, group=group, device="cpu")

        def leaf(p):
            return {k: torch.tensor(v, requires_grad=True)
                    for k, v in p.items()}
        if kind == "VPP":
            params = [leaf(per[c * S + r]) for c in range(V)]
            run = tps.pipeline_interleaved(_port_stage, mesh, V)
        else:
            params = leaf(per[r])
            run = {"1F1B": tps.pipeline_1f1b, "FThenB": tps.pipeline_gpipe,
                   "ZBH1": tps.pipeline_zero_bubble}[kind](_port_stage, mesh)
        res = run(params, torch.tensor(micro, requires_grad=True),
                  lambda y, m: (y ** 2).sum())
        chunks = params if kind == "VPP" else [params]
        grads = {(c * S + r, k): t.grad.numpy()
                 for c, p in enumerate(chunks) for k, t in p.items()}
        outs = [res.outputs[m].numpy() for m in sorted(res.outputs)]
        dxs = [res.input_grads[m].numpy() for m in sorted(res.input_grads)]
        return outs, grads, res.max_in_flight, dxs
    return run_thread_ranks(S, rank, timeout=timeout)


@pytest.mark.parametrize("case", RUNNER_CASES,
                         ids=[f"{k}-S{s}-V{v}-M{m}"
                              for k, s, v, m in RUNNER_CASES])
def test_runner_matches_jax(case, jax_runners):
    kind, S, V, M = case
    per, micro, jout, jgrads, jdx = jax_runners[case]
    ranks = _port_runner(kind, S, V, M, per, micro)
    np.testing.assert_allclose(np.stack(ranks[-1][0]), jout, rtol=RTOL,
                               atol=ATOL)
    # the first stage's input gradients (JAX's grad by the micro-batches)
    np.testing.assert_allclose(np.stack(ranks[0][3]), jdx, rtol=RTOL,
                               atol=ATOL)
    for outs, grads, _, _ in ranks:
        for (g, k), got in grads.items():
            np.testing.assert_allclose(got, jgrads[k][g], rtol=RTOL,
                                       atol=ATOL, err_msg=f"stage {g} {k}")
    # the memory bound: the most micro-batches (chunks) stashed at once
    assert [r[2] for r in ranks] == [tps.in_flight_bound(kind, S, M, d, V)
                                     for d in range(S)]


def test_orders_are_deadlock_free_and_meet_their_bounds():
    want = {("1F1B", 4, 8): [4, 3, 2, 1], ("FThenB", 4, 8): [8] * 4,
            ("ZBH1", 4, 8): [4] * 4, ("1F1B", 4, 2): [2, 2, 2, 1]}
    for (kind, S, M), bounds in want.items():
        assert [tps.in_flight_bound(kind, S, M, d) for d in range(S)] \
            == bounds
    assert [tps.in_flight_bound("VPP", 4, 8, d, 2) for d in range(4)] == \
        [11, 9, 7, 5]
    for kind in tps.SCHEDULES:
        for S in (1, 2, 3, 4):
            for M in range(1, 13):
                for V in ((2, 3) if kind == "VPP" else (1,)):
                    if kind == "VPP" and M % S:
                        continue
                    orders = tps.check_orders(kind, S, M, V)
                    for d, ops in enumerate(orders):
                        assert tps._max_alive(ops) == \
                            tps.in_flight_bound(kind, S, M, d, V)
                        # every micro-batch's F and B (and W) once
                        n = M * V * (3 if kind == "ZBH1" else 2)
                        assert len(ops) == len(set(ops)) == n
    # ZB-H1 keeps 1F1B's order of forwards and backwards
    for d in range(4):
        zb = [op for op in tps.schedule_ops("ZBH1", 4, 8, d) if op[0] != "W"]
        assert zb == tps.schedule_ops("1F1B", 4, 8, d)


# -- the topology ----------------------------------------------------------------

def test_hcg_pipe_axis_table():
    """pp 2 x dp 2 x mp 2 on 8 thread ranks: every getter's value on each
    rank, in the port mesh's (pp, dp, fsdp, sp, mp) order."""
    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"pp_degree": 2, "dp_degree": 2,
                                 "mp_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        return (hcg.get_stage_id(), hcg.get_pipe_parallel_rank(),
                hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank(),
                hcg.is_first_stage(), hcg.is_last_stage(),
                hcg.get_p2p_prev_rank(), hcg.get_p2p_next_rank(),
                hcg.get_rank_from_stage(0), hcg.get_rank_from_stage(1),
                hcg.get_pipe_parallel_group().size(),
                hcg.get_pipe_parallel_world_size(), hcg.get_global_rank())
    table = [
        (0, 0, 0, 0, True, False, 1, 1, 0, 4, 2, 2, 0),
        (0, 0, 0, 1, True, False, 1, 1, 1, 5, 2, 2, 1),
        (0, 0, 1, 0, True, False, 1, 1, 2, 6, 2, 2, 2),
        (0, 0, 1, 1, True, False, 1, 1, 3, 7, 2, 2, 3),
        (1, 1, 0, 0, False, True, 0, 0, 0, 4, 2, 2, 4),
        (1, 1, 0, 1, False, True, 0, 0, 1, 5, 2, 2, 5),
        (1, 1, 1, 0, False, True, 0, 0, 2, 6, 2, 2, 6),
        (1, 1, 1, 1, False, True, 0, 0, 3, 7, 2, 2, 7)]
    assert run_thread_ranks(8, rank, timeout=60) == table
    mesh = tpre.make_mesh(8, pp=2, dp=2, mp=2, device="cpu")
    assert mesh.shape == {"pp": 2, "dp": 2, "fsdp": 1, "sp": 1, "mp": 2}


def test_hcg_topology_in_paddle_order():
    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update({"pp_degree": 2, "dp_degree": 2,
                                 "mp_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        t = hcg.topology()
        return t.dim_names, t.shape, t.process_ids
    names, shape, ids = run_thread_ranks(8, rank, timeout=60)[0]
    assert names == ["data", "pipe", "sharding", "sep", "model"]
    assert shape == [2, 2, 1, 1, 2]
    grid = np.asarray(ids).reshape(shape)
    # (data d, pipe p, model m) holds the port's rank p*4 + d*2 + m: (data
    # 1, pipe 0) is world rank 2, where the JAX topology's arange puts 4
    for d in range(2):
        for p in range(2):
            for m in range(2):
                assert grid[d, p, 0, 0, m] == p * 4 + d * 2 + m


# -- the fleet product path --------------------------------------------------------

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=32, dtype="float32")
PP, DP, MP, MICRO, STEPS = 2, 2, 2, 4, 3
CLIP = 0.1      # below every step's grad norm: the clip scales each step
FID = dict(beta1=0.85, beta2=0.98, epsilon=1e-7, weight_decay=0.01)
PRODUCT_CASES = {
    "1f1b_adamw": ("1F1B", 1, "AdamW_fid"), "vpp": ("VPP", 2, "AdamW"),
    "zbh1": ("ZBH1", 1, "AdamW"), "fthenb": ("FThenB", 1, "AdamW"),
    "sgd": ("1F1B", 1, "SGD"), "momentum": ("1F1B", 1, "Momentum")}


def _batch():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 128, (8, 32)).astype(np.int32),
            rng.integers(0, 128, (8, 32)).astype(np.int32))


def _jax_opt(kind, params):
    if kind == "AdamW_fid":
        return paddle.optimizer.AdamW(
            learning_rate=1e-3, grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP),
            parameters=params, **FID)
    if kind == "SGD":
        return paddle.optimizer.SGD(learning_rate=1e-3, parameters=params)
    if kind == "Momentum":
        return paddle.optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                                         parameters=params)
    return paddle.optimizer.AdamW(learning_rate=1e-3, parameters=params)


def _port_opt(kind, model):
    params = model.named_parameters()
    if kind == "AdamW_fid":
        return topt.AdamW(learning_rate=1e-3,
                          grad_clip=tnn.ClipGradByGlobalNorm(CLIP),
                          parameters=params, **FID)
    if kind == "SGD":
        return topt.SGD(learning_rate=1e-3, parameters=params)
    if kind == "Momentum":
        return topt.Momentum(learning_rate=1e-3, momentum=0.9,
                             parameters=params)
    return topt.AdamW(learning_rate=1e-3, parameters=params)


def _strategy(mod, schedule, vpp, **extra):
    s = mod.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, dp_degree=DP, mp_degree=MP,
                            pp_degree=PP, pp_configs={
                                "accumulate_steps": MICRO,
                                "schedule_mode": schedule,
                                "vpp_degree": vpp})
    s.hybrid_configs.update(extra)
    return s


def _jax_product(schedule, vpp, opt):
    """TestFleetProductPath._run's path: the initial weights, three
    losses and the trained weights (after sync_to_model)."""
    paddle.seed(1234)
    jset_mesh(JMesh(jpre.make_mesh(8, dp=DP, fsdp=1, mp=MP, sp=1, pp=PP)))
    try:
        jfleet.init(is_collective=True,
                    strategy=_strategy(jfleet, schedule, vpp))
        model = JPipe(JConfig(**CFG), num_stages=PP)
        model.eval()
        init = {k: np.asarray(v.numpy()).copy()
                for k, v in model.state_dict().items()}
        dm = jfleet.distributed_model(model)
        o = jfleet.distributed_optimizer(_jax_opt(opt, model.parameters()))
        ids, lab = _batch()
        losses = [float(dm.train_batch((JTensor(ids), JTensor(lab)),
                                       o).numpy()) for _ in range(STEPS)]
        dm.state_dict()
        trained = {k: np.asarray(v.numpy()).copy()
                   for k, v in model.state_dict().items()}
        return init, losses, trained
    finally:
        jset_mesh(None)


@pytest.fixture(scope="module")
def jax_product():
    return {name: _jax_product(*case) for name, case in PRODUCT_CASES.items()}


def _port_product(schedule, vpp, opt, init, steps=STEPS, body=None):
    """Every rank's (losses, trained stage weights, comm, ...) of the
    port's product path on 8 thread ranks."""
    def rank(r, group):
        hcg = fleet.init(is_collective=True, group=group, device="cpu",
                         strategy=_strategy(fleet, schedule, vpp))
        model = LlamaForCausalLMPipe(LlamaConfig(**CFG), num_stages=PP)
        llama_pipe_state_from_numpy(init, model)
        dm = fleet.distributed_model(model)
        o = fleet.distributed_optimizer(_port_opt(opt, model))
        ids, lab = _batch()
        d = hcg.get_data_parallel_rank()
        rows = slice(d * 8 // DP, (d + 1) * 8 // DP)
        losses = []
        for _ in range(steps):
            losses.append(float(dm.train_batch((ids[rows], lab[rows]), o)))
        out = {"losses": losses, "stage": hcg.get_stage_id(),
               "trained": llama_pipe_state_to_numpy(dm),
               "comm": dict(dm.comm), "meta_comm": dict(dm.meta_comm),
               "in_flight": dm.max_in_flight, "model": model, "opt": o,
               "hcg": hcg}
        if body is not None:
            out.update(body(r, dm, o))
        return out
    return run_thread_ranks(8, rank, timeout=60)


def _check_params(trained, ref, sgd_like):
    for n, got in trained.items():
        d = np.abs(got - ref[n])
        if sgd_like:
            assert d.max() <= ATOL, (n, d.max())
            continue
        within = (d <= PARAM_REL * np.abs(ref[n]).max()).mean()
        assert within >= BULK and d.max() <= PARAM_ATOL, \
            (n, within, d.max())


@pytest.mark.parametrize("name", list(PRODUCT_CASES))
def test_fleet_product_path_matches_jax(name, jax_product):
    schedule, vpp, opt = PRODUCT_CASES[name]
    init, jlosses, jtrained = jax_product[name]
    ranks = _port_product(schedule, vpp, opt, init)
    stages = {0: set(), 1: set()}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=RTOL)
        _check_params(r["trained"], jtrained, opt in ("SGD", "Momentum"))
        stages[r["stage"]] |= set(r["trained"])
    # every parameter lives on exactly one stage, under the JAX names
    assert not stages[0] & stages[1]
    assert stages[0] | stages[1] == set(jtrained)
    assert "layers.0.embed_tokens.weight" in stages[0]
    assert "layers.5.lm_head.weight" in stages[1]


def test_product_path_comm_matches_the_closed_form(jax_product):
    """Each rank's collectives of a step (``dm.comm``) against
    ``pipeline_comm``: the packed (hidden, residual) carry, the loss over
    pp and dp, the label count, the gradients over dp, the clip over mp
    and pp, and the Megatron operators of the stage's modules."""
    init = jax_product["1f1b_adamw"][0]
    for r in _port_product("1F1B", 1, "AdamW_fid", init, steps=2):
        model = r["model"]
        grads = sum(p.numel() for p in model.parameters())
        want = tpp.pipeline_comm(
            "1F1B", PP, 1, MICRO, r["stage"], 2 * 32 * 64 * 4, dp=DP, mp=MP,
            grad_elems=grads, clip=True, plans=model._plans,
            split=model._split, tokens=32, hidden=64, act_bytes=4,
            compute_bytes=4)
        assert r["comm"] == want, (r["stage"], r["comm"], want)
        # the meta of the stage boundary went once, at the first step
        key = "send,pp" if r["stage"] == 0 else "recv,pp"
        assert r["meta_comm"] == {key: {"calls": 1, "bytes": 32 * 8}}
        assert r["in_flight"] == tps.in_flight_bound("1F1B", PP, MICRO,
                                                     r["stage"])


def test_optimizer_fidelity(jax_product):
    """The wrapped optimizer's betas, eps and weight decay train as JAX's
    (test_fleet_product_path_matches_jax[1f1b_adamw]); its moments are
    f32, and the clip is the global norm over pp x mp: the same on every
    rank, above CLIP, and the norm of the whole model's gradient."""
    init = jax_product["1f1b_adamw"][0]

    def body(r, dm, o):
        inner = o._inner
        st = [v for s in inner._accumulators.values() for v in s.values()]
        return {"gnorm": float(inner._last_grad_norm),
                "f32": all(t.dtype == torch.float32 for t in st),
                "hyper": (inner._beta1, inner._beta2, inner._epsilon,
                          inner._wd),
                "clip": type(inner._grad_clip).__name__}
    ranks = _port_product("1F1B", 1, "AdamW_fid", init, steps=1, body=body)
    norms = {r["gnorm"] for r in ranks}
    assert len(norms) == 1 and norms.pop() > CLIP
    assert all(r["f32"] and r["hyper"] == (0.85, 0.98, 1e-7, 0.01)
               and r["clip"] == "HybridParallelClipGrad" for r in ranks)
    # the whole model's gradient norm at the initial weights, on one rank
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    own = dict(model.named_parameters())
    from paddle_tpu_torch.models.llama import _causal_lm_name
    with torch.no_grad():
        for n, a in init.items():
            own[_causal_lm_name(n, CFG["num_hidden_layers"])].copy_(
                torch.from_numpy(a))
    ids, lab = _batch()
    _, loss = model(torch.tensor(ids, dtype=torch.int64),
                    labels=torch.tensor(lab, dtype=torch.int64))
    loss.backward()
    whole = float(torch.sqrt(sum(p.grad.double().square().sum()
                                 for p in model.parameters())))
    np.testing.assert_allclose(ranks[0]["gnorm"], whole, rtol=RTOL)


def test_grad_scaler_overflow_on_one_stage_skips_every_stage():
    """pp 2 on two thread ranks: a clean step, then an inf planted in
    stage 0's gradient: both stages skip the second step and halve the
    scale."""
    cfg = LlamaConfig(**dict(CFG, num_hidden_layers=2))

    def rank(r, group):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = dict(s.hybrid_configs, pp_degree=2, pp_configs={
            "accumulate_steps": 2})
        hcg = fleet.init(is_collective=True, strategy=s, group=group,
                         device="cpu")
        model = LlamaForCausalLMPipe(cfg, num_stages=2, seed=3)
        dm = fleet.distributed_model(model)
        o = fleet.distributed_optimizer(topt.SGD(
            learning_rate=0.1, parameters=model.parameters()))
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        ids, lab = _batch()
        plant = {"on": False}
        p0 = next(model.parameters())
        if hcg.get_stage_id() == 0:
            p0.register_hook(lambda g: g * float("inf") if plant["on"]
                             else g)
        l1 = float(dm.train_batch((ids[:4], lab[:4]), o, scaler=scaler))
        after1 = [p.detach().clone() for p in model.parameters()]
        scale1 = scaler._scale
        plant["on"] = True
        l2 = float(dm.train_batch((ids[:4], lab[:4]), o, scaler=scaler))
        same = all(torch.equal(a, p) for a, p in
                   zip(after1, model.parameters()))
        return l1, l2, same, scale1, scaler._scale
    out = run_thread_ranks(2, rank, timeout=60)
    for l1, l2, same, s1, s2 in out:
        assert np.isfinite(l1) and np.isfinite(l2)
        assert same and s1 == 1024.0 and s2 == 512.0
    assert out[0][:2] == out[1][:2]


def test_eval_forward_recompute_and_the_zero_bubble_wrapper():
    """pp 2 on two thread ranks: ``eval_batch`` gives the loss the first
    ``train_batch`` then trains from (the same on both stages),
    ``forward`` the last stage's logits of one model on one rank (None on
    the first stage); ``recompute`` trains to the same numbers; the
    zero-bubble wrapper runs ZB-H1 whatever the strategy names."""
    cfg = LlamaConfig(**dict(CFG, num_hidden_layers=2))
    whole = LlamaForCausalLM(cfg, device="cpu", seed=5)
    ids, lab = (t.astype(np.int64) for t in _batch())
    with torch.no_grad():
        logits = whole(torch.tensor(ids[:4])).numpy()

    def rank(r, group):
        out = []
        for recompute in (False, True):
            c = LlamaConfig(**dict(CFG, num_hidden_layers=2,
                                   recompute=recompute))
            s = _strategy(fleet, "1F1B", 1, dp_degree=1, mp_degree=1)
            hcg = fleet.init(is_collective=True, strategy=s, group=group,
                             device="cpu")
            m = LlamaForCausalLMPipe(c, num_stages=2)
            llama_pipe_state_from_numpy(dict(whole.named_parameters()), m)
            m.train()
            dm = fleet.distributed_model(m)
            ev = float(dm.eval_batch((ids[:4], lab[:4])))
            fw = dm(ids[:4])
            o = topt.SGD(learning_rate=0.1, parameters=m.parameters())
            tr = [float(dm.train_batch((ids[:4], lab[:4]), o))
                  for _ in range(2)]
            out.append((ev, None if fw is None else fw.numpy(), tr))
        zb = tpp.ZeroBubblePipelineParallel(m, hcg, s)
        return out, zb.schedule_mode, hcg.get_stage_id()
    for out, mode, stage in run_thread_ranks(2, rank, timeout=60):
        (ev, fw, tr), (ev_rc, fw_rc, tr_rc) = out
        assert mode == "ZBH1"
        assert ev == tr[0] and tr[1] < tr[0]
        np.testing.assert_allclose(tr_rc, tr, rtol=RTOL)
        if stage == 0:
            assert fw is None and fw_rc is None
        else:
            np.testing.assert_allclose(fw, logits, rtol=RTOL, atol=ATOL)


# -- pp = 1: the eager micro-batch loop ----------------------------------------------

class _Lin(torch.nn.Module):
    """A linear with a bias, the JAX [in, out] layout, on the port's
    ``F.linear`` (so that ``split_weight_grad`` splits it)."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(w))
        self.bias = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return F.linear(x, self.weight) + self.bias


def _eager_xy():
    rng = np.random.default_rng(7)
    x = np.tile(rng.standard_normal((4, 6)).astype(np.float32), (4, 1))
    y = np.tile(rng.standard_normal((4, 1)).astype(np.float32), (4, 1))
    return x, y


def _jax_eager(cls):
    paddle.seed(9)
    net = jpp.PipelineLayer(
        [paddle.nn.Linear(6, 16), paddle.nn.Tanh(), paddle.nn.Linear(16, 1)],
        num_stages=1, loss_fn=lambda o, t: ((o - t) ** 2).mean())
    init = [p.numpy().copy() for p in net.parameters()]
    pp = cls(net)
    pp.accumulate_steps = 4
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
    x, y = _eager_xy()
    loss = pp.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)), opt)
    return init, float(loss.numpy()), [p.numpy() for p in net.parameters()]


@pytest.mark.parametrize("zb", [False, True], ids=["standard",
                                                   "zero_bubble"])
def test_pp1_eager_micro_loop_matches_jax(zb):
    jcls = jpp.ZeroBubblePipelineParallel if zb else jpp.PipelineParallel
    tcls = tpp.ZeroBubblePipelineParallel if zb else tpp.PipelineParallel
    init, jloss, jparams = _jax_eager(jcls)
    net = tpp.PipelineLayer(
        [_Lin(init[0], init[1]), torch.nn.Tanh(), _Lin(init[2], init[3])],
        num_stages=1, loss_fn=lambda o, t: ((o - t) ** 2).mean())
    pp = tcls(net)
    pp.accumulate_steps = 4
    opt = topt.SGD(learning_rate=0.1, parameters=net.parameters())
    x, y = _eager_xy()
    loss = pp.train_batch((torch.tensor(x), torch.tensor(y)), opt)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    for got, ref in zip(net.parameters(), jparams):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL,
                                   atol=ATOL)


# -- ZB-H1's weight-gradient split ----------------------------------------------------

def _jax_mlp():
    paddle.seed(5)
    return paddle.nn.Sequential(paddle.nn.Linear(6, 16), paddle.nn.Tanh(),
                                paddle.nn.Linear(16, 6), paddle.nn.Tanh(),
                                paddle.nn.Linear(6, 1))


def test_split_weight_grad_matches_the_joint_path():
    """JAX's TestZeroBubble.test_split_weight_grad_matches_standard: the
    split defers one weight gradient a linear, the weights have none
    before the flush, and after it every gradient equals JAX's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    jnet = _jax_mlp()
    (jnet(paddle.to_tensor(x)) ** 2).mean().backward()
    ref = [p.grad.numpy() for p in jnet.parameters()]
    ps = [p.numpy() for p in jnet.parameters()]
    mods = [_Lin(ps[0], ps[1]), torch.nn.Tanh(), _Lin(ps[2], ps[3]),
            torch.nn.Tanh(), _Lin(ps[4], ps[5])]
    net = torch.nn.Sequential(*mods)
    tpp.WeightGradStore.clear()
    with tpp.split_weight_grad():
        (net(torch.tensor(x, requires_grad=True)) ** 2).mean().backward()
    assert tpp.WeightGradStore.size() == 3
    assert all(m.weight.grad is None and m.bias.grad is not None
               for m in mods[::2])
    tpp.WeightGradStore.flush()
    for got, want in zip(net.parameters(), ref):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6)


def test_split_weight_grad_derived_weight_and_root_hook():
    """A derived weight (a cast, a scaled copy) keeps the joint path and
    the leaf gets its gradient; a linear's output backwarded directly
    (the root) still leaves its weight gradient on the store."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    jw = paddle.to_tensor(w, stop_gradient=False)
    import paddle_tpu.nn.functional as JF
    JF.linear(paddle.to_tensor(x), jw.astype("float32") * 2.0).sum() \
        .backward()
    tw = torch.tensor(w, requires_grad=True)
    tpp.WeightGradStore.clear()
    with tpp.split_weight_grad():
        F.linear(torch.tensor(x, requires_grad=True),
                 tw.to(torch.float32) * 2.0).sum().backward()
    assert tpp.WeightGradStore.size() == 0
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=1e-5)

    g = np.ones((4, 2), np.float32)
    jw2 = paddle.to_tensor(w, stop_gradient=False)
    xj = paddle.to_tensor(x, stop_gradient=False)
    JF.linear(xj, jw2).backward(paddle.to_tensor(g))
    tw2 = torch.tensor(w, requires_grad=True)
    tpp.WeightGradStore.clear()
    with tpp.split_weight_grad():
        F.linear(torch.tensor(x, requires_grad=True), tw2).backward(
            torch.tensor(g))
    assert tpp.WeightGradStore.size() == 1 and tw2.grad is None
    tpp.WeightGradStore.flush()
    np.testing.assert_allclose(tw2.grad.numpy(), jw2.grad.numpy(),
                               rtol=1e-5)


# -- refusals ----------------------------------------------------------------------

def test_refusals_carry_the_jax_messages():
    from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
        LayerDesc, partition)
    lin = [torch.nn.Linear(4, 4), torch.nn.Linear(4, 8),
           torch.nn.Linear(4, 4)]
    with pytest.raises(ValueError, match="contiguous") as e:
        partition(lin, 2)
    with pytest.raises(ValueError, match="contiguous") as je:
        jpp.CompiledPipelineTrainer(
            jpp.PipelineLayer([paddle.nn.Linear(4, 4), paddle.nn.Linear(4, 8),
                               paddle.nn.Linear(4, 4)], num_stages=2),
            JMesh(jpre.make_mesh(8, dp=2, fsdp=1, mp=2, sp=1, pp=2)))
    assert str(e.value).split(";")[0] == str(je.value).split(";")[0]
    descs = [LayerDesc(torch.nn.Linear, 4, 4) for _ in range(3)]
    with pytest.raises(ValueError,
                       match=r"3 pipeline blocks do not divide into pp=2"):
        partition(descs, 2)
    assert tpp.PipelineLayer(descs, num_stages=3).segments == \
        [[0], [1], [2]]
    with pytest.raises(ValueError, match="schedule_mode must be one of"):
        tps.schedule_ops("GPipe", 2, 4, 0)
    with pytest.raises(ValueError, match="VPP schedule needs vpp_degree"):
        tps.schedule_ops("VPP", 2, 4, 0, 1)
    with pytest.raises(ValueError, match="multiple of pp=2"):
        tps.schedule_ops("VPP", 2, 3, 0, 2)

    def rank(r, group, cases=(("X", 1), ("VPP", 1))):
        errs = []
        for schedule, vpp in cases:
            s = _strategy(fleet, schedule, vpp, dp_degree=1, mp_degree=1,
                          sharding_degree=group.size() // 2)
            fleet.init(is_collective=True, strategy=s, group=group,
                       device="cpu")
            m = LlamaForCausalLMPipe(LlamaConfig(**dict(
                CFG, num_hidden_layers=2)), num_stages=2)
            try:
                fleet.distributed_model(m)
            except (ValueError, NotImplementedError) as e:
                errs.append(f"{type(e).__name__}: {e}")
        return errs
    errs = run_thread_ranks(2, rank, timeout=60)[0]
    assert "schedule_mode must be one of" in errs[0]
    assert "VPP schedule needs vpp_degree >= 2" in errs[1]
    errs = run_thread_ranks(4, lambda r, g: rank(r, g, (("1F1B", 1),)),
                            timeout=60)[0]
    assert errs[0].startswith("NotImplementedError") and \
        "Queue 1 item 9" in errs[0]

    def indivisible(r, group):
        fleet.init(is_collective=True, strategy=_strategy(
            fleet, "1F1B", 1, dp_degree=1, mp_degree=1), group=group,
            device="cpu")
        m = LlamaForCausalLMPipe(LlamaConfig(**dict(
            CFG, num_hidden_layers=2)), num_stages=2)
        dm = fleet.distributed_model(m)
        ids, lab = _batch()
        with pytest.raises(ValueError) as e:
            dm.train_batch((ids[:6], lab[:6]), topt.SGD(
                parameters=m.parameters()))
        return str(e.value)
    assert run_thread_ranks(2, indivisible, timeout=60)[0] == \
        "batch 6 not divisible by accumulate_steps=4"
    # the one-program pretrain step does not take the pipeline's axis
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")

    def step(r, group):
        mesh = tpre.make_mesh(2, pp=2, group=group, device="cpu")
        _, _, meta = tpre.make_train_state(model, mesh)
        with pytest.raises(NotImplementedError,
                           match="fleet.distributed_model"):
            tpre.make_train_step(model, mesh, meta)
        return mesh.groups["pp"].size()
    assert run_thread_ranks(2, step, timeout=60) == [2, 2]


# -- weights -------------------------------------------------------------------------

def test_pipe_weights_carried_across_and_back_bit_equal():
    cfg = LlamaConfig(**dict(CFG, num_hidden_layers=4))
    whole = LlamaForCausalLM(cfg, device="cpu", seed=11)
    causal = {n: v.copy() for n, v in llama_state_to_numpy(whole).items()}
    # from tensors (the smoke seeds the pipe so): a copy of its own, which
    # training updates in place without touching the source
    pipe = LlamaForCausalLMPipe(cfg, num_stages=2, device="cpu")
    llama_pipe_state_from_numpy(dict(whole.named_parameters()), pipe)
    with torch.no_grad():
        for p in pipe.parameters():
            p.add_(1.0)
    assert all(np.array_equal(v, causal[n]) for n, v in
               llama_state_to_numpy(whole).items())

    def rank(r, group):
        s = _strategy(fleet, "VPP", 2, dp_degree=1, mp_degree=2)
        fleet.init(is_collective=True, strategy=s, group=group,
                   device="cpu")
        pipe = LlamaForCausalLMPipe(cfg, num_stages=2)
        llama_pipe_state_from_numpy(causal, pipe)
        a = llama_pipe_state_to_numpy(pipe)
        b = llama_pipe_state_to_numpy(pipe, names="causal_lm")
        dm = fleet.distributed_model(pipe)        # cut to the mp shards
        c = llama_pipe_state_to_numpy(dm)
        llama_pipe_state_from_numpy(a, dm)         # pipe names, sharded
        d = llama_pipe_state_to_numpy(dm, names="causal_lm")
        return a, b, c, d, sorted(pipe.layers.keys())
    out = run_thread_ranks(4, rank, timeout=60)
    # VPP over 2 ranks x 2 chunks: rank d holds elements of global stages
    # d and d + 2 (one block each; the embedding with block 1 on stage 0,
    # the head with block 4 on stage 3)
    assert out[0][4] == ["0", "1", "3"] and out[2][4] == ["2", "4", "5"]
    seen = set()
    for a, b, c, d, _ in out:
        for n, v in b.items():
            assert np.array_equal(v, causal[n]) and np.array_equal(d[n], v)
        assert set(a) == set(c)
        assert all(np.array_equal(a[n], c[n]) for n in a)
        seen |= set(b)
    assert seen == set(causal)


# -- timeout -------------------------------------------------------------------------

def test_a_stage_that_never_sends_raises_within_the_group_timeout():
    def rank(r, group):
        mesh = tpre.make_mesh(2, pp=2, group=group, device="cpu")
        if r == 0:
            time.sleep(5.0)          # stage 0 is alive but never sends
            return None
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in _stage_params(np.random.default_rng(0), 1)[0]
             .items()}
        t0 = time.monotonic()
        try:
            tps.pipeline_1f1b(_port_stage, mesh)(p, torch.zeros(2, 2, D))
        except RuntimeError as e:
            return time.monotonic() - t0, str(e)
        return None
    _, (waited, msg) = run_thread_ranks(2, rank, timeout=2.0)
    assert "Timed out" in msg and 1.5 <= waited < 20, (waited, msg)
    assert collective.GLOO_STAGED == frozenset({"send", "recv"})
