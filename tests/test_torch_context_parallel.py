"""The port's context parallelism (``fleet.context_parallel``, the mesh's
sp axis, the collectives it rides on) held against the JAX package on
the 8 virtual CPU devices of ``tests/conftest.py``.

The port's ranks are threads over one gloo ``HashStore``
(``testing.run_thread_ranks``), each holding its contiguous block of the
sequence; the JAX side is one jitted ``shard_map`` over a mesh of the
same size. Both take the same numpy inputs, made from a seed.

Tolerances: ring and Ulysses outputs and q / k / v gradients rtol 1e-5
and atol 1e-6 of the tensor's largest element (at least 1) in f32
(readings: at most 2.4e-6 absolute, on gradients whose largest elements
are 2 to 6). The Llama step on dp2 x mp2 x sp2 against the JAX package's
context-parallel step: loss rtol 2e-5 and grad norm rtol 2e-4, the JAX
test's own bounds for its context-parallel step against its flash step
(readings 1e-7 and 1.5e-7: the port and the JAX package fold the same
blocks in the same order).
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed import ProcessMesh as JProcessMesh  # noqa: E402
from paddle_tpu.distributed.fleet import context_parallel as jcp  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu_torch.distributed import collective  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import context_parallel as tcp  # noqa
from paddle_tpu_torch.distributed.fleet import sharded  # noqa: E402
from paddle_tpu_torch.distributed.mesh import ProcessMesh, set_mesh  # noqa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.ops import work  # noqa: E402
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _inputs(p, s_loc, kvh, h=4, b=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    s = p * s_loc
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _jax(mode, p, causal, q, k, v, do):
    """The JAX package's attention over a p-device sep mesh and its
    q / k / v gradients for the upstream ``do``."""
    jm = JProcessMesh(np.arange(p), dim_names=["sep"]).jax_mesh
    if mode == "ring":
        fn = jcp._ring_jitted(jm, "sep", causal, None)
    else:
        fn = jcp._ulysses_jitted(jm, "sep", causal, None, p)
    out, vjp = jax.vjp(fn, *map(jax.numpy.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jax.numpy.asarray(do))]


def _port(mode, p, causal, q, k, v, do):
    """The port's attention on p thread ranks, each on its block: the
    gathered output and gradients, and each rank's collective tally."""
    s_loc = q.shape[1] // p
    fn = tcp.ring_attention if mode == "ring" else tcp.ulysses_attention

    def rank(r, group):
        mesh = tpre.make_mesh(p, sp=p, group=group, device="cpu")
        blk = slice(r * s_loc, (r + 1) * s_loc)
        ts = [torch.tensor(x[:, blk], requires_grad=True) for x in (q, k, v)]
        stats = {}
        out = fn(*ts, causal=causal, mesh=mesh, axis_name="sp", stats=stats)
        out.backward(torch.tensor(do[:, blk]))
        return out.detach().numpy(), [t.grad.numpy() for t in ts], stats
    got = run_thread_ranks(p, rank, timeout=30)
    out = np.concatenate([g[0] for g in got], 1)
    grads = [np.concatenate([g[1][i] for g in got], 1) for i in range(3)]
    return out, grads, [g[2] for g in got]


def _plain(p, causal, q, k, v, do):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tcp.ring_attention_plain(*ts, p, causal=causal)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want):
    """rtol 1e-5 and atol 1e-6 of the tensor's scale (its largest
    element, at least 1): f32 sums of the same terms in another order
    differ by a part of the terms' size, not of a result near 0."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


# (ring size, causal, kv heads of 4 query heads, block length)
CASES = [(2, True, 4, 12), (2, False, 2, 16), (4, True, 2, 12),
         (4, False, 1, 12), (4, True, 1, 16)]


@pytest.mark.parametrize("p,causal,kvh,s_loc", CASES)
def test_ring_matches_jax(p, causal, kvh, s_loc):
    q, k, v, do = _inputs(p, s_loc, kvh)
    want, wgrads = _jax("ring", p, causal, q, k, v, do)
    out, grads, stats = _port("ring", p, causal, q, k, v, do)
    _close(out, want)
    for g, w in zip(grads, wgrads):
        _close(g, w)
    # every rank: p - 1 hops forward, p backward (the last one home)
    for st in stats:
        assert st["send,sp"]["calls"] == st["recv,sp"]["calls"] == 2 * p - 1


@pytest.mark.parametrize("p,causal,kvh,s_loc", CASES)
def test_ring_plain_matches_the_autograd_route_and_jax(p, causal, kvh,
                                                       s_loc):
    """``ring_attention_plain`` (the JAX fold in torch, autograd) against
    the ring's autograd route on thread ranks and against the JAX
    package."""
    q, k, v, do = _inputs(p, s_loc, kvh, seed=1)
    pout, pgrads = _plain(p, causal, q, k, v, do)
    out, grads, _ = _port("ring", p, causal, q, k, v, do)
    want, wgrads = _jax("ring", p, causal, q, k, v, do)
    _close(out, pout)
    _close(pout, want)
    for g, pg, w in zip(grads, pgrads, wgrads):
        _close(g, pg)
        _close(pg, w)


@pytest.mark.parametrize("p,causal,kvh,s_loc", CASES)
def test_ulysses_matches_jax(p, causal, kvh, s_loc):
    q, k, v, do = _inputs(p, s_loc, kvh, seed=2)
    want, wgrads = _jax("ulysses", p, causal, q, k, v, do)
    out, grads, stats = _port("ulysses", p, causal, q, k, v, do)
    _close(out, want)
    for g, w in zip(grads, wgrads):
        _close(g, w)
    for st in stats:            # q, k, v, out forward; the four back
        assert st["all_to_all,sp"]["calls"] == 8


def test_ulysses_head_divisibility_check():
    q, k, v, _ = _inputs(4, 8, 2, h=2)
    with pytest.raises(ValueError, match="divisible"):
        jcp.ulysses_attention(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            mesh=JProcessMesh(np.arange(4), dim_names=["sep"]),
            axis_name="sep")
    mesh = tpre.make_mesh(4, sp=4, device="cpu")     # a layout: no group
    blk = [torch.tensor(x[:, :8]) for x in (q, k, v)]
    with pytest.raises(ValueError, match="divisible"):
        tcp.ulysses_attention(*blk, mesh=mesh, axis_name="sp")


def test_sep_axis_via_fleet():
    """fleet.init(dp 2 x sep 2): the sep group, its rank and the dp x sep
    group; ring_attention without a mesh takes the hybrid group's sep
    axis, and split_sequence cuts this rank's block."""
    p, s_loc = 2, 8
    q, k, v, _ = _inputs(p, s_loc, 2)
    want = tcp.ring_attention_plain(*map(torch.tensor, (q, k, v)), p)

    def rank(r, group):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs.update({"dp_degree": 2, "sep_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=strategy, group=group,
                         device="cpu")
        blocks = [tcp.split_sequence(torch.tensor(x)) for x in (q, k, v)]
        out = tcp.ring_attention(*blocks, causal=True)
        return (hcg.get_sep_parallel_world_size(),
                hcg.get_sep_parallel_group().size(),
                hcg.get_sep_parallel_rank(),
                hcg.get_dp_sep_parallel_group().size(),
                hcg.get_data_parallel_rank(), out.numpy())
    out = run_thread_ranks(4, rank, timeout=30)
    for r, (deg, size, sep_rank, dp_sep, dp_rank, o) in enumerate(out):
        assert (deg, size, dp_sep) == (2, 2, 4)
        assert (dp_rank, sep_rank) == divmod(r, 2)
        blk = slice(sep_rank * s_loc, (sep_rank + 1) * s_loc)
        _close(o, want[:, blk].numpy())


# -- the collectives ----------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_new_collectives_values_counts_and_bytes(world):
    calls0 = {f.__name__: f.calls for f in (
        collective.all_to_all, collective.all_to_all_single,
        collective.isend, collective.irecv, collective.batch_isend_irecv)}

    def rank(r, group):
        st = {}
        x = torch.arange(world * 3, dtype=torch.float32) + 100 * r
        y = torch.empty_like(x)
        collective.all_to_all_single(y, x, group=group, axis="sp", stats=st)
        z = torch.empty_like(x)
        collective.alltoall_single(z, x, group=group, axis="sp", stats=st)
        # uneven splits: rank r sends j + 1 elements to rank j
        xs = torch.full((sum(range(1, world + 1)),), float(r))
        ys = torch.empty(world * (r + 1))
        collective.all_to_all_single(
            ys, xs, in_split_sizes=[j + 1 for j in range(world)],
            out_split_sizes=[r + 1] * world, group=group)
        outs = []
        collective.all_to_all(outs, [torch.full((2,), 10.0 * r + j)
                                     for j in range(world)], group=group,
                              axis="sp", stats=st)
        # a ring shift by batch_isend_irecv, then send / recv back
        got = torch.empty(4)
        works = collective.batch_isend_irecv(
            [collective.P2POp(collective.isend, torch.full((4,), float(r)),
                              (r + 1) % world, group),
             collective.P2POp(collective.irecv, got, (r - 1) % world,
                              group)], axis="sp", stats=st)
        for w in works:
            w.wait()
        back = torch.empty(4)
        if r % 2 == 0:
            collective.send(got, (r - 1) % world, group=group, axis="sp",
                            stats=st)
            collective.recv(back, (r + 1) % world, group=group, axis="sp",
                            stats=st)
        else:
            collective.recv(back, (r + 1) % world, group=group, axis="sp",
                            stats=st)
            collective.send(got, (r - 1) % world, group=group, axis="sp",
                            stats=st)
        return (y.tolist(), z.tolist(), ys.tolist(),
                [o.tolist() for o in outs], got.tolist(), back.tolist(), st)
    out = run_thread_ranks(world, rank, timeout=30)
    for r, (y, z, ys, outs, got, back, st) in enumerate(out):
        want = [100.0 * s + 3 * r + i for s in range(world) for i in range(3)]
        assert y == z == want
        assert ys == [float(s) for s in range(world) for _ in range(r + 1)]
        assert outs == [[10.0 * s + r] * 2 for s in range(world)]
        assert got == [float((r - 1) % world)] * 4
        assert back == [float(r)] * 4
        nb = world * 3 * 4
        assert st == {"all_to_all,sp": {"calls": 3,
                                        "bytes": 2 * nb + world * 8},
                      "send,sp": {"calls": 2, "bytes": 32},
                      "recv,sp": {"calls": 2, "bytes": 32}}
    assert collective.all_to_all.calls - calls0["all_to_all"] == world
    # all_to_all runs on all_to_all_single: 3 calls of its own a rank
    assert collective.all_to_all_single.calls - \
        calls0["all_to_all_single"] == 4 * world
    assert collective.isend.calls - calls0["isend"] == 2 * world
    assert collective.irecv.calls - calls0["irecv"] == 2 * world
    assert collective.batch_isend_irecv.calls - \
        calls0["batch_isend_irecv"] == world


def test_a_peer_that_never_sends_raises_within_the_timeout():
    took = {}

    def rank(r, group):
        if r == 1:
            time.sleep(4)         # never sends, never joins the exchange
            return "absent"
        t0 = time.monotonic()
        try:
            collective.recv(torch.empty(3), 1, group=group)
        except RuntimeError:
            took["recv"] = time.monotonic() - t0
        t0 = time.monotonic()
        try:
            collective.all_to_all_single(torch.empty(4), torch.zeros(4),
                                         group=group)
        except RuntimeError:
            took["all_to_all"] = time.monotonic() - t0
        return "raised"
    out = run_thread_ranks(2, rank, timeout=1.5)
    assert out == ["raised", "absent"]
    assert set(took) == {"recv", "all_to_all"}
    assert max(took.values()) < 10


def test_p2p_op_takes_isend_or_irecv_only():
    with pytest.raises(ValueError, match="isend or irecv"):
        collective.P2POp(collective.send, torch.zeros(1), 0)


# -- the Llama step on dp2 x mp2 x sp2 ---------------------------------------

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, dtype="float32")
MESH = dict(dp=2, fsdp=1, mp=2, sp=2)


def _step_batches(n=2):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 128, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, 128, (4, 64)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_llama_cp_step_matches_jax(mode):
    batches = _step_batches()
    paddle.seed(123)
    jm = JLlama(JConfig(**BASE, context_parallel=True,
                        context_parallel_mode=mode))
    jmesh = jpre.make_mesh(8, **MESH)
    params, opt, meta = jpre.make_train_state(jm, jmesh)
    init = {k: np.asarray(v) for k, v in params.items()}
    step = jpre.make_train_step(jm, jmesh, meta)
    want = []
    for b in batches:
        params, opt, loss, gnorm = step(params, opt,
                                        jpre.shard_batch(dict(b), jmesh))
        want.append((float(loss), float(gnorm)))
    want = np.array(want)

    cfg = LlamaConfig(**BASE, context_parallel=True,
                      context_parallel_mode=mode)
    calls = {}
    orig = getattr(tcp, f"{mode}_attention")

    def counting(*a, **kw):
        name = threading.current_thread().name
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **kw)

    def rank(r, group):
        mesh = tpre.make_mesh(8, group=group, device="cpu", **MESH)
        model = LlamaForCausalLM(cfg, device="cpu")
        p, o, m = tpre.shard_state_from_numpy(init, mesh, config=cfg)
        run = tpre.make_train_step(model, mesh, m)
        hist = []
        for b in batches:
            p, o, loss, gnorm = run(p, o, tpre.shard_batch(b, mesh))
            hist.append((float(loss), float(gnorm)))
        return np.array(hist), dict(run.comm)
    setattr(tcp, f"{mode}_attention", counting)
    try:
        out = run_thread_ranks(8, rank, timeout=60)
    finally:
        setattr(tcp, f"{mode}_attention", orig)
    # the context-parallel branch ran once a layer a step on every rank
    assert sorted(calls.values()) == [2 * cfg.num_hidden_layers] * 8, calls
    for hist, _ in out:
        np.testing.assert_allclose(hist[:, 0], want[:, 0], rtol=2e-5)
        np.testing.assert_allclose(hist[:, 1], want[:, 1], rtol=2e-4)
    # one step's collectives (the last) equal the closed form
    tmesh = tpre.make_mesh(8, device="cpu", **MESH)
    shapes = {k: v.shape for k, v in init.items()}
    specs = {k: tpre.spec_for_param(k, s, tmesh,
                                    tpre.llama_sharding_rules())
             for k, s in shapes.items()}
    plans, split = sharded.plan_params(cfg, shapes, specs, tmesh.shape)
    comm = sharded.step_comm(
        plans, split, tmesh.shape, tokens_local=2 * 32, hidden=64,
        act_bytes=4, compute_bytes=4,
        cp=dict(mode=mode, layers=2, heads=2, kv_heads=1, head_dim=16))
    for _, got in out:
        assert got == comm
    # the label count, the loss and the gradients (every parameter
    # replicated over dp and sp, fsdp 1: one bucket) over dp x sp
    assert comm["all_reduce,dp_sp"]["calls"] == 2 + 1


def test_rope_takes_global_positions():
    """Each rank of a 2-rank ring holds a block of the sequence; its
    logits equal the whole sequence's at those positions only when RoPE
    rotates by the block's global positions (a restart at 0 on rank 1
    moves every one of its logits)."""
    cfg = LlamaConfig.tiny(dtype="float32", context_parallel=True)
    ids = np.random.default_rng(3).integers(0, 128, (2, 32))
    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    with torch.no_grad():
        whole = model(torch.as_tensor(ids)).numpy()
    state = {n: p.detach().clone() for n, p in model.named_parameters()}

    def rank(r, group):
        mesh = tpre.make_mesh(2, sp=2, group=group, device="cpu")
        m = LlamaForCausalLM(cfg, device="cpu")
        m.load_state_dict(state)
        blk = torch.as_tensor(ids[:, r * 16:(r + 1) * 16])
        set_mesh(ProcessMesh(mesh))
        try:
            with torch.no_grad():
                got = m(blk).numpy()
                restarted = m(blk, position_ids=torch.arange(16)).numpy()
        finally:
            set_mesh(None)
        return got, restarted
    out = run_thread_ranks(2, rank, timeout=30)
    for r, (got, restarted) in enumerate(out):
        np.testing.assert_allclose(got, whole[:, r * 16:(r + 1) * 16],
                                   rtol=1e-5, atol=1e-5)
    assert np.abs(out[1][1] - whole[:, 16:]).max() > 100 * 1e-5


def test_unknown_mode_raises():
    cfg = LlamaConfig(**dict(BASE, num_hidden_layers=1),
                      context_parallel=True, context_parallel_mode="Ulysses")
    model = LlamaForCausalLM(cfg, device="cpu")
    set_mesh(ProcessMesh(tpre.make_mesh(8, device="cpu", **MESH)))
    try:
        with pytest.raises(ValueError, match="context_parallel_mode"):
            model(torch.zeros((2, 8), dtype=torch.int64))
    finally:
        set_mesh(None)


def test_sp_mesh_needs_context_parallel_and_pipeline_still_refused():
    mesh = tpre.make_mesh(2, sp=2, device="cpu")
    assert mesh.shape["sp"] == 2
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")

    def rank(r, group):
        m = tpre.make_mesh(2, sp=2, group=group, device="cpu")
        _, _, meta = tpre.make_train_state(model, m)
        with pytest.raises(ValueError, match="context_parallel"):
            tpre.make_train_step(model, m, meta)
        return True
    assert run_thread_ranks(2, rank, timeout=30) == [True, True]
    # the pp axis builds now (tests/test_torch_pipeline.py); the pipeline
    # together with the sep axis still raises, naming its ROADMAP item
    assert tpre.make_mesh(4, pp=2, device="cpu").shape["pp"] == 2
    from paddle_tpu_torch.models import LlamaForCausalLMPipe

    def pipe(r, group):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs.update({"pp_degree": 2, "sep_degree": 2})
        hcg = fleet.init(is_collective=True, strategy=strategy, group=group,
                         device="cpu")
        m = LlamaForCausalLMPipe(LlamaConfig.tiny(dtype="float32"), 2)
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            fleet.distributed_model(m)
        return hcg.get_stage_id(), hcg.get_sep_parallel_rank()
    assert run_thread_ranks(4, pipe, timeout=30) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shard_batch_splits_rows_then_the_sequence():
    b = {"input_ids": np.arange(4 * 8).reshape(4, 8),
         "labels": np.arange(4 * 8).reshape(4, 8) + 100}

    def rank(r, group):
        mesh = tpre.make_mesh(8, group=group, device="cpu", **MESH)
        sb = tpre.shard_batch(b, mesh)
        return mesh.data_index, mesh.coords["sp"], sb["labels"].numpy()
    for idx, sp, part in run_thread_ranks(8, rank, timeout=30):
        np.testing.assert_array_equal(
            part, b["labels"][2 * idx:2 * idx + 2, 4 * sp:4 * sp + 4])


def test_segment_parallel_broadcasts_and_averages_over_sep():
    """SegmentParallel over fleet's sep axis (2 ranks): replicas drawn
    apart start from rank 0's weights, each rank's mean loss over its
    half of the sequence gives, averaged, the gradient of the whole
    sequence's mean loss on one rank. distributed_model at sep 2 is a
    DataParallel over the dp x sep group."""
    cfg = LlamaConfig.tiny(dtype="float32", context_parallel=True)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (2, 32))
    labels = rng.integers(0, 128, (2, 32))
    ref = LlamaForCausalLM(cfg, device="cpu", seed=0)
    _, loss = ref(torch.as_tensor(ids), labels=torch.as_tensor(labels))
    loss.backward()
    want = {n: p.grad.numpy() for n, p in ref.named_parameters()}

    def rank(r, group):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs.update({"sep_degree": 2})
        fleet.init(is_collective=True, strategy=strategy, group=group,
                   device="cpu")
        dm = fleet.distributed_model(LlamaForCausalLM(cfg, device="cpu"))
        dm_group = dm.group.size()
        dm.cleanup()
        model = fleet.SegmentParallel(
            LlamaForCausalLM(cfg, device="cpu", seed=r))
        # positional: SegmentParallel cuts positional tensors (the JAX
        # rule); keyword arguments pass whole
        _, loss = model(torch.as_tensor(ids), None, None,
                        torch.as_tensor(labels))
        loss.backward()
        return dm_group, {n: p.grad.numpy()
                          for n, p in model._layers.named_parameters()}
    out = run_thread_ranks(2, rank, timeout=30)
    for dm_group, grads in out:
        assert dm_group == 2
        for n in want:
            np.testing.assert_allclose(grads[n], want[n], rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_ring_flops_add_up_to_one_card():
    """The ring's counted flash launches (``ops.work.ring_flash``, the
    shapes each launch notes) add up over the ranks to one causal
    attention over the whole sequence, and each rank launches i + 1."""
    p, bh, s_loc, d = 4, 128, 512, 64
    per_rank = [work.ring_flash(p, i, bh, s_loc, d, True) for i in range(p)]
    assert [len(x) for x in per_rank] == [1, 2, 3, 4]
    fwd = sum(f[1] for blocks in per_rank for f, _ in blocks)
    bwd = sum(b[1] for blocks in per_rank for _, b in blocks)
    assert fwd == work.flash_fwd(bh, p * s_loc, p * s_loc, d, True)[1]
    assert bwd == work.flash_bwd(bh, p * s_loc, p * s_loc, d, True)[1]
    full = [work.ring_flash(p, i, bh, s_loc, d, False) for i in range(p)]
    assert sum(f[1] for blocks in full for f, _ in blocks) == \
        work.flash_fwd(bh, p * s_loc, p * s_loc, d, False)[1]


def test_ring_passes_without_autograd_equal_the_function():
    """``ring_attention_fwd`` / ``ring_attention_bwd`` (what thread ranks
    on one card call, the autograd engine running every thread's CUDA
    backward on one device thread) give the autograd route's bits."""
    p, s_loc = 2, 12
    q, k, v, do = _inputs(p, s_loc, 2, seed=4)
    _, want, _ = _port("ring", p, True, q, k, v, do)

    def rank(r, group):
        mesh = tpre.make_mesh(p, sp=p, group=group, device="cpu")
        blk = slice(r * s_loc, (r + 1) * s_loc)
        ts = [torch.tensor(x[:, blk]) for x in (q, k, v)]
        o, lse = tcp.ring_attention_fwd(*ts, mesh=mesh, axis_name="sp")
        assert lse.shape == (2 * 4, s_loc) and lse.dtype == torch.float32
        return [g.numpy() for g in tcp.ring_attention_bwd(
            *ts, o, lse, torch.tensor(do[:, blk]), mesh=mesh,
            axis_name="sp")]
    got = run_thread_ranks(p, rank, timeout=30)
    for i in range(3):
        np.testing.assert_array_equal(
            np.concatenate([g[i] for g in got], 1), want[i])


def test_p2p_seconds_run_from_dispatch_to_the_result():
    """A receive's watchdog task ends when its work's wait returns: the
    collective_seconds of "recv,sp" hold the wait for a late sender."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import comm_watchdog

    def seconds():
        fam = obs.get_registry().snapshot().get("collective_seconds", {})
        return fam.get("children", {}).get("recv,sp", {}).get("sum", 0.0)

    def rank(r, group):
        if r == 1:
            time.sleep(0.3)
            collective.send(torch.ones(2), 0, group=group)
            return 0.0
        before = seconds()
        collective.recv(torch.empty(2), 1, group=group, axis="sp")
        return seconds() - before
    comm_watchdog.enable_comm_watchdog(timeout=30, poll_interval=60)
    try:
        waited = run_thread_ranks(2, rank, timeout=30)[0]
    finally:
        comm_watchdog.disable_comm_watchdog()
    assert waited >= 0.25
