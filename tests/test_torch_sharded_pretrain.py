"""The port's sharded pretraining mesh (dp x fsdp x mp on torch.distributed)
held against the JAX package's sharded step on the 8 virtual CPU devices
of ``tests/conftest.py``.

The port's ranks are eight threads over one gloo ``HashStore``
(``testing.run_thread_ranks``), each with its own model instance; the JAX
step is one jitted program over ``make_mesh(8, ...)``. Both start from
the JAX model's numpy weights and take the same numpy batches.

Tolerances: losses and grad norms rtol 1e-5; the gathered masters after
three steps atol 1e-5, and the packed telemetry vector rtol 1e-5, each
widened at an element by four times the JAX package's own spread there:
the difference between its one-device step and its mesh step on the
same inputs (``_spread``). AdamW's first steps move a weight by about
lr * sign(g), so a weight whose gradient sums to nearly 0 over the
tokens (a cancellation) moves by an amount that depends on the order of
the sum: at one embedding element of the fused case the JAX one-device
and mesh steps are 4.1e-5 apart, the port 1.3e-4 from the JAX mesh
step. The widening is held to at most 0.1% of the elements.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu.jit.functional import state_arrays  # noqa: E402
from paddle_tpu_torch.distributed import collective  # noqa: E402
from paddle_tpu_torch.distributed.fleet import sharded  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.testing import run_thread_ranks  # noqa: E402

MESHES = {"dp2-fsdp2-mp2": dict(dp=2, fsdp=2, mp=2),
          "dp4-fsdp2": dict(dp=4, fsdp=2),
          "mp8": dict(mp=8)}
FUSED = dict(fuse_attention_qkv=True, fuse_attention_ffn=True)


def _batches(n=3, rows=8, seq=16, vocab=128, seed=0, ignore=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
             "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}
        if ignore:      # each data rank keeps another number of labels
            b["labels"][0:2, :] = -100
            b["labels"][3, 5:] = -100
            b["labels"][6, :11] = -100
        out.append(b)
    return out


def _jax_model(cfg_kw):
    paddle.seed(21)
    return JLlama(JConfig.tiny(dtype="float32", **cfg_kw))


_RUNS = {}     # the tests' shared runs, by their arguments


def _key(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.shape, str(x.dtype), hashlib.sha1(x.tobytes()).hexdigest()
    return repr(x)


def _cached(fn):
    def run(*args, **kw):
        key = (fn.__name__, _key(args), _key(kw))
        if key not in _RUNS:
            _RUNS[key] = fn(*args, **kw)
        return _RUNS[key]
    return run


@_cached
def _jax_run(cfg_kw, n, mesh_kw, batches, telemetry=False):
    """Losses, grad norms, final masters (and packed telemetry vectors)
    of the JAX sharded step; the initial numpy weights."""
    jm = _jax_model(cfg_kw)
    mesh = jpre.make_mesh(n, **mesh_kw)
    params, opt, meta = jpre.make_train_state(jm, mesh)
    init = {k: np.asarray(v) for k, v in params.items()}
    step = jpre.make_train_step(jm, mesh, meta, telemetry=telemetry)
    hist, vecs = [], []
    for b in batches:
        sb = jpre.shard_batch(b, mesh)
        if telemetry:
            with mesh:
                params, opt, loss, gnorm, vec = step._jitted(params, opt, sb)
            vecs.append(np.asarray(vec))
        else:
            params, opt, loss, gnorm = step(params, opt, sb)
        hist.append((float(loss), float(gnorm)))
    return init, np.array(hist), {k: np.asarray(v)
                                  for k, v in params.items()}, vecs


def _spread(one, mesh):
    """4 x |one-device - mesh| of the JAX reference, per element."""
    return 4.0 * np.abs(np.asarray(one) - np.asarray(mesh))


def _close(got, want, spread, atol=0.0, rtol=0.0, what=""):
    """|got - want| <= atol + rtol |want| + spread, the spread-widened
    bound needed at no more than 0.1% of the elements."""
    got, want = np.asarray(got), np.asarray(want)
    base = atol + rtol * np.abs(want)
    err = np.abs(got - want)
    assert np.all(err <= base + spread), \
        f"{what}: max excess {np.max(err - base - spread)}"
    assert np.count_nonzero(err > base) <= max(1, want.size // 1000), what


@_cached
def _port_run(cfg_kw, n, mesh_kw, init, batches, telemetry=False,
              timeout=60, **extra):
    """Every rank's (history, gathered masters, telemetry vectors, the
    last step's collectives) of the port's mesh step from ``init``."""
    cfg = LlamaConfig.tiny(dtype="float32", **dict(cfg_kw, **extra))

    def rank(r, group):
        mesh = tpre.make_mesh(n, group=group, device="cpu", **mesh_kw)
        model = LlamaForCausalLM(cfg, device="cpu")
        params, opt, meta = tpre.shard_state_from_numpy(init, mesh,
                                                        config=cfg)
        step = tpre.make_train_step(model, mesh, meta, telemetry=telemetry)
        hist, vecs = [], []
        for b in batches:
            sb = tpre.shard_batch(b, mesh)
            if telemetry:
                params, opt, loss, gnorm, vec = step._step(params, opt, sb,
                                                           meta["lr"])
                vecs.append(vec.numpy())
            else:
                params, opt, loss, gnorm = step(params, opt, sb)
            hist.append((float(loss), float(gnorm)))
        return (np.array(hist), tpre.gather_state_to_numpy(params, mesh,
                                                           meta),
                vecs, dict(step.comm))
    return run_thread_ranks(n, rank, timeout=timeout)


# -- placement -------------------------------------------------------------

def _jax_shapes(model):
    params, _ = state_arrays(model)
    return {k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_spec_parity_llama(mesh_name, fused):
    jmesh = jpre.make_mesh(8, **MESHES[mesh_name])
    tmesh = tpre.make_mesh(8, device="cpu", **MESHES[mesh_name])
    shapes = _jax_shapes(_jax_model(FUSED if fused else {}))
    port_names = dict(LlamaForCausalLM(LlamaConfig.tiny(
        **(FUSED if fused else {})), device="cpu").named_parameters())
    assert set(port_names) == set(shapes)
    for n, s in shapes.items():
        want = tuple(jpre.spec_for_param(n, s, jmesh,
                                         jpre.llama_sharding_rules()))
        got = tpre.spec_for_param(n, s, tmesh, tpre.llama_sharding_rules())
        want += (None,) * (len(s) - len(want))
        assert got == want, n


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("family", ["gpt", "ernie"])
def test_spec_parity_gpt_ernie(mesh_name, family):
    """The gpt / ernie tables come as data: they place the JAX models'
    own parameter names and shapes as the JAX rules do."""
    from paddle_tpu.models.ernie import ErnieConfig, ErnieForMaskedLM
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    if family == "gpt":
        m = GPTForCausalLM(GPTConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, dtype="float32"))
    else:
        m = ErnieForMaskedLM(ErnieConfig.tiny())
    jrules = getattr(jpre, f"{family}_sharding_rules")()
    trules = getattr(tpre, f"{family}_sharding_rules")()
    jmesh = jpre.make_mesh(8, **MESHES[mesh_name])
    tmesh = tpre.make_mesh(8, device="cpu", **MESHES[mesh_name])
    sharded_any = False
    for n, s in _jax_shapes(m).items():
        want = tuple(jpre.spec_for_param(n, s, jmesh, jrules))
        want += (None,) * (len(s) - len(want))
        got = tpre.spec_for_param(n, s, tmesh, trules)
        assert got == want, n
        sharded_any |= any(a is not None for a in got)
    assert sharded_any


def test_make_mesh_axes_assertion_and_refusals():
    m = tpre.make_mesh(8, dp=2, fsdp=2, mp=2, device="cpu")
    assert m.axis_names == ("pp", "dp", "fsdp", "sp", "mp")
    assert m.shape == {"pp": 1, "dp": 2, "fsdp": 2, "sp": 1, "mp": 2}
    assert tpre.make_mesh(8, fsdp=2, mp=2, device="cpu").shape["dp"] == 2
    with pytest.raises(AssertionError) as e_port:
        tpre.make_mesh(8, dp=3, fsdp=2, mp=2, device="cpu")
    with pytest.raises(AssertionError) as e_jax:
        jpre.make_mesh(8, dp=3, fsdp=2, mp=2)
    assert str(e_port.value) == str(e_jax.value) == "pp1*dp3*fsdp2*mp2*sp1 != 8"
    assert tpre.make_mesh(8, dp=4, sp=2, device="cpu").shape == \
        {"pp": 1, "dp": 4, "fsdp": 1, "sp": 2, "mp": 1}
    # the pipeline's axis builds now, the JAX layout's shape; the
    # one-program step still refuses it (tests/test_torch_pipeline.py)
    assert tpre.make_mesh(8, device="cpu", dp=4, pp=2).shape == \
        dict(jpre.make_mesh(8, dp=4, pp=2).shape)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")

    def rank(r, group):
        mesh = tpre.make_mesh(2, pp=2, group=group, device="cpu")
        _, _, meta = tpre.make_train_state(model, mesh)
        with pytest.raises(NotImplementedError, match="distributed_model"):
            tpre.make_train_step(model, mesh, meta)
        return mesh.coords["pp"]
    assert run_thread_ranks(2, rank, timeout=30) == [0, 1]
    one = tpre.make_mesh(1, device="cpu")
    assert one.size == 1 and one.groups["mp"] is None


def test_layout_only_mesh_refuses_to_train():
    mesh = tpre.make_mesh(8, dp=8, device="cpu")
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="world group"):
        tpre.make_train_state(model, mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_state_round_trip_and_bytes(mesh_name):
    """shard_state_from_numpy -> gather_state_to_numpy round-trips bit for
    bit; each rank's masters and moments take exactly the bytes of the
    JAX device at its coordinates, and a shard in the JAX order (every
    one but a fused weight split over mp by heads) has its values."""
    jm = _jax_model(FUSED)
    jmesh = jpre.make_mesh(8, **MESHES[mesh_name])
    jparams, jopt, _ = jpre.make_train_state(jm, jmesh)
    init = {k: np.asarray(v) for k, v in jparams.items()}
    devices = list(jmesh.devices.reshape(-1))
    cfg = LlamaConfig.tiny(dtype="float32", **FUSED)

    def device_bytes(tree, dev):
        return sum(s.data.nbytes for a in tree.values()
                   for s in a.addressable_shards if s.device == dev)

    def rank(r, group):
        mesh = tpre.make_mesh(8, group=group, device="cpu",
                              **MESHES[mesh_name])
        params, opt, meta = tpre.shard_state_from_numpy(init, mesh,
                                                        config=cfg)
        nbytes = sum(t.numel() * t.element_size()
                     for tree in (params, opt["m"], opt["v"])
                     for t in tree.values())
        for n, p in params.items():
            if meta["plans"][n].layout.groups is not None:
                continue
            shard = [s for s in jparams[n].addressable_shards
                     if s.device == devices[r]][0]
            np.testing.assert_array_equal(p.numpy(), np.asarray(shard.data),
                                          err_msg=n)
        return nbytes, tpre.gather_state_to_numpy(params, mesh, meta)

    out = run_thread_ranks(8, rank, timeout=60)
    for r, (nbytes, back) in enumerate(out):
        want = (device_bytes(jparams, devices[r])
                + device_bytes(jopt["m"], devices[r])
                + device_bytes(jopt["v"], devices[r]))
        assert nbytes == want, r
        assert set(back) == set(init)
        for n in init:
            np.testing.assert_array_equal(back[n], init[n], err_msg=n)


# -- the step against the JAX sharded step --------------------------------

STEP_CASES = {
    "dp2-fsdp2-mp2-fused": (FUSED, 8, MESHES["dp2-fsdp2-mp2"], {}),
    "dp2-fsdp2-mp2-unfused": ({}, 8, MESHES["dp2-fsdp2-mp2"], {}),
    "dp2": ({}, 2, dict(dp=2), {}),
    "mqa-kvh1-mp2": (dict(FUSED, num_key_value_heads=1), 8,
                     MESHES["dp2-fsdp2-mp2"], {}),
    "ignored-labels": (FUSED, 8, MESHES["dp4-fsdp2"], dict(ignore=True)),
    # the LM head stays whole: tied embeddings; a vocabulary mp does not
    # divide (the spec drops mp)
    "tied-mp2": (dict(FUSED, tie_word_embeddings=True), 8,
                 MESHES["dp2-fsdp2-mp2"], {}),
    "v129-mp2": (dict(FUSED, vocab_size=129), 8, MESHES["dp2-fsdp2-mp2"],
                 {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax_sharded_step(case):
    cfg_kw, n, mesh_kw, bkw = STEP_CASES[case]
    batches = _batches(**bkw)
    init, want, jfinal, _ = _jax_run(cfg_kw, n, mesh_kw, batches)
    _, _, jone, _ = _jax_run(cfg_kw, 1, dict(dp=1), batches)
    out = _port_run(cfg_kw, n, mesh_kw, init, batches)
    for hist, _, _, _ in out:           # every rank has the global numbers
        np.testing.assert_allclose(hist, want, rtol=1e-5, atol=0)
    final = out[0][1]
    for k in jfinal:
        _close(final[k], jfinal[k], _spread(jone[k], jfinal[k]), atol=1e-5,
               what=k)
    cfg = LlamaConfig.tiny(dtype="float32", **cfg_kw)
    mesh = tpre.make_mesh(n, device="cpu", **mesh_kw)
    shapes = _jax_shapes(_jax_model(cfg_kw))
    specs = {k: tpre.spec_for_param(k, s, mesh, tpre.llama_sharding_rules())
             for k, s in shapes.items()}
    plans, split = sharded.plan_params(cfg, shapes, specs, mesh.shape)
    # the LM head runs vocab-parallel wherever its spec keeps mp on the
    # vocabulary and it has its own weight; gathered over fsdp alone
    head = mesh.shape["mp"] > 1 and case not in ("tied-mp2", "v129-mp2")
    assert (sharded.HEAD in split) == head
    if head:
        assert [ax for _, ax, _ in plans["lm_head.weight"].steps] == \
            ["fsdp"]
    if case == "mqa-kvh1-mp2":          # heads do not split: run whole
        assert specs["llama.layers.0.self_attn.qkv_proj.weight"] == \
            ("fsdp", "mp")
        assert "llama.layers.0.self_attn" not in split
        assert "llama.layers.0.mlp" in split


def test_telemetry_on_the_mesh_matches_jax():
    """The packed per-group vector equals the JAX step's; loss, gnorm and
    masters are the same bits with telemetry on and off."""
    batches = _batches()
    init, want, _, jvecs = _jax_run(FUSED, 8, MESHES["dp2-fsdp2-mp2"],
                                    batches, telemetry=True)
    _, _, _, jone = _jax_run(FUSED, 1, dict(dp=1), batches, telemetry=True)
    on = _port_run(FUSED, 8, MESHES["dp2-fsdp2-mp2"], init, batches,
                   telemetry=True)
    off = _port_run(FUSED, 8, MESHES["dp2-fsdp2-mp2"], init, batches)
    for r in range(8):
        np.testing.assert_array_equal(on[r][0], off[r][0])
        for k in off[r][1]:
            np.testing.assert_array_equal(on[r][1][k], off[r][1][k])
        for got, jv, j1 in zip(on[r][2], jvecs, jone):
            _close(got, jv, _spread(j1, jv), rtol=1e-5, what="telemetry")
    np.testing.assert_allclose(on[0][0], want, rtol=1e-5)


@pytest.mark.parametrize("option", ["recompute", "fused_lm_loss"])
def test_options_on_the_mesh(option):
    """recompute=True and fused_lm_loss on the mesh give the step without
    them (recompute: the same bits)."""
    batches = _batches(ignore=True)
    init = {k: np.asarray(v) for k, v in state_arrays(
        _jax_model(FUSED))[0].items()}
    base = _port_run(FUSED, 8, MESHES["dp2-fsdp2-mp2"], init, batches)
    opt = _port_run(FUSED, 8, MESHES["dp2-fsdp2-mp2"], init, batches,
                    **{option: True})
    if option == "recompute":
        np.testing.assert_array_equal(opt[0][0], base[0][0])
        for k in base[0][1]:
            np.testing.assert_array_equal(opt[0][1][k], base[0][1][k])
    else:
        np.testing.assert_allclose(opt[0][0], base[0][0], rtol=1e-5)
        for k in base[0][1]:
            np.testing.assert_allclose(opt[0][1][k], base[0][1][k],
                                       rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh_name", ["dp2-fsdp2-mp2", "dp4-fsdp2"])
def test_collective_counts_match_formula(mesh_name):
    """One step's collectives on every rank: calls and payload bytes by op
    and axis equal ``sharded.step_comm``'s closed form."""
    mesh_kw = MESHES[mesh_name]
    batches = _batches(n=1)
    init = {k: np.asarray(v) for k, v in state_arrays(
        _jax_model(FUSED))[0].items()}
    out = _port_run(FUSED, 8, mesh_kw, init, batches)
    cfg = LlamaConfig.tiny(dtype="float32", **FUSED)
    mesh = tpre.make_mesh(8, device="cpu", **mesh_kw)
    shapes = {k: v.shape for k, v in init.items()}
    specs = {k: tpre.spec_for_param(k, s, mesh, tpre.llama_sharding_rules())
             for k, s in shapes.items()}
    plans, split = sharded.plan_params(cfg, shapes, specs, mesh.shape)
    want = sharded.step_comm(plans, split, mesh.shape,
                             tokens_local=8 // mesh.data_size * 16,
                             hidden=cfg.hidden_size, act_bytes=4,
                             compute_bytes=4)
    for r in range(8):
        assert out[r][3] == want, r


def test_make_mesh_one_is_the_single_device_step():
    """make_mesh(1) with no group trains with the same bits as mesh=None."""
    cfg = LlamaConfig.tiny(dtype="float32", **FUSED)
    batches = _batches(n=2, rows=4)

    def run(mesh):
        model = LlamaForCausalLM(cfg, device="cpu", seed=5)
        params, opt, meta = tpre.make_train_state(model, mesh)
        step = tpre.make_train_step(model, mesh, meta)
        hist = []
        for b in batches:
            sb = tpre.batch_to_device(b, "cpu") if mesh is None \
                else tpre.shard_batch(b, mesh)
            params, opt, loss, gnorm = step(params, opt, sb)
            hist.append((float(loss), float(gnorm)))
        return hist, params
    h0, p0 = run(None)
    h1, p1 = run(tpre.make_mesh(1, device="cpu"))
    assert h0 == h1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_shard_batch_rows():
    b = {"input_ids": np.arange(8 * 3).reshape(8, 3),
         "labels": np.arange(8 * 3).reshape(8, 3) + 100}

    def rank(r, group):
        mesh = tpre.make_mesh(8, dp=2, fsdp=2, mp=2, group=group,
                              device="cpu")
        sb = tpre.shard_batch(b, mesh)
        return mesh.data_index, sb["input_ids"].numpy()
    out = run_thread_ranks(8, rank, timeout=30)
    for r, (idx, rows) in enumerate(out):
        coords = np.unravel_index(r, (1, 2, 2, 1, 2))
        assert idx == coords[1] * 2 + coords[2]
        np.testing.assert_array_equal(rows, b["input_ids"][2 * idx:
                                                          2 * idx + 2])


def test_dead_peer_raises_within_the_timeout():
    """A rank that never enters the step makes the others raise within
    the group's timeout instead of hanging."""
    import time
    cfg = LlamaConfig.tiny(dtype="float32", **FUSED)
    init = {k: np.asarray(v) for k, v in state_arrays(
        _jax_model(FUSED))[0].items()}
    batch = _batches(n=1)[0]
    took = {}

    def rank(r, group):
        mesh = tpre.make_mesh(8, dp=2, fsdp=2, mp=2, group=group,
                              device="cpu", timeout=2.0)
        if r == 3:
            return "absent"
        params, opt, meta = tpre.shard_state_from_numpy(init, mesh,
                                                        config=cfg)
        step = tpre.make_train_step(LlamaForCausalLM(cfg, device="cpu"),
                                    mesh, meta)
        t0 = time.monotonic()
        try:
            step(params, opt, tpre.shard_batch(batch, mesh))
        except RuntimeError:
            took[r] = time.monotonic() - t0
            return "raised"
        return "finished"
    out = run_thread_ranks(8, rank, timeout=10)
    assert out[3] == "absent"
    assert out.count("raised") >= 1 and "finished" not in out
    assert max(took.values()) < 30


def test_collective_ops_on_threads():
    """all_gather and reduce_scatter on sub-groups, counted by op and axis
    into the caller's stats."""
    def rank(r, group):
        stats = {}
        parts = collective.all_gather([], torch.full((2,), float(r)),
                                      group=group, axis="dp", stats=stats)
        out = torch.empty(2)
        collective.reduce_scatter(
            out, [torch.full((2,), float(r + k)) for k in range(4)],
            group=group, axis="dp", stats=stats)
        return [p.tolist() for p in parts], out.tolist(), stats
    out = run_thread_ranks(4, rank, timeout=30)
    for r, (parts, red, stats) in enumerate(out):
        assert parts == [[float(k)] * 2 for k in range(4)]
        assert red == [float(sum(q + r for q in range(4)))] * 2
        assert stats == {"all_gather,dp": {"calls": 1, "bytes": 32},
                         "reduce_scatter,dp": {"calls": 1, "bytes": 32}}
