"""The PyTorch port's single-device pretraining step held against the JAX
package on the CPU: one AdamW update against ``pretrain._adamw`` on the
same numpy inputs, a 5-step loss / grad-norm trajectory of
``flagship_config``'s CPU form against the JAX ``make_train_step`` on a
one-device mesh (also with the fused LM-head loss and rope inside the
flash kernels, the JAX step then running its Pallas kernels in
interpret mode), and three bf16 AMP-O2 steps with and without them.

Tolerances: AdamW elementwise 1e-6 (atol, f32 values of O(1)); the f32
trajectory rtol 1e-5 (losses near ln 128 = 4.85; the two frameworks
reduce in another order, measured 1.3e-7 apart); the bf16 steps rtol
1e-3 on the loss and 5e-3 on the grad norm (bf16 rounds at other points
in XLA's fusions than in eager torch, each rounding 2**-9 relative;
measured 1.1e-5 and 3.2e-4 apart).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional.attention as JATT  # noqa: E402
import paddle_tpu.ops.pallas.blockwise_ce as BC  # noqa: E402
import paddle_tpu.ops.pallas.flash_attention as FA  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu_torch.models import (LlamaForCausalLM,  # noqa: E402
                                     llama_state_from_numpy)
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.ops import blockwise_ce as tbc  # noqa: E402
from paddle_tpu_torch.observability import instrument  # noqa: E402


def _adamw_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w2d": (6, 5), "emb": (4, 3), "norm": (5,), "bias": (3,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    m = {n: 0.1 * rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    v = {n: np.abs(0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in shapes.items()}
    return params, grads, m, v


@pytest.mark.parametrize("clip", [0.5, 100.0, 0.0])
def test_adamw_one_step_matches(clip):
    """clip 0.5 is active (the grads' norm is ~6), 100 is not, 0 turns it
    off; decay touches only the ndim >= 2 parameters."""
    params, grads, m, v = _adamw_inputs(1)
    hp = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, clip=clip)
    jp, js, jg = jpre._adamw(
        {n: jnp.asarray(a) for n, a in params.items()},
        {n: jnp.asarray(a) for n, a in grads.items()},
        {"m": {n: jnp.asarray(a) for n, a in m.items()},
         "v": {n: jnp.asarray(a) for n, a in v.items()},
         "count": jnp.asarray(3, jnp.int32)}, **hp)
    # _adamw (kernel D on the card, its plain version here) and
    # _adamw_plain (the foreach passes anywhere) both match
    for fn in (tpre._adamw, tpre._adamw_plain):
        t = {n: torch.tensor(a) for n, a in params.items()}
        state = {"m": {n: torch.tensor(a) for n, a in m.items()},
                 "v": {n: torch.tensor(a) for n, a in v.items()}, "count": 3}
        tp, ts, tg = fn(
            t, {n: torch.tensor(a) for n, a in grads.items()}, state,
            hp["lr"], hp["b1"], hp["b2"], hp["eps"], hp["wd"], hp["clip"])
        assert ts["count"] == int(js["count"]) == 4
        assert abs(float(tg) - float(jg)) <= 1e-6 * float(jg)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=0, atol=1e-6, err_msg=n)
            np.testing.assert_allclose(ts["m"][n].numpy(),
                                       np.asarray(js["m"][n]), rtol=0,
                                       atol=1e-6, err_msg=n)
            np.testing.assert_allclose(ts["v"][n].numpy(),
                                       np.asarray(js["v"][n]), rtol=0,
                                       atol=1e-6, err_msg=n)
        assert tp["w2d"] is t["w2d"] and ts is state   # updated in place


def _batches(n, batch, seq, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (batch, seq))
             .astype(np.int32),
             "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}
            for _ in range(n)]


def _trajectories(cfg, batch, seq, steps):
    paddle.seed(21)
    jm = JLlama(cfg)
    mesh = jpre.make_mesh(1, dp=1, fsdp=1, mp=1, sp=1)
    jparams, jopt, jmeta = jpre.make_train_state(jm, mesh)
    np_params = {n: np.asarray(a) for n, a in jparams.items()}
    jstep = jpre.make_train_step(jm, mesh, jmeta)
    tm = llama_state_from_numpy(np_params, cfg, device="cpu")
    tparams, topt, tmeta = tpre.make_train_state(tm)
    tstep = tpre.make_train_step(tm, None, tmeta)
    want, got = [], []
    for b in _batches(steps, batch, seq, cfg.vocab_size):
        jparams, jopt, jl, jg = jstep(jparams, jopt, jpre.shard_batch(b, mesh))
        want.append((float(jl), float(jg)))
        tparams, topt, tl, tg = tstep(tparams, topt,
                                      tpre.batch_to_device(b, "cpu"))
        got.append((float(tl), float(tg)))
    return np.array(want), np.array(got), tparams, jparams


def test_five_step_trajectory_matches_make_train_step():
    cfg, batch, seq = tpre.flagship_config(on_tpu=False)
    jcfg, jb, js = jpre.flagship_config(on_tpu=False)
    assert (batch, seq) == (jb, js) == (4, 64)
    assert vars(cfg) == vars(jcfg)
    steps0 = instrument.train_steps_total().value
    tokens0 = instrument.train_tokens_total().value
    want, got, params, jparams = _trajectories(cfg, batch, seq, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert all(p.dtype == torch.float32 for p in params.values())
    for n, p in params.items():     # the parameters after five updates
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[n]),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    assert instrument.train_steps_total().value == steps0 + 5
    assert instrument.train_tokens_total().value == tokens0 + 5 * batch * seq
    assert instrument.train_tokens_per_s().value > 0


@pytest.fixture
def kernel_options(monkeypatch):
    """Both kernel options on, and the JAX step on its kernel path (flash
    attention and the blockwise loss as Pallas kernels in interpret
    mode)."""
    monkeypatch.setattr(FA, "_INTERPRET", True)
    monkeypatch.setattr(BC, "_INTERPRET", True)
    monkeypatch.setattr(JATT, "_flash_available", lambda: True)
    return dict(fuse_rope_in_attention=True, fused_lm_loss=True)


def test_five_step_trajectory_with_kernel_options_matches(kernel_options,
                                                          monkeypatch):
    """The fused LM-head loss and rope inside the flash kernels through
    five f32 steps: losses and grad norms within 1e-5 of JAX
    ``make_train_step`` with the same options; the step reaches the
    blockwise op once forward and once backward per step."""
    cfg, batch, seq = tpre.flagship_config(on_tpu=False)
    for k, v in kernel_options.items():
        setattr(cfg, k, v)
    calls = []
    for name in ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw"):
        inner = getattr(tbc, name)
        monkeypatch.setattr(tbc, name, lambda *a, _n=name, _f=inner: (
            calls.append(_n), _f(*a))[1])
    want, got, params, _ = _trajectories(cfg, batch, seq, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert calls == ["ce_fwd", "ce_bwd_dh", "ce_bwd_dw"] * 5
    assert all(p.dtype == torch.float32 for p in params.values())


def test_bf16_amp_step_with_kernel_options_matches(kernel_options):
    """AMP-O2 with both options: the head weight reaches the blockwise op
    as bf16 and its gradient lands on the f32 master."""
    cfg, batch, seq = tpre.flagship_config(on_tpu=False)
    cfg.dtype = "bfloat16"
    cfg.fuse_attention_qkv = cfg.fuse_attention_ffn = True
    for k, v in kernel_options.items():
        setattr(cfg, k, v)
    want, got, params, _ = _trajectories(cfg, 2, 32, 3)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3, atol=0)
    assert all(p.dtype == torch.float32 for p in params.values())


def test_bf16_amp_step_matches():
    """AMP-O2: ndim >= 2 parameters run the forward in bf16 (norm scales
    stay f32 and are cast down inside rms_norm), the grads land on the
    f32 masters."""
    cfg, batch, seq = tpre.flagship_config(on_tpu=False)
    cfg.dtype = "bfloat16"
    cfg.fuse_attention_qkv = cfg.fuse_attention_ffn = True
    want, got, params, _ = _trajectories(cfg, 2, 32, 3)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3, atol=0)
    assert all(p.dtype == torch.float32 for p in params.values())


def test_bench_argument_order_drives_both_packages_positionally():
    """bench.py's calls, every argument positional, on both packages:
    ``flagship_config(on_tpu)``, ``make_train_state(model, mesh)``, then
    ``make_train_step(model, mesh, meta)`` (the port's mesh is None, one
    device), three f32 steps of ``LlamaConfig.tiny`` on the same seeded
    batches; rtol 1e-5 as for the five-step trajectory."""
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu_torch.models import LlamaConfig
    assert vars(tpre.flagship_config(False)[0]) \
        == vars(jpre.flagship_config(False)[0])
    cfg, jcfg = LlamaConfig.tiny(dtype="float32"), \
        JConfig.tiny(dtype="float32")
    paddle.seed(5)
    jm = JLlama(jcfg)
    mesh = jpre.make_mesh(1, dp=1, fsdp=1, mp=1, sp=1)
    jparams, jopt, jmeta = jpre.make_train_state(jm, mesh)
    jstep = jpre.make_train_step(jm, mesh, jmeta)
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in
                                 jparams.items()}, cfg, device="cpu")
    tparams, topt, tmeta = tpre.make_train_state(tm, None)
    tstep = tpre.make_train_step(tm, None, tmeta, True)
    assert tmeta["lr"] == jmeta["lr"] == 3e-4
    want, got = [], []
    for b in _batches(3, 2, 16, cfg.vocab_size, seed=3):
        jparams, jopt, jl, jg = jstep(jparams, jopt, jpre.shard_batch(b, mesh))
        want.append((float(jl), float(jg)))
        tparams, topt, tl, tg = tstep(tparams, topt,
                                      tpre.batch_to_device(b, "cpu"))
        got.append((float(tl), float(tg)))
    assert topt["count"] == int(jopt["count"]) == 3
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5,
                               atol=0)


def test_flagship_shape_matches_the_jax_package():
    cfg, batch, seq = tpre.flagship_config()
    jcfg, jb, js = jpre.flagship_config(on_tpu=True)
    assert vars(cfg) == vars(jcfg) and (batch, seq) == (jb, js) == (8, 2048)


def test_cuda_is_the_default_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg, _, _ = tpre.flagship_config(on_tpu=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpre.batch_to_device({"input_ids": np.zeros((1, 4), np.int32)})


def test_later_slice_options_raise():
    """The mesh's pp axis builds now (the pipeline trains on it:
    ``tests/test_torch_pipeline.py``, which also holds the one-program
    step's refusal of it), and a mesh that is not the port's is refused;
    telemetry, the monitor and lr_scale run
    (``test_lifted_options_run_and_match_the_jax_package``); sharding
    rules on one device place nothing."""
    cfg, _, _ = tpre.flagship_config(on_tpu=False)
    tm = LlamaForCausalLM(cfg, device="cpu")
    params, opt, meta = tpre.make_train_state(tm)
    # the sp axis builds (tests/test_torch_context_parallel.py), and so
    # does pp now; a layout of more than one rank still needs its group
    assert tpre.make_mesh(2, sp=2, device="cpu").shape["sp"] == 2
    pp_mesh = tpre.make_mesh(2, device="cpu", pp=2)
    assert pp_mesh.shape["pp"] == 2 and pp_mesh.layout_only
    with pytest.raises(ValueError, match="world group"):
        tpre.make_train_step(tm, pp_mesh, meta)
    with pytest.raises(TypeError, match="make_mesh"):
        tpre.make_train_state(tm, mesh=object())
    with pytest.raises(TypeError, match="make_mesh"):
        tpre.make_train_step(tm, object(), meta)
    with pytest.raises(TypeError, match="make_mesh"):
        tpre.make_train_step(tm, object(), meta, telemetry=True)
    ruled, _, _ = tpre.make_train_state(tm, None, rules=[])
    assert all(torch.equal(ruled[n], params[n]) for n in params)


def _pair(telemetry=False, monitor=None, jmonitor=None):
    """The JAX step on a one-device mesh and the port's, from the same
    seeded weights (tiny config, float32)."""
    cfg, _, _ = tpre.flagship_config(on_tpu=False)
    jcfg, _, _ = jpre.flagship_config(on_tpu=False)
    paddle.seed(23)
    jm = JLlama(jcfg)
    mesh = jpre.make_mesh(1, dp=1, fsdp=1, mp=1, sp=1)
    jparams, jopt, jmeta = jpre.make_train_state(jm, mesh)
    np_params = {n: np.asarray(a) for n, a in jparams.items()}
    jstep = jpre.make_train_step(jm, mesh, jmeta, telemetry=telemetry,
                                 monitor=jmonitor)
    tm = llama_state_from_numpy(np_params, cfg, device="cpu")
    tparams, topt, tmeta = tpre.make_train_state(tm)
    tstep = tpre.make_train_step(tm, None, tmeta, telemetry=telemetry,
                                 monitor=monitor)
    return (mesh, jparams, jopt, jstep), (tparams, topt, tstep, tmeta), cfg


@pytest.mark.parametrize("option", ["telemetry", "monitor", "lr_scale"])
def test_lifted_options_run_and_match_the_jax_package(option, tmp_path):
    """The options the refusal test used to refuse, run against the JAX
    step on the same weights and batches (3 steps, 4 x 32): telemetry's
    packed vector within rtol 1e-5 (the non-finite counts and the group
    labels exact), the monitor's gauges and breaches (none) equal, and
    one ``lr_scale=64`` step's loss and parameters within the trajectory
    tolerance."""
    from paddle_tpu import observability as jobs
    from paddle_tpu_torch import observability as tobs
    jmon = tmon = None
    if option == "monitor":
        jmon = jobs.TrainHealthMonitor(
            flight_recorder=jobs.FlightRecorder(min_interval_s=0.0))
        tmon = tobs.TrainHealthMonitor(
            flight_recorder=tobs.FlightRecorder(min_interval_s=0.0))
    (mesh, jp, jo, jstep), (tp, to, tstep, tmeta), cfg = _pair(
        telemetry=option == "telemetry", monitor=tmon, jmonitor=jmon)
    for i, b in enumerate(_batches(3, 4, 32, cfg.vocab_size, seed=3)):
        jb, tb = jpre.shard_batch(b, mesh), tpre.batch_to_device(b, "cpu")
        if option == "telemetry":
            jp, jo, jl, jg, jv = jstep._jitted(jp, jo, jb)
            tp, to, tl, tg, tv = tstep._step(tp, to, tb, tmeta["lr"])
            assert tstep._telemetry_spec.labels == \
                jstep._telemetry_spec.labels
            jv, tv = np.asarray(jv), tv.numpy()
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=0)
            assert np.array_equal(tv[5::4], jv[5::4])     # non-finite
            continue
        scale = 64.0 if option == "lr_scale" and i == 1 else None
        jp, jo, jl, jg = jstep(jp, jo, jb, lr_scale=scale)
        tp, to, tl, tg = tstep(tp, to, tb, lr_scale=scale)
        np.testing.assert_allclose([float(tl), float(tg)],
                                   [float(jl), float(jg)], rtol=1e-5)
        for n, p in tp.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
    if option == "monitor":
        assert tmon.steps_observed == jmon.steps_observed == 3
        assert tmon.breach_counts == jmon.breach_counts == {}
        assert tstep._monitor is tmon


def test_telemetry_leaves_the_losses_and_parameters_alone():
    """Telemetry on and off give the same bits: losses, grad norms and the
    parameters after 3 steps (the update runs the same passes)."""
    runs = []
    for tel in (False, True):
        _, (tp, to, tstep, _), cfg = _pair(telemetry=tel)
        rows = []
        for b in _batches(3, 4, 32, cfg.vocab_size, seed=4):
            tp, to, tl, tg = tstep(tp, to, tpre.batch_to_device(b, "cpu"))
            rows.append((float(tl), float(tg)))
        runs.append((rows, tp))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
