"""The PyTorch port's training-health pieces held against the JAX package
on the CPU: the embedding's out-of-range rows (NaN, their gradient
dropped), the monitor fed the same ``observe_step`` sequence (the same
breaches, counts and dump reasons), the telemetry spec, the fault
injector's schedules and counts, ``instrument_loader``, ``watch_ops``
and the compile watch.

Tolerances: the embedding and the monitor's inputs are exact; nothing
here sums in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.observability import train_health as jth  # noqa: E402
from paddle_tpu.testing.faults import TrainFaultInjector as JInj  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.observability import compile_watch  # noqa: E402
from paddle_tpu_torch.observability import instrument  # noqa: E402
from paddle_tpu_torch.observability import train_health as tth  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.testing import TrainFaultInjector  # noqa: E402


# -- the embedding's out-of-range ids ---------------------------------------

@pytest.mark.parametrize("ids", [[[0, 7]], [[3, -1, -4, -5, 4, 1 << 30]],
                                 [[2, 2], [-2, 9]]])
def test_embedding_out_of_range_rows_are_nan_as_in_jax(ids):
    """An id in [-V, V) reads its row (negative ids wrap), any other id a
    NaN row, as the JAX package's fill-mode gather; the smallest case is
    w = ones(4, 3), ids [[0, 7]] -> [[1, 1, 1], [nan, nan, nan]]."""
    rng = np.random.default_rng(0)
    w = np.ones((4, 3), np.float32) if ids == [[0, 7]] else \
        rng.standard_normal((4, 3)).astype(np.float32)
    idx = np.asarray(ids, np.int32)
    want = JF.embedding(paddle.to_tensor(idx), paddle.to_tensor(w)).numpy()
    got = TF.embedding(torch.as_tensor(idx), torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, want)
    if ids == [[0, 7]]:
        assert np.isnan(got[0, 1]).all() and (got[0, 0] == 1).all()


def test_embedding_gradient_drops_the_out_of_range_rows():
    """d/dw of sum(c * embedding(ids, w)) over the in-range ids only: the
    JAX gradient of ``jnp.take`` (fill mode) with the NaN rows' cotangent
    zero, row for row."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    idx = np.array([[0, 4, -1, 9, -7, 2, 4]], np.int32)
    c = rng.standard_normal((1, 7, 4)).astype(np.float32)
    ok = ((idx >= -5) & (idx < 5))[..., None]

    def jf(wj):
        out = jnp.take(wj, jnp.asarray(idx), axis=0)
        return jnp.sum(jnp.where(ok, out * c, 0.0))

    want = np.asarray(jax.grad(jf)(jnp.asarray(w)))
    wt = torch.tensor(w, requires_grad=True)
    out = TF.embedding(torch.as_tensor(idx), wt)
    torch.where(torch.as_tensor(ok), out * torch.as_tensor(c),
                torch.zeros(())).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=0, atol=1e-6)
    assert bool(out[0, 3].isnan().all()) and bool(out[0, 4].isnan().all())
    assert torch.equal(out[0, 2], wt[4])


# -- the monitor -------------------------------------------------------------

def _groups(ratio=1e-3, nonfinite=0.0, grad=1.0):
    return {"embed": {"grad_norm": grad, "param_norm": 10.0,
                      "update_norm": 10.0 * ratio, "update_ratio": ratio,
                      "nonfinite": nonfinite},
            "head": {"grad_norm": grad, "param_norm": 5.0,
                     "update_norm": 5.0 * ratio, "update_ratio": ratio,
                     "nonfinite": 0.0}}


# (step, loss, gnorm, groups kwargs, data wait) at now = 10 * step
SEQUENCE = (
    [(i, 4.0 + 0.01 * (i % 3), 1.0 + 0.02 * (i % 2), {}, 0.01)
     for i in range(8)]
    + [(8, 9.0, 1.0, {}, 0.01),             # loss spike
       (9, 4.0, 12.0, {}, 0.01),            # grad spike
       (10, 4.0, 1.0, dict(ratio=5.0), 0.01),   # update ratio explodes
       (11, 4.0, 1.0, {}, 2.0),             # data stall
       (12, float("nan"), float("nan"), dict(nonfinite=7.0), 0.01),
       (13, float("nan"), float("nan"), dict(nonfinite=7.0), 0.01),
       (14, 4.0, 1.0, {}, 0.01)])


@pytest.mark.parametrize("cooldown_s", [None, 0.0])
def test_monitor_fires_as_the_jax_monitor_on_the_same_sequence(cooldown_s,
                                                              tmp_path):
    """Both monitors fed the same observe_step / observe_data_wait
    sequence on a synthetic clock: the same breaches per step, counts
    and dump reasons."""
    out = []
    for k, obs in enumerate((jobs, tobs)):
        flight = obs.FlightRecorder(min_interval_s=0.0)
        flight.arm(str(tmp_path / f"dumps{k}"))
        mod = jth if obs is jobs else tth
        mon = mod.TrainHealthMonitor(window_s=100.0, min_count=4,
                                     data_stall_s=1.0, cooldown_s=cooldown_s,
                                     flight_recorder=flight)
        fired = []
        for step, loss, gnorm, gkw, wait in SEQUENCE:
            now = 10.0 * step
            mon.observe_data_wait(wait, step=step, now=now)
            rep = mon.observe_step(step, loss, gnorm, groups=_groups(**gkw),
                                   now=now + 1)
            fired.append(rep["breaches"])
        reasons = sorted(obs.load_dump(p)["reason"] for p in flight.dumps)
        digests = sorted(mod.breach_summary(obs.load_dump(p))["check"]
                         for p in flight.dumps)
        out.append((fired, dict(mon.breach_counts), reasons, digests,
                    mon.report()))
    assert out[0] == out[1]
    fired, counts = out[1][0], out[1][1]
    assert counts["loss_spike"] >= 1 and counts["non_finite"] == 1
    assert counts["data_stall"] == 1 and counts["update_ratio"] == 1
    assert fired[12] == ["non_finite"] and fired[13] == []


def test_spec_and_unpack_match_the_jax_package():
    ndims = {"llama.embed_tokens.weight": 2, "lm_head.weight": 2,
             "llama.norm.weight": 1, "other.w": 2}
    for i in range(24):
        ndims[f"llama.layers.{i}.mlp.down_proj.weight"] = 2
        ndims[f"llama.layers.{i}.input_layernorm.weight"] = 1
    js, ts = jth.build_telemetry_spec(ndims), tth.build_telemetry_spec(ndims)
    assert ts.groups == js.groups and ts.labels == (
        "embed", "blocks_00_05", "blocks_06_11", "blocks_12_17",
        "blocks_18_23", "norm_bias", "head", "other")
    vec = np.arange(len(ts), dtype=np.float32) / 7.0
    vec[3] = 0.0                                   # param_norm 0
    assert ts.unpack(vec) == js.unpack(vec)
    assert tth.CHECKS == jth.CHECKS and tth.DUMP_REASONS == jth.DUMP_REASONS


def test_instrument_loader_counts_waits_and_stalls():
    reg = tobs.get_registry()
    before = reg.counter("train_data_batches_total").value
    tth.pop_data_wait()
    mon = tth.TrainHealthMonitor(data_stall_s=1e-9,
                                 flight_recorder=tobs.FlightRecorder())
    got = list(tth.instrument_loader(iter([1, 2, 3]), monitor=mon,
                                     queue_depth=lambda: 2))
    assert got == [1, 2, 3]
    assert reg.counter("train_data_batches_total").value == before + 3
    assert reg.gauge("train_data_queue_depth").value == 2
    assert mon.breach_counts == {"data_stall": 1}
    assert tth.pop_data_wait() > 0 and tth.pop_data_wait() == 0


# -- the fault injector ------------------------------------------------------

def test_train_fault_injector_matches_the_jax_package():
    """The same schedule in both: corrupted batches, the lr scales step by
    step, the stalled loader's batches and ``injected``."""
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 128, (2, 8)).astype(np.int32),
                "labels": rng.integers(0, 128, (2, 8)).astype(np.int32)}
               for _ in range(6)]
    runs = []
    for cls in (JInj, TrainFaultInjector):
        inj = cls().nan_batch(2, tokens=3).nan_batch(4).lr_spike(
            1, factor=8.0).stall_loader(3, delay_s=0.001)
        adj = [inj.adjust_batch(i, b) for i, b in enumerate(batches)]
        scales = [inj.lr_scale_for(i) for i in range(6)]
        seen = list(inj.wrap_loader(batches))
        runs.append((adj, scales, seen, dict(inj.injected),
                     cls.OOV_TOKEN))
    (ja, js, jseen, jinj, joov), (ta, ts, tseen, tinj, toov) = runs
    assert ts == js == [None, 8.0, None, None, None, None]
    assert tinj == jinj == {"nan_batch": 2, "lr_spike": 1,
                            "loader_stall": 1}
    assert toov == joov == 1 << 30
    for a, b in zip(ta, ja):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert (ta[2]["input_ids"][0, :3] == 1 << 30).all()
    assert (ta[4]["input_ids"][0, :4] == 1 << 30).all()
    assert tseen is not jseen and len(tseen) == len(jseen) == 6
    assert batches[2]["input_ids"][0, 0] != 1 << 30   # host batch copied


# -- watch_ops and the compile watch ----------------------------------------

def test_watch_ops_counts_torch_calls_and_switches_off():
    """Op names are torch's ("torch.matmul", "torch.Tensor.add"), not the
    JAX package's; switching on twice changes nothing and switching off
    restores the mode stack."""
    from torch.overrides import _get_current_function_mode_stack
    reg = tobs.get_registry()

    def count(op):
        fam = reg.snapshot().get("op_calls_total", {})
        return fam.get("children", {}).get(op, {}).get("value", 0.0)
    depth = len(_get_current_function_mode_stack())
    x = torch.ones(3)
    before = count("torch.matmul"), count("torch.Tensor.add")
    instrument.watch_ops()
    instrument.watch_ops()
    try:
        assert len(_get_current_function_mode_stack()) == depth + 1
        torch.matmul(x, x)
        torch.matmul(x, x)
        x + 1
    finally:
        instrument.watch_ops(False)
    instrument.watch_ops(False)
    assert len(_get_current_function_mode_stack()) == depth
    torch.matmul(x, x)
    assert count("torch.matmul") == before[0] + 2
    assert count("torch.Tensor.add") == before[1] + 1


def test_compile_watch_counts_builds_loads_and_torch_compile():
    assert compile_watch.install() and compile_watch.install()
    assert compile_watch.installed()
    assert _build.listeners.count(compile_watch._record) == 1
    n0 = compile_watch.compiles()
    _build._announce("nvcc_build", "adamw", 12.5)
    _build._announce("library_load", "adamw", 0.001)
    assert compile_watch.compiles() == n0 + 2
    snap = tobs.get_registry().snapshot()["compiles_total"]["children"]
    assert any("nvcc_build" in k and "adamw" in k for k in snap)
    torch._dynamo.reset()           # drops dynamo's callbacks ...
    compile_watch.install()         # ... and install() puts them back
    n1 = compile_watch.compiles()
    fn = torch.compile(lambda t: t * 2 + 1, backend="eager")
    fn(torch.ones(4))
    fn(torch.ones(4))
    assert compile_watch.compiles() >= n1 + 1
    n2 = compile_watch.compiles()
    fn(torch.ones(4))
    assert compile_watch.compiles() == n2      # no new compile
