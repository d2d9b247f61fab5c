"""The port's ``amp`` package held against the JAX package's on the CPU:
every case of ``tests/test_amp.py`` through both, on the same numpy
inputs. Output dtypes are equal op by op; values agree within BF16_TOL
(the two frameworks round bf16 products and sums in their own order: a
few bf16 units); ``decorate`` casts the same parameters; O2 training
keeps f32 masters equal to JAX's within rtol 1e-5 after 3 steps; the
GradScaler sequences (scale, skip, decay, growth, pass-through, state
dict) are exact; the operator stats count alike under the name table;
the tensor checker raises on NaN. Then the port's fused residual form of
``rms_norm`` under auto_cast against the JAX layer's add and norm, the
tiny Llama under O1 and O2 in both packages (the same dtype at every
named entry, logits within BF16_TOL element by element, losses within
LOSS_RTOL), ``recompute`` under auto_cast (the gradients of the run
without it), the context per thread, and the port's unscale reading one
flag a step.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu_torch import amp, nn, optimizer  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402

BF16_TOL = 2e-2     # a bf16 result: about 3 units of 2^-8 of its scale
LOSS_RTOL = 2e-4    # the tiny Llama's loss under O1 / O2, port vs JAX:
                    # six readings (O1 and O2, three seeds each) gave at
                    # most 6.1e-5, its logits at most 3.9e-3 apart
MASTER_RTOL = 1e-5  # f32 masters after 3 O2 steps


def _dt(t):
    """A dtype's name in either framework."""
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.data.astype(jnp.float32))


def _close(got, want, tol=BF16_TOL):
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(
        1.0, float(np.abs(w).max())))


def _pair(*arrays):
    return ([paddle.to_tensor(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def _rng(seed):
    return np.random.default_rng(seed)


# -- tests/test_amp.py, case by case -----------------------------------------

def test_o1_white_op_runs_low_precision():
    (jx, jy), (tx, ty) = _pair(*(_rng(0).standard_normal(s).astype(
        np.float32) for s in ((4, 8), (8, 4))))
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        want = paddle.matmul(jx, jy)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = torch.matmul(tx, ty)
    assert _dt(got) == _dt(want) == "bfloat16"
    _close(got, want)
    assert _dt(torch.matmul(tx, ty)) == _dt(paddle.matmul(jx, jy)) \
        == "float32"


def test_o1_black_op_stays_fp32():
    rng = _rng(1)
    (jx, jw), (tx, tw) = _pair(rng.random((4, 8)).astype(np.float32) + 0.5,
                               rng.standard_normal((8, 8)).astype(np.float32))
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jh = paddle.matmul(jx, jw)
        jout = paddle.log(jh.astype("float32") * 0 + 1.0)
        jloss = paddle.nn.functional.softmax(jh)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        th = torch.matmul(tx, tw)
        tout = torch.log(th.to(torch.float32) * 0 + 1.0)
        tloss = torch.nn.functional.softmax(th, dim=-1)
    for g, w in ((th, jh), (tout, jout), (tloss, jloss)):
        assert _dt(g) == _dt(w)
        _close(g, w)
    assert _dt(tout) == _dt(tloss) == "float32"


def test_promote_gray_op():
    rng = _rng(2)
    (jx, jw), (tx, tw) = _pair(rng.standard_normal((4, 8)).astype(np.float32),
                               rng.standard_normal((8, 8)).astype(np.float32))
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jh = paddle.matmul(jx, jw)
        jout = paddle.add(jh, jx)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        th = torch.matmul(tx, tw)
        tout = torch.add(th, tx)
        tdunder = th + tx
    assert _dt(tout) == _dt(tdunder) == _dt(jout) == "float32"
    _close(tout, jout)


def test_custom_lists():
    rng = _rng(3)
    (jx, jw), (tx, tw) = _pair(rng.standard_normal((4, 8)).astype(np.float32),
                               rng.standard_normal((8, 8)).astype(np.float32))
    with jamp.auto_cast(custom_black_list={"matmul"}, level="O1",
                        dtype="bfloat16"):
        jout = paddle.matmul(jx, jw)
    with amp.auto_cast(custom_black_list={"matmul"}, level="O1",
                       dtype="bfloat16"):
        tout = torch.matmul(tx, tw)
    assert _dt(tout) == _dt(jout) == "float32"
    _close(tout, jout, 1e-6)
    with jamp.auto_cast(custom_white_list={"add"}, level="O1",
                        dtype="bfloat16"):
        jout = paddle.add(jx, jx)
    with amp.auto_cast(custom_white_list={"add"}, level="O1",
                       dtype="bfloat16"):
        tout = torch.add(tx, tx)
    assert _dt(tout) == _dt(jout) == "bfloat16"
    _close(tout, jout)


def test_o0_disabled():
    rng = _rng(4)
    (jx, jw), (tx, tw) = _pair(rng.standard_normal((4, 8)).astype(np.float32),
                               rng.standard_normal((8, 8)).astype(np.float32))
    with jamp.auto_cast(enable=False):
        jout = paddle.matmul(jx, jw)
    with amp.auto_cast(enable=False):
        tout = torch.matmul(tx, tw)
    with amp.auto_cast(level="O0"):
        t0 = torch.matmul(tx, tw)
    assert _dt(tout) == _dt(t0) == _dt(jout) == "float32"


def test_autocast_backward_grads_flow():
    rng = _rng(5)
    w = rng.standard_normal((8, 8)).astype(np.float32) * 0.3
    x = rng.standard_normal((4, 8)).astype(np.float32)
    jlin = jnn.Linear(8, 8, bias_attr=False)
    jlin.weight.set_value(w)
    tlin = nn.Linear(8, 8, 0.02, torch.Generator(), "cpu")
    with torch.no_grad():
        tlin.weight.copy_(torch.as_tensor(w))
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jout = jlin(paddle.to_tensor(x))
        jloss = jout.astype("float32").sum()
    jloss.backward()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tout = tlin(torch.as_tensor(x))
        tloss = tout.to(torch.float32).sum()
    tloss.backward()
    assert _dt(tout) == _dt(jout) == "bfloat16"
    assert _dt(tlin.weight.grad) == _dt(jlin.weight.grad) == "float32"
    _close(tlin.weight.grad, jlin.weight.grad)


def _decorate_models():
    jm = jnn.Sequential(jnn.Linear(8, 8), jnn.LayerNorm(8), jnn.Linear(8, 2))
    g = torch.Generator()
    tm = torch.nn.Sequential(nn.Linear(8, 8, 0.02, g, "cpu"),
                             torch.nn.LayerNorm(8),
                             nn.Linear(8, 2, 0.02, g, "cpu"))
    return jm, tm


def test_decorate_o2_casts_params_keeps_norm_fp32():
    jm, tm = _decorate_models()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    assert _dt(tm[0].weight) == _dt(jm[0].weight) == "bfloat16"
    assert _dt(tm[1].weight) == _dt(jm[1].weight) == "float32"
    assert _dt(tm[1].bias) == _dt(jm[1].bias) == "float32"
    assert _dt(tm[2].weight) == _dt(jm[2].weight) == "bfloat16"
    assert to._multi_precision and jo._multi_precision
    # O1 casts nothing; excluded layers keep f32; master_weight=False
    jm, tm = _decorate_models()
    assert amp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    to = optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    tm, to = amp.decorate(tm, to, level="O2", master_weight=False,
                          excluded_layers=[nn.Linear])
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert not to._multi_precision
    with pytest.raises(ValueError):
        amp.decorate(tm, level="O3")


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_o2_training_with_master_weights(opt_name):
    """Three O2 steps in both packages from the same weights and batches:
    the f32 masters agree within MASTER_RTOL and the bf16 parameters are
    the masters rounded."""
    rng = _rng(6)
    w = (rng.standard_normal((8, 1)) * 0.3).astype(np.float32)
    xs = [rng.standard_normal((16, 8)).astype(np.float32) for _ in range(3)]
    jm = jnn.Linear(8, 1, bias_attr=False)
    jm.weight.set_value(w)
    tm = nn.Linear(8, 1, 0.02, torch.Generator(), "cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.as_tensor(w))
    kw = dict(learning_rate=0.1)
    jo = getattr(jopt, opt_name)(parameters=jm.parameters(), **kw)
    to = getattr(optimizer, opt_name)(parameters=tm.parameters(), **kw)
    jm, jo = jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    for x in xs:
        with jamp.auto_cast(level="O2", dtype="bfloat16"):
            jloss = jm(paddle.to_tensor(x)).sum()
        jloss.backward()
        jo.step()
        jo.clear_grad()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tloss = tm(torch.as_tensor(x)).sum()
        tloss.backward()
        to.step()
        to.clear_grad()
        assert _dt(tloss) == _dt(jloss)
    jmaster = np.asarray(jo._accumulators[id(jm.weight)]["master"])
    tmaster = to._accumulators[id(tm.weight)]["master"]
    assert tmaster.dtype == torch.float32
    np.testing.assert_allclose(tmaster.numpy(), jmaster, rtol=MASTER_RTOL,
                               atol=0)
    assert torch.equal(tm.weight, tmaster.to(torch.bfloat16))
    assert not np.allclose(tmaster.numpy(), w)


# -- the GradScaler: the same sequences, exactly -------------------------------

def _scaler_pair(**kw):
    return jamp.GradScaler(**kw), amp.GradScaler(**kw)


def _params(values):
    jp = paddle.core.tensor.Parameter(np.asarray(values, np.float32))
    tp = torch.nn.Parameter(torch.tensor(values, dtype=torch.float32))
    return jp, tp


def test_grad_scaler_scales_and_unscales():
    jp, tp = _params([1.0, 1.0, 1.0, 1.0])
    js, ts = _scaler_pair(init_loss_scaling=1024.0)
    jo = jopt.SGD(learning_rate=1.0, parameters=[jp])
    to = optimizer.SGD(learning_rate=1.0, parameters=[tp])
    jscaled = js.scale((jp * 2.0).sum())
    tscaled = ts.scale((tp * 2.0).sum())
    assert float(tscaled) == float(jscaled) == 8.0 * 1024.0
    jscaled.backward()
    tscaled.backward()
    js.step(jo)
    js.update()
    ts.step(to)
    ts.update()
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.detach().numpy(), -1.0)
    assert ts._scale == js._scale and ts.host_reads == 1


def test_grad_scaler_skips_on_inf_and_decays():
    jp, tp = _params([1.0, 1.0])
    js, ts = _scaler_pair(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    jo = jopt.SGD(learning_rate=1.0, parameters=[jp])
    to = optimizer.SGD(learning_rate=1.0, parameters=[tp])
    jp.grad = paddle.to_tensor(np.array([np.inf, 1.0], np.float32))
    tp.grad = torch.tensor([np.inf, 1.0])
    js.step(jo)
    js.update()
    ts.step(to)
    ts.update()
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.detach().numpy(), 1.0)
    assert ts._scale == js._scale == 4.0


def test_grad_scaler_growth_and_decay_sequence():
    """A longer sequence, inf planted at steps 1 and 4: scale, skipped
    steps and parameters equal at every step."""
    jp, tp = _params([1.0, 2.0, 3.0])
    js, ts = _scaler_pair(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                          decr_every_n_nan_or_inf=1)
    jo = jopt.SGD(learning_rate=0.5, parameters=[jp])
    to = optimizer.SGD(learning_rate=0.5, parameters=[tp])
    scales = []
    for step in range(7):
        g = np.full(3, 0.25 * js._scale, np.float32)
        if step in (1, 4):
            g[step % 3] = np.inf if step == 1 else np.nan
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.as_tensor(g.copy())
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        assert ts._scale == js._scale
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      np.asarray(jp.data))
        scales.append(ts._scale)
    assert scales == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14, 2.0 ** 15,
                      2.0 ** 14, 2.0 ** 14, 2.0 ** 15]
    assert ts.host_reads == 7


def test_grad_scaler_growth():
    jp, tp = _params([1.0, 1.0])
    js, ts = _scaler_pair(init_loss_scaling=2.0, incr_every_n_steps=2)
    jo = jopt.SGD(learning_rate=0.0, parameters=[jp])
    to = optimizer.SGD(learning_rate=0.0, parameters=[tp])
    for _ in range(2):
        jp.grad = paddle.to_tensor(np.ones([2], np.float32))
        tp.grad = torch.ones(2)
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
    assert ts._scale == js._scale == 4.0


def test_grad_scaler_disabled_passthrough():
    jp, tp = _params([1.0, 1.0])
    js, ts = _scaler_pair(enable=False)
    jo = jopt.SGD(learning_rate=1.0, parameters=[jp])
    to = optimizer.SGD(learning_rate=1.0, parameters=[tp])
    jloss, tloss = (jp * 3.0).sum(), (tp * 3.0).sum()
    assert js.scale(jloss) is jloss and ts.scale(tloss) is tloss
    jloss.backward()
    tloss.backward()
    js.step(jo)
    js.update()
    ts.step(to)
    ts.update()
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.detach().numpy(), -2.0)
    assert ts.state_dict() == js.state_dict() == {}
    assert ts.host_reads == 0


def test_scaler_state_dict_roundtrip():
    js, ts = _scaler_pair(init_loss_scaling=512.0)
    js._incr_count = ts._incr_count = 7
    jst, tst = js.state_dict(), ts.state_dict()
    assert tst == jst
    assert type(tst["scale"]) is type(jst["scale"])
    s2 = amp.GradScaler()
    s2.load_state_dict(jst)            # the JAX state loads into the port
    assert s2._scale == 512.0 and s2._incr_count == 7


def test_scaler_state_machine_errors_and_setters():
    tp = torch.nn.Parameter(torch.ones(2))
    to = optimizer.SGD(learning_rate=1.0, parameters=[tp])
    ts = amp.GradScaler(init_loss_scaling=4.0)
    tp.grad = torch.ones(2)
    ts.unscale_(to)
    with pytest.raises(RuntimeError, match="unscale_"):
        ts.unscale_(to)
    ts.step(to)
    with pytest.raises(RuntimeError, match="step"):
        ts.step(to)
    ts.update()
    ts.set_init_loss_scaling(64.0)
    assert ts._scale == ts.get_init_loss_scaling() == 64.0
    with pytest.raises(ValueError):
        ts.set_incr_ratio(1.0)
    with pytest.raises(ValueError):
        ts.set_decr_ratio(1.5)
    ts.set_incr_every_n_steps(5)
    ts.set_decr_every_n_nan_or_inf(3)
    assert (ts.get_incr_every_n_steps(), ts.get_decr_every_n_nan_or_inf()) \
        == (5, 3)
    assert ts.is_enable() and ts.is_use_dynamic_loss_scaling()


def test_minimize_steps_and_updates():
    jp, tp = _params([1.0, 1.0])
    js, ts = _scaler_pair(init_loss_scaling=4.0, incr_every_n_steps=1)
    jo = jopt.SGD(learning_rate=1.0, parameters=[jp])
    to = optimizer.SGD(learning_rate=1.0, parameters=[tp])
    jl, tl = js.scale((jp * 2.0).sum()), ts.scale((tp * 2.0).sum())
    jl.backward()
    tl.backward()
    js.minimize(jo, jl)
    ts.minimize(to, tl)
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(jp.data))
    assert ts._scale == js._scale == 8.0


# -- debugging ----------------------------------------------------------------------

def test_operator_stats_collection():
    x = _rng(7).standard_normal((4, 4)).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.as_tensor(x)
    jamp.debugging.enable_operator_stats_collection()
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        paddle.matmul(jx, jx)
        paddle.exp(jx)
        paddle.add(jx, jx)
    jstats = jamp.debugging.disable_operator_stats_collection()
    amp.debugging.enable_operator_stats_collection()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        torch.matmul(tx, tx)
        torch.exp(tx)
        torch.add(tx, tx)
    tstats = amp.debugging.disable_operator_stats_collection()
    for op in ("matmul", "exp", "add"):
        assert dict(tstats[op]) == dict(jstats[op])
    assert tstats["matmul"]["bfloat16"] == 2
    with amp.debugging.collect_operator_stats():
        torch.matmul(tx, tx)
    assert amp.debugging._stats is None


def test_tensor_checker_raises_on_nan():
    bad = np.array([1.0, np.nan], np.float32)
    for mod, fn, t in ((jamp, paddle.exp, paddle.to_tensor(bad)),
                       (amp, torch.exp, torch.as_tensor(bad))):
        mod.debugging.enable_tensor_checker(
            mod.debugging.TensorCheckerConfig(enable=True))
        try:
            with pytest.raises(FloatingPointError):
                fn(t)
        finally:
            mod.debugging.disable_tensor_checker()
    torch.exp(torch.as_tensor(bad))          # checker off: no raise
    # skipped ops pass; check_numerics counts
    amp.debugging.enable_tensor_checker(amp.debugging.TensorCheckerConfig(
        skipped_op_list=["exp"]))
    try:
        torch.exp(torch.as_tensor(bad))
    finally:
        amp.debugging.disable_tensor_checker()
    with pytest.raises(FloatingPointError, match="1 nan and 0 inf"):
        amp.debugging.check_numerics(torch.as_tensor(bad), "op", "x")
    n_nan, n_inf = amp.debugging.check_numerics(torch.ones(3))
    assert int(n_nan) == int(n_inf) == 0


def test_run_stats_compare_f32_against_amp():
    x = _rng(8).standard_normal((4, 8)).astype(np.float32)
    w = _rng(9).standard_normal((8, 8)).astype(np.float32)
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)

    def run():
        return torch.softmax(torch.matmul(tx, tw), dim=-1)
    with amp.debugging.collect_run_stats() as f32:
        run()
    with amp.debugging.collect_run_stats() as low:
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            run()
    rows = amp.debugging.compare_accuracy(f32, low)
    assert [r["op"] for r in rows] == ["matmul", "softmax"]
    assert [(r["fp32_dtype"], r["amp_dtype"]) for r in rows] == \
        [("float32", "float32"), ("float32", "float32")] or \
        rows[0]["amp_dtype"] == "bfloat16"
    assert rows[0]["amp_dtype"] == "bfloat16"
    assert all(r["flag"] != "NAN/INF" for r in rows)


# -- the tiny Llama under O1 and O2 in both packages --------------------------------

# port entry -> the JAX op whose inputs it takes (the JAX Llama on the CPU
# runs attention as "flash_attention_ref"; its MLP's silu is the port's
# fused swiglu entry; its rope is plain multiplies, so the port's rope
# entry is held to the attention's input dtype)
NAMED = {"linear": "linear", "embedding": "embedding", "rms_norm": "rms_norm",
         "cross_entropy": "cross_entropy",
         "flash_attention": "flash_attention_ref", "swiglu": "silu",
         "fused_rotary_position_embedding": "flash_attention_ref"}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_fused_residual_norm_rounds_the_add_as_jax(level):
    """``rms_norm(x, w, residual=r)`` under auto_cast is the JAX layer's
    ``h = r + x`` (cast as "add": bf16 under O2, f32 under O1 with an f32
    input) and then ``rms_norm(h)`` on the black list: h bit-equal to
    JAX's, out of JAX's dtype and within BF16_TOL."""
    rng = _rng(9)
    x = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    r = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    (jx, jr, jw), (tx, tr, tw) = _pair(x, r, w)
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        jx16 = paddle.matmul(jx, paddle.to_tensor(np.eye(64,
                                                          dtype=np.float32)))
        jh = jr + jx16
        jout = paddle.nn.functional.rms_norm(jh, jw)
    with amp.auto_cast(level=level, dtype="bfloat16"):
        tx16 = torch.matmul(tx, torch.eye(64))
        tout, th = F.rms_norm(tx16, tw, residual=tr)
    assert _dt(th) == _dt(jh) == ("bfloat16" if level == "O2"
                                  else "float32")
    assert np.array_equal(_np(th), _np(jh))
    assert _dt(tout) == _dt(jout)
    _close(tout, jout)


def _floats(d):
    return {k for k in d if k in ("float32", "bfloat16", "float16")}


def _llama_pair():
    from paddle_tpu.jit.functional import state_arrays
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, llama_state_from_numpy
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(dtype="float32"))
    params, _ = state_arrays(jm)
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="float32"),
                                device="cpu")
    rng = _rng(4)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 128, (2, 16)).astype(np.int32)
    return jm, tm, ids, labels


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_llama_dtypes_and_loss_match_jax(level):
    jm, tm, ids, labels = _llama_pair()
    jopt_ = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topt = optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    if level == "O2":
        jm, jopt_ = jamp.decorate(jm, jopt_, level="O2", dtype="bfloat16")
        tm, topt = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
        assert {n: _dt(p) for n, p in tm.named_parameters()} == \
            {n: _dt(p) for n, p in jm.named_parameters()}
    jamp.debugging.enable_operator_stats_collection()
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        jlogits, jloss = jm(paddle.to_tensor(ids),
                            labels=paddle.to_tensor(labels))
    jstats = jamp.debugging.disable_operator_stats_collection()
    amp.debugging.enable_operator_stats_collection()
    with amp.auto_cast(level=level, dtype="bfloat16"):
        tlogits, tloss = tm(torch.as_tensor(ids).long(),
                            labels=torch.as_tensor(labels).long())
    tstats = amp.debugging.disable_operator_stats_collection()
    for port_op, jax_op in NAMED.items():
        assert port_op in tstats and jax_op in jstats, (port_op, jax_op)
        assert _floats(tstats[port_op]) == _floats(jstats[jax_op]), \
            (port_op, dict(tstats[port_op]), dict(jstats[jax_op]))
    assert _dt(tlogits) == _dt(jlogits) == "bfloat16"
    _close(tlogits, jlogits)
    assert _dt(tloss) == _dt(jloss) == "float32"
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    tloss.backward()
    assert all(p.grad is not None and p.grad.dtype == p.dtype
               for p in tm.parameters())


def test_named_entries_cast_nothing_without_auto_cast():
    x = torch.randn(2, 3, 8)
    w = torch.randn(8, 4).to(torch.bfloat16)
    out = F.linear(x, w)                    # promotes, as before
    assert out.dtype == torch.float32
    assert F.rms_norm(x.to(torch.bfloat16), torch.ones(8)).dtype == \
        torch.bfloat16


def test_recompute_under_auto_cast_gives_the_plain_gradients():
    """The backward's second forward runs on the autograd engine's
    schedule, outside the caller's context: the recompute replays the
    forward's amp stack, so its gradients are the run's without
    recompute, bit for bit."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    def grads(policy):
        cfg = LlamaConfig.tiny(dtype="float32", recompute=policy)
        m = LlamaForCausalLM(cfg, device="cpu", seed=3)
        m.train()
        rng = _rng(5)
        ids = torch.as_tensor(rng.integers(0, 128, (2, 16)))
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            _, loss = m(ids, labels=ids)
        loss.backward()
        return float(loss), {n: p.grad.clone()
                             for n, p in m.named_parameters()}
    ref_loss, ref = grads(False)
    for policy in (True, "dots_saveable"):
        loss, got = grads(policy)
        assert loss == ref_loss
        for n in ref:
            assert torch.equal(got[n], ref[n]), (policy, n)


def test_the_context_is_per_thread():
    x = torch.randn(4, 4)
    seen = {}

    def other():
        seen["other"] = torch.matmul(x, x).dtype
        with amp.auto_cast(level="O1", dtype="float16"):
            seen["own"] = torch.matmul(x, x).dtype

    with amp.auto_cast(level="O1", dtype="bfloat16"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["main"] = torch.matmul(x, x).dtype
    assert seen == {"other": torch.float32, "own": torch.float16,
                    "main": torch.bfloat16}
    assert torch.matmul(x, x).dtype == torch.float32


def test_nested_contexts_and_errors():
    x = torch.randn(4, 4)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        with amp.auto_cast(enable=False):
            assert torch.matmul(x, x).dtype == torch.float32
        with amp.auto_cast(level="O2", dtype="float16"):
            assert torch.add(x, x).dtype == torch.float16
        assert torch.matmul(x, x).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="level"):
        with amp.auto_cast(level="O3"):
            pass
    with pytest.raises(ValueError, match="dtype"):
        with amp.auto_cast(dtype="float32"):
            pass
    assert amp.amp_guard is amp.auto_cast and amp.amp_decorate is \
        amp.decorate
    assert amp.is_bfloat16_supported("cpu") and \
        amp.is_float16_supported("cpu")
    assert amp.white_list() == jamp.white_list()
    assert amp.black_list() == jamp.black_list()
