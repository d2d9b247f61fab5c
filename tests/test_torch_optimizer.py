"""The port's ``optimizer`` package, ``nn.clip`` and kernel D's eager
form (its plain version, the CPU route) held against the JAX package's
``paddle_tpu.optimizer`` and ``paddle_tpu.nn.clip`` on the same seeded
parameters and gradients.

Tolerances: f32 rtol 1e-6, with atol 1e-7 (below one f32 ulp at the
parameters' scale, ~1) for elements that cancel to near 0.
bf16 parameters with ``multi_precision``: the f32 masters within rtol
1e-6 and the parameters bit-equal to round(master). The schedulers'
rates are exact. The clipped gradients: rtol 1e-6 in f32, and bf16 ones
within one bf16 rounding (the port's global norm is an f64 sum, the JAX
package's per-tensor f32 sums, so the scale may differ in its last bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Parameter, Tensor  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402
from paddle_tpu_torch.ops import adamw as ad  # noqa: E402

SHAPES = [(8, 6), (6,), (4, 3, 2)]
NAMES = ["w0", "b0", "w1"]
STEPS = 3
RTOL, ATOL = 1e-6, 1e-7

ALL = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp", "Adadelta",
       "Adamax", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD", "LarsMomentum",
       "LBFGS"]
# the optimizers that take a coupled L2 weight_decay
L2 = {"SGD", "Momentum", "Adam", "Adagrad", "RMSProp", "Adadelta", "Adamax",
      "NAdam", "RAdam", "ASGD", "LBFGS"}


class _L2Decay:
    """An L2Decay-style regularizer: the optimizers read ``coeff``."""

    def __init__(self, coeff):
        self.coeff = coeff


def _data(seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) * scale
           for s in SHAPES] for _ in range(STEPS)]
    return p0, gs


def _jax_params(p0, dtype=jnp.float32, attrs=None):
    ps = [Parameter(jnp.asarray(a).astype(dtype), name=n)
          for a, n in zip(p0, NAMES)]
    for p, (k, v) in zip(ps, (attrs or {}).items()):
        setattr(p, k, v)
    return ps


def _torch_params(p0, dtype=torch.float32):
    return [torch.nn.Parameter(torch.tensor(a).to(dtype)) for a in p0]


def _run_jax(cls, kw, p0, gs, dtype=jnp.float32, mp=False, setup=None):
    ps = _jax_params(p0, dtype)
    if setup:
        setup(ps, "jax")
    opt = getattr(paddle.optimizer, cls)(parameters=ps, multi_precision=mp,
                                         **kw)
    for step in gs:
        for p, g in zip(ps, step):
            p.grad = Tensor(jnp.asarray(g).astype(dtype))
        opt.step()
    masters = [opt._accumulators[id(p)].get("master") for p in ps]
    return ([np.asarray(p.data.astype(jnp.float32)) for p in ps],
            [None if m is None else np.asarray(m) for m in masters], opt)


def _run_torch(cls, kw, p0, gs, dtype=torch.float32, mp=False, setup=None):
    ps = _torch_params(p0, dtype)
    if setup:
        setup(ps, "torch")
    opt = getattr(topt, cls)(parameters=list(zip(NAMES, ps)),
                             multi_precision=mp, **kw)
    for step in gs:
        for p, g in zip(ps, step):
            p.grad = torch.tensor(g).to(dtype)
        opt.step()
    masters = [opt._accumulators[id(p)].get("master") for p in ps]
    return ([p.detach().float().numpy() for p in ps],
            [None if m is None else m.numpy() for m in masters], opt)


def _close(got, want, rtol=RTOL, atol=ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _kw(cls, wd=0.05):
    kw = dict(learning_rate=0.01)
    if cls in L2:
        kw["weight_decay"] = wd
    return kw


# -- the fifteen optimizers ------------------------------------------------

@pytest.mark.parametrize("cls", ALL)
def test_optimizer_matches_jax_f32(cls):
    p0, gs = _data()
    want, _, _ = _run_jax(cls, _kw(cls), p0, gs)
    got, _, _ = _run_torch(cls, _kw(cls), p0, gs)
    _close(got, want)


@pytest.mark.parametrize("cls", ALL)
def test_optimizer_bf16_masters_match_jax(cls):
    p0, gs = _data(1)
    want, wm, _ = _run_jax(cls, _kw(cls), p0, gs, jnp.bfloat16, mp=True)
    got, gm, opt = _run_torch(cls, _kw(cls), p0, gs, torch.bfloat16,
                              mp=True)
    _close(gm, wm)
    for p, m in zip(got, gm):
        # the parameter is round(master), bit for bit
        want_p = torch.tensor(m).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(p, want_p)


@pytest.mark.parametrize("cls", sorted(L2))
def test_weight_decay_object_equals_float(cls):
    p0, gs = _data(2)
    want, _, _ = _run_jax(cls, _kw(cls, _L2Decay(0.05)), p0, gs)
    got, _, _ = _run_torch(cls, _kw(cls, _L2Decay(0.05)), p0, gs)
    _close(got, want)
    as_float, _, _ = _run_torch(cls, _kw(cls, 0.05), p0, gs)
    _close(got, as_float, rtol=0, atol=0)


def test_adamw_decay_fun_lr_ratio_and_optimize_attr():
    p0, gs = _data(3)
    kw = dict(learning_rate=0.01, weight_decay=0.1,
              apply_decay_param_fun=lambda name: name != "w1",
              lr_ratio=lambda p: 0.5 if len(p.shape) >= 2 else 1.0)

    def setup(ps, side):
        if side == "jax":
            ps[2].optimize_attr["learning_rate"] = 0.3
        else:
            ps[2].optimize_attr = {"learning_rate": 0.3}
    want, _, _ = _run_jax("AdamW", kw, p0, gs, setup=setup)
    got, _, _ = _run_torch("AdamW", kw, p0, gs, setup=setup)
    _close(got, want)


def test_param_groups_scale_the_rate():
    p0, gs = _data(4)
    ps = _torch_params(p0)
    opt = topt.SGD(learning_rate=0.1, parameters=[
        {"params": ps[:2]}, {"params": ps[2:], "learning_rate": 0.5}])
    for p, g in zip(ps, gs[0]):
        p.grad = torch.tensor(g)
    opt.step()
    np.testing.assert_allclose(ps[2].detach().numpy(),
                               p0[2] - np.float32(0.05) * gs[0][2],
                               rtol=1e-6)
    np.testing.assert_allclose(ps[0].detach().numpy(),
                               p0[0] - np.float32(0.1) * gs[0][0],
                               rtol=1e-6)


def test_sparse_grads_are_refused_naming_the_item():
    p = torch.nn.Parameter(torch.zeros(4, 2))
    p.grad = torch.zeros(4, 2).to_sparse()
    opt = topt.SGD(learning_rate=0.1, parameters=[p])
    with pytest.raises(NotImplementedError, match="item 10"):
        opt.step()


# -- the schedulers --------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=1.0),
    "PiecewiseDecay": dict(boundaries=[3, 8], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.1),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=10,
                            end_lr=0.01, power=2.0, cycle=True),
    "LinearWarmup": dict(learning_rate=0.5, warmup_steps=5, start_lr=0.0,
                         end_lr=0.5),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 9, 15]),
    "StepDecay": dict(learning_rate=0.5, step_size=4, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5,
                                lr_lambda=lambda e: 0.97),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=10, eta_min=0.01),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=4, T_mult=2,
                                        eta_min=0.01),
    "LinearLR": dict(learning_rate=0.5, total_steps=12),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=20),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.5,
                     step_size_up=3, mode="triangular2"),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=2, factor=0.5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_rates_exact(name):
    kw = SCHEDULERS[name]
    js, ts = getattr(jlr, name)(**kw), getattr(tlr, name)(**kw)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.99] * 5
    want, got = [], []
    for i in range(25):
        want.append(js())
        got.append(ts())
        if name == "ReduceOnPlateau":
            js.step(metrics[i])
            ts.step(torch.tensor(metrics[i]))
        else:
            js.step()
            ts.step()
    assert got == want
    sd = ts.state_dict()
    fresh = getattr(tlr, name)(**kw)
    fresh.set_state_dict(sd)
    assert fresh() == ts()


def test_scheduler_drives_the_optimizer():
    p0, gs = _data(5)
    sched = dict(learning_rate=0.1, step_size=1, gamma=0.5)
    jp, tp = _jax_params(p0), _torch_params(p0)
    jo = paddle.optimizer.SGD(learning_rate=jlr.StepDecay(**sched),
                              parameters=jp)
    to = topt.SGD(learning_rate=tlr.StepDecay(**sched), parameters=tp)
    for step in gs:
        for a, b, g in zip(jp, tp, step):
            a.grad = Tensor(jnp.asarray(g))
            b.grad = torch.tensor(g)
        jo.step()
        to.step()
        jo._lr_scheduler.step()
        to._lr_scheduler.step()
        assert to.get_lr() == jo.get_lr()
    _close([p.detach().numpy() for p in tp], [np.asarray(p.data) for p in jp])


# -- state ---------------------------------------------------------------

def test_state_dict_round_trip():
    p0, gs = _data(6)
    ps = _torch_params(p0)
    opt = topt.AdamW(learning_rate=0.01, parameters=ps)
    for step in gs[:2]:
        for p, g in zip(ps, step):
            p.grad = torch.tensor(g)
        opt.step()
    sd = opt.state_dict()
    assert sorted(sd) == sorted(["@step"] + [f"param_{i}.{k}" for i in
                                             range(3) for k in
                                             ("moment1", "moment2")])
    ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = topt.AdamW(learning_rate=0.01, parameters=ps2)
    opt2.set_state_dict(sd)
    for o, params in ((opt, ps), (opt2, ps2)):
        for p, g in zip(params, gs[2]):
            p.grad = torch.tensor(g)
        o.step()
    _close([p.detach().numpy() for p in ps2],
           [p.detach().numpy() for p in ps], rtol=0, atol=0)


def test_state_carried_over_from_jax():
    p0, gs = _data(7)
    jp = _jax_params(p0)
    jo = paddle.optimizer.Adam(learning_rate=0.01, parameters=jp,
                               weight_decay=0.05)
    for step in gs[:2]:
        for p, g in zip(jp, step):
            p.grad = Tensor(jnp.asarray(g))
        jo.step()
    state = {k: (v.numpy() if hasattr(v, "numpy") else v)
             for k, v in jo.state_dict().items()}
    tp = _torch_params([np.asarray(p.data) for p in jp])
    to = topt.Adam(learning_rate=0.01, parameters=tp, weight_decay=0.05)
    topt.optimizer_state_from_numpy(to, state, names=NAMES)
    assert to._step_count == 2
    for p, q, g in zip(jp, tp, gs[2]):
        p.grad = Tensor(jnp.asarray(g))
        q.grad = torch.tensor(g)
    jo.step()
    to.step()
    _close([p.detach().numpy() for p in tp], [np.asarray(p.data) for p in jp])
    back = topt.optimizer_state_to_numpy(to)
    assert back["@step"] == 3
    np.testing.assert_allclose(back["param_0.moment1"],
                               np.asarray(jo.state_dict()[
                                   "w0.moment1"].numpy()), rtol=RTOL)


# -- the clips ------------------------------------------------------------

def _clip_pairs(dtype_j, dtype_t, seed=8):
    rng = np.random.default_rng(seed)
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp = _jax_params([np.zeros(s, np.float32) for s in SHAPES])
    tp = _torch_params([np.zeros(s, np.float32) for s in SHAPES])
    jp[1].need_clip = False
    tp[1].need_clip = False
    return ([(p, Tensor(jnp.asarray(g).astype(dtype_j)))
             for p, g in zip(jp, gs)],
            [(p, torch.tensor(g).to(dtype_t)) for p, g in zip(tp, gs)])


CLIPS = [("ClipGradByValue", (0.4,)), ("ClipGradByNorm", (1.5,)),
         ("ClipGradByGlobalNorm", (2.0,)), ("ClipGradByGlobalNorm", (1e4,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,args", CLIPS)
def test_clip_classes_match_jax(name, args, dtype):
    jpairs, tpairs = _clip_pairs(getattr(jnp, dtype), getattr(torch, dtype))
    want = getattr(paddle.nn, name)(*args)(jpairs)
    got = getattr(tnn, name)(*args)(tpairs)
    for (_, a), (_, b), (_, g0) in zip(got, want, tpairs):
        assert a.dtype == g0.dtype
        a = a.float().numpy()
        b = np.asarray(b.data.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        else:   # within one bf16 rounding of each other
            np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=0)
    # need_clip False: the gradient is passed through as it is
    assert got[1][1] is tpairs[1][1]


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    rng = np.random.default_rng(9)
    gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp = _jax_params([np.zeros(s, np.float32) for s in SHAPES])
    tp = _torch_params([np.zeros(s, np.float32) for s in SHAPES])
    for a, b, g in zip(jp, tp, gs):
        a.grad = Tensor(jnp.asarray(g))
        b.grad = torch.tensor(g)
    want = paddle.nn.clip_grad_norm_(jp, 1.0, norm_type)
    got = tnn.clip_grad_norm_(tp, 1.0, norm_type)
    np.testing.assert_allclose(float(got), float(want.numpy()), rtol=RTOL)
    _close([p.grad.numpy() for p in tp], [p.grad.numpy() for p in jp])


def test_clipped_bf16_grad_is_rounded_back():
    g = torch.tensor([[1.0, 1.0 / 3.0], [2.0, -0.7]]).to(torch.bfloat16)
    p = torch.nn.Parameter(torch.zeros(2, 2))
    (_, out), = tnn.ClipGradByGlobalNorm(0.5)([(p, g)])
    assert out.dtype == torch.bfloat16
    gn = g.double().square().sum().sqrt().float()
    want = (g.float() * (0.5 / gn)).to(torch.bfloat16)
    assert torch.equal(out, want)


# -- kernel D's eager form: its plain version against JAX ---------------

EAGER_CLIPS = {"none": None, "active": 1.0, "inactive": 1e4}


@pytest.mark.parametrize("clip", sorted(EAGER_CLIPS))
@pytest.mark.parametrize("mode", ["adamw", "adam"])
def test_adamw_eager_plain_matches_jax(mode, clip):
    """adamw_eager_plain on the JAX optimizer's tensors, step by step,
    against paddle_tpu's AdamW / Adam with ClipGradByGlobalNorm (a
    need_clip False tensor included)."""
    p0, gs = _data(10, scale=2.0)
    clip_norm = EAGER_CLIPS[clip]
    jp = _jax_params(p0)
    jp[1].need_clip = False
    cls = paddle.optimizer.AdamW if mode == "adamw" \
        else paddle.optimizer.Adam
    jclip = paddle.nn.ClipGradByGlobalNorm(clip_norm) if clip_norm else None
    jo = cls(learning_rate=0.01, beta1=0.9, beta2=0.95, epsilon=1e-8,
             parameters=jp, weight_decay=0.1, grad_clip=jclip)
    ps = [torch.tensor(a) for a in p0]
    ms = [torch.zeros(s) for s in SHAPES]
    vs = [torch.zeros(s) for s in SHAPES]
    for t, step in enumerate(gs, 1):
        for p, g in zip(jp, step):
            p.grad = Tensor(jnp.asarray(g))
        jo.step()
        gn = ad.adamw_eager_plain(
            ps, [torch.tensor(g) for g in step], ms, vs, [0.01] * 3,
            [True] * 3, 0.9, 0.95, 1e-8, 0.1, t, mode=mode, clip=clip_norm,
            clip_flags=[True, False, True])
        want_gn = np.sqrt(sum(float(np.sum(np.square(step[i])))
                              for i in (0, 2)))
        np.testing.assert_allclose(float(gn), want_gn, rtol=1e-6)
    _close([p.numpy() for p in ps], [np.asarray(p.data) for p in jp])
    for i, p in enumerate(jp):
        st = jo._accumulators[id(p)]
        _close([ms[i].numpy(), vs[i].numpy()],
               [np.asarray(st["moment1"]), np.asarray(st["moment2"])])


def test_adamw_eager_plain_bf16_master_and_out():
    """A bf16 parameter with an f32 master: the out copy is round(p); the
    bf16 grads are clipped and rounded back to bf16 before the update."""
    p0, gs = _data(11)
    jp = _jax_params(p0, jnp.bfloat16)
    jo = paddle.optimizer.AdamW(
        learning_rate=0.01, parameters=jp, multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    masters = [torch.tensor(a).to(torch.bfloat16).float() for a in p0]
    outs = [m.to(torch.bfloat16) for m in masters]
    ms = [torch.zeros(s) for s in SHAPES]
    vs = [torch.zeros(s) for s in SHAPES]
    for t, step in enumerate(gs, 1):
        for p, g in zip(jp, step):
            p.grad = Tensor(jnp.asarray(g).astype(jnp.bfloat16))
        jo.step()
        ad.adamw_eager_plain(
            masters, [torch.tensor(g).to(torch.bfloat16) for g in step], ms,
            vs, [0.01] * 3, [True] * 3, 0.9, 0.999, 1e-8, 0.01, t,
            clip=0.5, outs=outs)
    _close([m.numpy() for m in masters],
           [np.asarray(jo._accumulators[id(p)]["master"]) for p in jp])
    for o, m in zip(outs, masters):
        assert torch.equal(o, m.to(torch.bfloat16))


def test_adamw_eager_plain_nan_norm_poisons_the_clip():
    p = [torch.ones(3)]
    g = [torch.tensor([1.0, float("nan"), 0.0])]
    gn = ad.adamw_eager_plain(p, g, [torch.zeros(3)], [torch.zeros(3)],
                              [0.1], [False], 0.9, 0.999, 1e-8, 0.0, 1,
                              clip=1.0)
    assert torch.isnan(gn) and torch.isnan(p[0]).all()


def test_adamw_eager_cpu_route_is_the_plain_version():
    p0, gs = _data(12)
    a = [torch.tensor(x) for x in p0]
    b = [torch.tensor(x) for x in p0]
    st = [([torch.zeros(s) for s in SHAPES], [torch.zeros(s) for s in SHAPES])
          for _ in range(2)]
    for t, step in enumerate(gs, 1):
        g = [torch.tensor(x) for x in step]
        ad.adamw_eager(a, g, *st[0], [0.01] * 3, [True] * 3, 0.9, 0.999,
                       1e-8, 0.01, t, clip=1.0)
        ad.adamw_eager_plain(b, g, *st[1], [0.01] * 3, [True] * 3, 0.9,
                             0.999, 1e-8, 0.01, t, clip=1.0)
    _close([x.numpy() for x in a], [x.numpy() for x in b], rtol=0, atol=0)
