"""The training step's fused tier of the PyTorch port held against the JAX
package on the CPU, on the same seeded numpy inputs: the kernel-backed
ops (``fused_rms_norm`` / ``rms_norm`` on kernel A, ``swiglu`` and
``fused_bias_act`` on kernel B, ``cross_entropy``'s streamed case on
kernel C, the AdamW update on kernel D; on the CPU each runs its kernel's
plain version) with every optional operand on and off, values and
gradients; ``cross_entropy`` over its mode grid; the plain routes of A-D
against eager autograd (A-C) and the JAX update (D); and the plain
PyTorch ops of ``incubate.nn.functional`` (layer norms, dropout, the
matmul epilogues, the parameter-gradient accumulation).

Tolerances: f32 1e-5 relative (atol 1e-6 where values are O(1) and the
two frameworks reduce in another order); bf16 two units in the last place
of the reference at each element (the port and XLA round at the same
points but sum in another order); gradients in f32 only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate.nn import functional as JI  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TI  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import adamw as tadamw  # noqa: E402
from paddle_tpu_torch.ops import fused_norm as tfn  # noqa: E402
from paddle_tpu_torch.ops import swiglu as tsw  # noqa: E402
from paddle_tpu_torch.ops import token_ce as tce  # noqa: E402

RTOL = 1e-5
ATOL = 1e-6


def _np(x):
    """numpy of a torch tensor or a JAX-package Tensor: int8 as it is,
    anything else as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy() if x.dtype == torch.int8 else x.float().numpy()
    a = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _jt(a, dtype=None, grad=False):
    t = paddle.to_tensor(a)
    if dtype:
        t = t.astype(dtype)
    t.stop_gradient = not grad
    return t


def _tt(a, dtype=None, grad=False):
    t = torch.as_tensor(np.asarray(a))
    if dtype:
        t = t.to(getattr(torch, dtype))
    return t.requires_grad_(True) if grad else t


def _ulp(a):
    """One bf16 unit in the last place of |a|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -100))) - 7)


def _agree(got, want, dtype, extra=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= 2 * _ulp(want) + extra + 1e-30).all(), \
            np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- kernel A: fused_rms_norm / rms_norm ----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape,begin", [((3, 5, 24), 2), ((2, 3, 4, 6), 2),
                                         ((7, 13), 1)])
def test_fused_rms_norm_matches(dtype, bias, residual, quant, shape, begin):
    """Values (out and residual_out) of every operand combination, H on
    and off a multiple of 8, the normalized axes from begin_norm_axis;
    f32 gradients of x, the scale, the bias and the residual."""
    rng = np.random.default_rng(hash((bias, residual, quant, begin)) % 2**32)
    hid = int(np.prod(shape[begin:]))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[begin:])).astype(np.float32)
    nb = (0.1 * rng.standard_normal(shape[begin:])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[begin:])).astype(np.float32) \
        if bias else None
    r = rng.standard_normal(shape).astype(np.float32) if residual else None
    q = dict(quant_scale=0.5, quant_round_type=1, quant_max_bound=127,
             quant_min_bound=-127) if quant else {}
    grad = dtype == "float32" and not quant
    jx, jw = _jt(x, dtype, grad), _jt(w, None, grad)
    jb = None if b is None else _jt(b, dtype, grad)
    jr = None if r is None else _jt(r, dtype, grad)
    tx, tw = _tt(x, dtype, grad), _tt(w, None, grad)
    tb = None if b is None else _tt(b, dtype, grad)
    tr = None if r is None else _tt(r, dtype, grad)
    jo, jh = JI.fused_rms_norm(jx, jw, _jt(nb), 1e-5, begin, bias=jb,
                               residual=jr, **q)
    to, th = TI.fused_rms_norm(tx, tw, _tt(nb), 1e-5, begin, bias=tb,
                               residual=tr, **q)
    assert str(to.dtype).split(".")[-1] == str(jo.dtype).split(".")[-1]
    if quant:
        diff = np.abs(_np(to).astype(np.int32) - _np(jo).astype(np.int32))
        assert diff.max() <= 1          # a rounding tie apart at most
    else:
        _agree(to, jo, "float32" if dtype == "float32" else "bfloat16")
    _agree(th.detach(), jh, dtype)
    assert hid == int(np.prod(to.shape[begin:]))
    if grad:
        gy = rng.standard_normal(shape).astype(np.float32)
        gh = rng.standard_normal(shape).astype(np.float32)
        (jo * _jt(gy)).sum().__add__((jh * _jt(gh)).sum()).backward()
        ((to * _tt(gy)).sum() + (th * _tt(gh)).sum()).backward()
        for j, t in ((jx, tx), (jw, tw), (jb, tb), (jr, tr)):
            if t is not None:
                np.testing.assert_allclose(t.grad.numpy(), _np(j.grad),
                                           rtol=RTOL, atol=1e-5)


def test_fused_rms_norm_promotes_where_rms_norm_does_not():
    """fused_rms_norm's ``round(h * inv) * w`` promotes a bf16 activation
    to f32 against an f32 scale (the JAX rule); nn.RMSNorm's rms_norm casts
    the scale to bf16 and stays bf16. Both run kernel A."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    to, _ = TI.fused_rms_norm(_tt(x, "bfloat16"), _tt(w), None, 1e-6, 1)
    jo, _ = JI.fused_rms_norm(_jt(x, "bfloat16"), _jt(w), None, 1e-6, 1)
    assert to.dtype == torch.float32 and jo.dtype == paddle.float32
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-6, atol=1e-6)
    tn = TF.rms_norm(_tt(x, "bfloat16"), _tt(w), 1e-6)
    assert tn.dtype == torch.bfloat16
    _agree(tn, JF.rms_norm(_jt(x, "bfloat16"), _jt(w), 1e-6), "bfloat16")


# -- kernel B: swiglu / fused_bias_act -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["fused", "two", "broadcast"])
@pytest.mark.parametrize("im", [16, 13])
def test_swiglu_matches(dtype, form, im):
    rng = np.random.default_rng(im)
    x = rng.standard_normal((2, 5, 2 * im if form == "fused" else im)) \
        .astype(np.float32)
    y = None if form == "fused" else rng.standard_normal(
        (1, 5, im) if form == "broadcast" else (2, 5, im)).astype(np.float32)
    grad = dtype == "float32"
    jx, tx = _jt(x, dtype, grad), _tt(x, dtype, grad)
    jy = None if y is None else _jt(y, dtype, grad)
    ty = None if y is None else _tt(y, dtype, grad)
    jo, to = JI.swiglu(jx, jy), TI.swiglu(tx, ty)
    _agree(to.detach().float(), jo.astype("float32"), dtype)
    if grad:
        g = rng.standard_normal(to.shape).astype(np.float32)
        (jo * _jt(g)).sum().backward()
        (to * _tt(g)).sum().backward()
        for j, t in ((jx, tx), (jy, ty)):
            if t is not None:
                np.testing.assert_allclose(t.grad.numpy(), _np(j.grad),
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu", "gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_bias_act_matches(act, bias):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32) if bias else None
    jo = JI.fused_bias_act(_jt(x), None if b is None else _jt(b), act)
    to = TI.fused_bias_act(_tt(x), None if b is None else _tt(b), act)
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=RTOL, atol=ATOL)


# -- kernel C: cross_entropy ----------------------------------------------

CE_MODES = [
    dict(),
    dict(reduction="sum"),
    dict(reduction="none"),
    dict(label_smoothing=0.1),
    dict(label_smoothing=0.1, reduction="none"),
    dict(ignore_index=3),
    dict(soft_label=True),
    dict(soft_label=True, label_smoothing=0.2, reduction="sum"),
    dict(weight=True),
    dict(weight=True, reduction="none"),
    dict(weight=True, label_smoothing=0.1),
    dict(axis=1),
    dict(axis=1, reduction="sum", label_smoothing=0.1),
    dict(use_softmax=False),
    dict(use_softmax=False, reduction="none"),
    dict(labels_2d=True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", range(len(CE_MODES)))
def test_cross_entropy_modes_match(dtype, mode):
    """Values of every mode, and f32 gradients against the JAX function's
    (its eager backward takes jax.vjp). Rows labelled ignore_index (-100,
    or 3) count zero."""
    kw = dict(CE_MODES[mode])
    rng = np.random.default_rng(mode)
    n, c = 12, 11
    axis = kw.get("axis", -1)
    logits = (2 * rng.standard_normal((n, c, 3) if axis == 1 else (n, c))) \
        .astype(np.float32)
    if kw.pop("use_softmax", True) is False:
        logits = rng.dirichlet(np.ones(c), (n, 3) if axis == 1 else n) \
            .astype(np.float32)
        if axis == 1:
            logits = logits.transpose(0, 2, 1)
        kw["use_softmax"] = False
    if kw.get("soft_label"):
        labels = rng.dirichlet(np.ones(c), n).astype(np.float32)
    else:
        labels = rng.integers(0, c, (n, 3) if axis == 1 else n)
        if axis != 1:
            labels[[1, 6]] = kw.get("ignore_index", -100)
        if kw.pop("labels_2d", False):
            labels = labels[:, None]
    w = rng.uniform(0.5, 1.5, c).astype(np.float32) \
        if kw.pop("weight", False) else None
    grad = dtype == "float32"
    jx, tx = _jt(logits, dtype, grad), _tt(logits, dtype, grad)
    jo = JF.cross_entropy(jx, _jt(labels), weight=None if w is None
                          else _jt(w), **kw)
    to = TF.cross_entropy(tx, _tt(labels), weight=None if w is None
                          else _tt(w), **kw)
    assert str(to.dtype).split(".")[-1] == str(jo.dtype).split(".")[-1]
    tol = RTOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(to), _np(jo), rtol=tol, atol=tol * 0.1)
    if grad:
        g = rng.standard_normal(to.shape).astype(np.float32)
        (jo * _jt(g)).sum().backward()
        (to * _tt(g)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=RTOL,
                                   atol=ATOL)


def test_cross_entropy_streamed_case_takes_kernel_c(monkeypatch):
    """Softmax on, hard labels, last axis, no weight: every reduction and
    label smoothing go through kernel C's entry points (their plain
    versions here); the other modes do not."""
    calls = []
    fwd = tce.token_ce_fwd_plain
    monkeypatch.setattr(tce, "token_ce_fwd_plain",
                        lambda *a: calls.append(1) or fwd(*a))
    x = torch.randn(6, 9)
    lab = torch.randint(0, 9, (6,))
    for kw in (dict(), dict(reduction="sum"), dict(reduction="none"),
               dict(label_smoothing=0.1)):
        TF.cross_entropy(x, lab, **kw)
    assert len(calls) == 4
    TF.cross_entropy(x, lab, weight=torch.ones(9))
    TF.cross_entropy(x, torch.softmax(x, -1), soft_label=True)
    assert len(calls) == 4


# -- the plain routes of A-D ----------------------------------------------

def _eager_norm(x, w, res, eps, out_dtype):
    h = x if res is None else x + res
    hf = h.float()
    n = (hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + eps)).to(h.dtype)
    return n.to(out_dtype) * w.to(out_dtype), h


@pytest.mark.parametrize("kernel", ["A", "A_promote", "B", "C", "C_smooth"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_route_matches_eager_autograd(kernel, dtype):
    """Each kernel's plain backward (what the kernel computes, written
    out) against autograd through the eager forward it replaces, on the
    same inputs; bf16 within two units in the last place, f32 1e-5."""
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    if kernel.startswith("A"):
        out_dtype = torch.float32 if kernel == "A_promote" else dt
        x = _tt(rng.standard_normal((9, 24)), dtype, True)
        res = _tt(rng.standard_normal((9, 24)), dtype, True)
        w = _tt((1 + 0.1 * rng.standard_normal(24)).astype(np.float32),
                None, True)
        out, h = _eager_norm(x, w, res, 1e-6, out_dtype)
        gy = _tt(rng.standard_normal((9, 24))).to(out_dtype)
        gh = _tt(rng.standard_normal((9, 24)), dtype)
        torch.autograd.backward((out, h), (gy, gh))
        o2, h2, inv = tfn.rms_norm_fwd_plain(x.detach(), w.detach(), 1e-6,
                                             None, res.detach(), out_dtype)
        dh, dw = tfn.rms_norm_bwd_plain(gy, gh, h2, w.detach(), inv,
                                        out_dtype)
        pairs = ((o2, out), (dh, x.grad), (dh, res.grad), (dw, w.grad))
    elif kernel == "B":
        gu = _tt(rng.standard_normal((7, 2, 10)).reshape(7, 20), dtype, True)
        out = torch.nn.functional.silu(gu[:, :10]) * gu[:, 10:]
        g = _tt(rng.standard_normal((7, 10)), dtype)
        out.backward(g)
        dgu = torch.empty_like(gu)
        d = gu.detach()
        tsw.swiglu_bwd_plain(g, d[:, :10], d[:, 10:], dgu[:, :10],
                             dgu[:, 10:])
        pairs = ((tsw.swiglu_fwd_plain(d[:, :10], d[:, 10:]), out),
                 (dgu, gu.grad))
    else:
        eps = 0.1 if kernel == "C_smooth" else 0.0
        x = _tt(2 * rng.standard_normal((8, 19)), dtype, True)
        lab = torch.as_tensor(rng.integers(0, 19, 8))
        lab[2] = -100
        loss, stats, totals = tce.token_ce_fwd_plain(x, lab, -100, eps)
        totals[2].backward()
        dx = tce.token_ce_bwd_plain(x.detach(), lab, stats.detach(),
                                    torch.tensor(1.0), totals.detach(),
                                    -100, eps, "mean")
        # autograd rounds each of the three terms (softmax, onehot and
        # smoothing) to bf16 before it sums them, the kernel once: allow
        # two units of the largest term, g / n
        extra = 2 * _ulp(1.0 / 7) if dtype == "bfloat16" else 0.0
        pairs = ((dx, x.grad),)
    for got, want in pairs:
        _agree(got.detach().float(), want.detach().float(),
               dtype if got.dtype != torch.float32 or dtype == "float32"
               else "bfloat16", extra if kernel.startswith("C") else 0.0)


@pytest.mark.parametrize("clip", [0.5, 100.0, 0.0])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_adamw_plain_route_matches_jax(clip, gdtype):
    """Kernel D's plain version (the foreach passes) against the JAX
    ``_adamw`` on the same inputs, f32 or bf16 grads (upcast)."""
    rng = np.random.default_rng(3)
    shapes = [(6, 5), (4, 3), (5,), (3,)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if gdtype == "bfloat16":
        gs = [torch.tensor(g).bfloat16().float().numpy() for g in gs]
    ms = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    vs = [np.abs(0.1 * rng.standard_normal(s)).astype(np.float32)
          for s in shapes]
    names = [f"t{i}" for i in range(len(shapes))]
    jp, js, jg = jpre._adamw(
        dict(zip(names, map(jnp.asarray, ps))),
        dict(zip(names, map(jnp.asarray, gs))),
        {"m": dict(zip(names, map(jnp.asarray, ms))),
         "v": dict(zip(names, map(jnp.asarray, vs))),
         "count": jnp.asarray(2, jnp.int32)}, 1e-2, 0.9, 0.95, 1e-8, 0.1,
        clip)
    tp = [torch.tensor(a) for a in ps]
    tm = [torch.tensor(a) for a in ms]
    tv = [torch.tensor(a) for a in vs]
    tg = tadamw.adamw_step(tp, [_tt(g, gdtype) for g in gs], tm, tv,
                           [p.dim() >= 2 for p in tp], 1e-2, 0.9, 0.95,
                           1e-8, 0.1, clip, 3)
    assert abs(float(tg) - float(jg)) <= RTOL * float(jg)
    for i, n in enumerate(names):
        for got, want in ((tp[i], jp[n]), (tm[i], js["m"][n]),
                          (tv[i], js["v"][n])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)


# -- the plain PyTorch ops of incubate.nn.functional -----------------------

@pytest.mark.parametrize("case", ["ln", "ln_residual", "ln_sum_only",
                                  "bdrln", "matmul_bias", "linear_t",
                                  "act_gelu", "act_relu", "act_none",
                                  "grad_add", "grad_add_acc"])
def test_plain_incubate_ops_match(case):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    r = rng.standard_normal((3, 4, 8)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    y = rng.standard_normal((8, 5)).astype(np.float32)
    b5 = rng.standard_normal(5).astype(np.float32)

    def both(fn_j, fn_t):
        want, got = fn_j(_jt), fn_t(_tt)
        want = want if isinstance(want, (tuple, list)) else (want,)
        got = got if isinstance(got, (tuple, list)) else (got,)
        assert len(want) == len(got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL,
                                       atol=1e-5)

    if case.startswith("ln"):
        kw = dict(residual_alpha=0.5, begin_norm_axis=2)

        def call(mod, t):
            extra = dict(bias=t(b), residual=t(r)) if case != "ln" else {}
            if case == "ln_sum_only":
                return mod.fused_layer_norm(t(x), None, None, 1e-5, **kw,
                                            **extra)
            return mod.fused_layer_norm(t(x), t(s), t(b), 1e-5, **kw,
                                        **extra)
        both(lambda t: call(JI, t), lambda t: call(TI, t))
    elif case == "bdrln":
        both(lambda t: JI.fused_bias_dropout_residual_layer_norm(
                 t(x), t(r), t(b), t(s), t(b), 0.0, 1e-5),
             lambda t: TI.fused_bias_dropout_residual_layer_norm(
                 t(x), t(r), t(b), t(s), t(b), 0.0, 1e-5))
    elif case == "matmul_bias":
        both(lambda t: JI.fused_matmul_bias(t(x), t(y), t(b5)),
             lambda t: TI.fused_matmul_bias(t(x), t(y), t(b5)))
    elif case == "linear_t":
        both(lambda t: JI.fused_linear(t(x), t(y.T.copy()), t(b5),
                                       transpose_weight=True),
             lambda t: TI.fused_linear(t(x), t(y.T.copy()), t(b5),
                                       transpose_weight=True))
    elif case.startswith("act"):
        act = case[4:]
        both(lambda t: JI.fused_linear_activation(t(x), t(y), t(b5),
                                                  activation=act),
             lambda t: TI.fused_linear_activation(t(x), t(y), t(b5),
                                                  activation=act))
    else:
        dout = rng.standard_normal((3, 4, 5)).astype(np.float32)
        acc = case == "grad_add_acc"
        dw = rng.standard_normal((8, 5)).astype(np.float32)

        def call(mod, t):
            return mod.fused_linear_param_grad_add(
                t(x), t(dout), t(dw) if acc else None,
                t(b5) if acc else None)
        both(lambda t: call(JI, t), lambda t: call(TI, t))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keep_rate_scaling_and_exact_cases(mode):
    """The RNGs differ, so dropout is held to its keep rate, its scaling
    and its exact cases (p = 0, inference), not element by element."""
    rng = np.random.default_rng(17)
    x = rng.uniform(1, 2, (64, 128)).astype(np.float32)
    y = rng.standard_normal((64, 128)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for training, p in ((True, 0.0), (False, 0.3)):
        want = JI.fused_dropout_add(_jt(x), _jt(y), p=p, training=training,
                                    mode=mode)
        got = TI.fused_dropout_add(_tt(x), _tt(y), p=p, training=training,
                                   mode=mode, generator=gen)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
    p = 0.25
    got = (TI.fused_dropout_add(_tt(x), _tt(y), p=p, mode=mode,
                                generator=gen) - _tt(y)).numpy()
    kept = got != 0
    assert abs(kept.mean() - (1 - p)) < 0.01           # 8192 draws
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(got[kept], x[kept] * scale, rtol=1e-6)
    got = TI.fused_bias_dropout_residual_layer_norm(
        _tt(x), _tt(y), dropout_rate=p, generator=gen)
    assert got.shape == x.shape and torch.isfinite(got).all()


# -- the route plans of A's backward and C's forward (shapes alone) --------

# every width a register route takes, its edges, Llama-7B's 4096 and past
NORM_WIDTHS = [1, 7, 8, 9, 255, 256, 257, 511, 512, 513, 1000, 1023, 1024,
               1025, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 8200,
               12288, 16384, 58000]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hid", NORM_WIDTHS)
def test_norm_bwd_plan_covers_every_row_and_column_once(dtype, hid):
    """Kernel A's backward plan: a route for every H, the register routes
    for rows of 16-byte accesses up to 8 warps of 64-byte lanes for 16-bit
    rows (8192 columns, so Llama-7B's 4096 stays on one) and one warp for
    f32 (512), the fewest warps whose lanes hold every column (a row's
    warps hold columns [0, warps * warp_cols) once each), every slot of
    the grid walking rows s, s + slots, ..., and the same shape giving the
    same grid."""
    dt = getattr(torch, dtype)
    wide = 4 if dt == torch.float32 else 2
    vec = hid % 8 == 0
    warp_cols = 1024 * 2 // wide
    reg_cols = warp_cols * (8 if wide == 2 else 1)
    for r, sms in ((1, 132), (7, 132), (16383, 132), (16384, 132),
                   (100, 7)):
        plan = tfn.bwd_plan(r, hid, dt, sms, vec)
        assert plan == tfn.bwd_plan(r, hid, dt, sms, vec)
        assert tfn.bwd_plan(r, hid, dt, sms, False)["route"] == "block"
        assert plan["route"] == ("block" if hid > reg_cols or not vec
                                 else "warp" if hid <= warp_cols
                                 else "warps")
        wpr = plan["warps_per_row"]
        if wpr:
            assert plan["warp_cols"] == warp_cols
            assert wpr & (wpr - 1) == 0 and wpr * warp_cols >= hid
            assert wpr == 1 or wpr // 2 * warp_cols < hid
            assert plan["warps_per_block"] == max(4, wpr)
            assert plan["groups"] * wpr == plan["warps_per_block"]
            assert plan["blocks"] * plan["warps_per_block"] <= max(
                tfn.WARPS_PER_SM * sms, plan["warps_per_block"])
        else:
            assert plan["warps_per_block"] == tfn.BLOCK_THREADS // 32
            assert plan["groups"] == 1 and plan["warp_cols"] == 0
        assert 1 <= plan["blocks"] and plan["slots"] == \
            plan["blocks"] * plan["groups"]
        # no slot idle that a row could have used
        assert plan["slots"] < r + plan["groups"]
        assert plan["partial_bytes"] == plan["blocks"] * hid * 4


CE_VOCABS = [1, 7, 8, 4095, 4096, 4097, 8192, 16384, 16385, 32000, 32001,
             32768, 32769, 50257, 65536, 65537, 128256, 131072, 131073,
             262144, 262145]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("vocab", CE_VOCABS)
def test_ce_fwd_plan_covers_every_column_once(dtype, vocab):
    """Kernel C's forward plan: a route for every V (a row on one block up
    to 64 KB, on a cluster of 2-8 blocks up to 512 KB, two passes past
    that), one compiled chunk count per power-of-two bucket, the fewest
    chunks and blocks whose threads hold the row (a row's blocks hold its
    16-byte chunks [0, 512 * chunks * cluster) once each, and block 0's
    first threads the at most 7 + 7 elements of its head and tail), and
    one grid per shape."""
    dt = getattr(torch, dtype)
    size = 4 if dt == torch.float32 else 2
    plan = tce.fwd_plan(4099, vocab, dt)
    assert plan == tce.fwd_plan(4099, vocab, dt)
    row = vocab * size
    assert plan["route"] == ("rows" if row <= 65536 else "cluster"
                             if row <= 8 * 65536 else "two-pass")
    if plan["route"] != "two-pass":
        nc, cl = plan["chunks"], plan["cluster"]
        assert nc in (1, 2, 4, 8) and nc * size * 8 <= 128
        assert cl in (1, 2, 4, 8) and plan["threads"] == 512
        assert 512 * 8 * nc * cl >= vocab
        assert cl == 1 or (512 * 8 * nc * cl // 2 < vocab
                           and nc * size == 16)
        assert cl > 1 or nc == 1 or 512 * 8 * nc // 2 < vocab
        assert plan["blocks"] == 4099 * cl and plan["block_bytes"] <= 65536


def test_route_plans_reach_every_limit():
    """Up to the wrappers' limits every H and V maps to a route: the
    register routes' last widths and one past them, and V up to the
    largest the forward takes (2**31 - 1)."""
    for dt, last_h, wpr in ((torch.float32, 512, 1),
                            (torch.bfloat16, 8192, 8)):
        assert tfn.bwd_plan(5, last_h, dt, 132)["warps_per_row"] == wpr
        assert tfn.bwd_plan(5, last_h + 1, dt, 132)["route"] == "block"
    for dt, last_v in ((torch.float32, 131072), (torch.bfloat16, 262144)):
        assert tce.fwd_plan(3, last_v, dt)["cluster"] == 8
        assert tce.fwd_plan(3, last_v + 1, dt)["route"] == "two-pass"
        assert tce.fwd_plan(3, 2 ** 31 - 1, dt)["route"] == "two-pass"
