"""The PyTorch port's ``nn`` for the vision path held against the JAX
package on the CPU, part 1: the pools (1-3D max / avg / lp, adaptive,
unpool, fractional), the batch / instance / local-response / spectral
norms and their layers with ``SyncBatchNorm`` over two thread ranks, the
activations and the containers (part 2, the common functionals, losses,
convolutions and initializers: ``tests/test_torch_nn_vision_ops.py``).

The traps are pinned each by a test: ``ceil_mode`` at in = 5, k = 2,
s = 2, p = 1 (four windows, the last wholly in the padding: -inf, NaN and
0, as the JAX function gives them), exclusive and inclusive averages
with padding, a "SAME" average, the max-pool mask, adaptive bins on
sizes that do not divide, and BatchNorm's running statistics after two
training steps and then eval (momentum 0.9, the biased variance).

Inputs come from numpy with a seed; the JAX functions run eagerly (or
under ``jax.grad`` for the input gradients). Tolerance: float32 within
1e-5 of the reference's largest magnitude (at least 1), as
``tests/test_torch_nn_layers.py`` holds the other layers.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.jit.functional import state_arrays  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.distributed import DataParallel  # noqa: E402
from paddle_tpu_torch.models.state import load_numpy  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.testing import ThreadRankSet  # noqa: E402

ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _t(x, grad=False):
    t = torch.as_tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _j(x):
    return paddle.to_tensor(np.asarray(x))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, msg=""):
    """|got - want| <= atol * max(1, max finite |want|) elementwise; NaN
    and infinities must sit in the same places."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                               err_msg=msg)


def _grads(jfn, tfn, xs, seed=0):
    """Outputs of jfn / tfn (jax arrays -> jax array; torch tensors ->
    tensor) on the float32 arrays ``xs``, and the gradients of sum(out * g)
    for each input, both sides (the JAX side's forward and gradient each
    one jitted program)."""
    jout = jax.jit(jfn)(*[jnp.asarray(x) for x in xs])
    g = _rng(seed + 100).standard_normal(np.shape(jout)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                              argnums=tuple(range(len(xs)))))(
        *[jnp.asarray(x) for x in xs])
    leaves = [_t(x, grad=True) for x in xs]
    tout = tfn(*leaves)
    (tout * _t(g)).sum().backward()
    return jout, jgrads, tout, [x.grad for x in leaves]


def _check(jf, tf, xs, atol=ATOL, seed=0):
    """jf(*paddle tensors) / tf(*torch tensors): outputs and every input
    gradient."""
    jout, jg, tout, tg = _grads(
        lambda *a: jf(*[paddle.to_tensor(x) for x in a]).data, tf, xs, seed)
    _close(tout, jout, atol, "output")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, atol, f"input {i} grad")
    return tout


def _pair(jlayer, tlayer):
    """The JAX layer's parameters and buffers into the port's (names and
    shapes equal), both in eval."""
    jlayer.eval()
    tlayer.eval()
    load_numpy(tlayer, state_arrays(jlayer))
    return tlayer


# -- pooling: the traps ----------------------------------------------------

def test_ceil_mode_extends_the_high_pad_as_jax():
    """in=5, k=2, s=2, p=1: four windows in JAX (torch's own ceil_mode
    gives three); the last lies wholly in the padding."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5)
    got_max = TF.max_pool1d(_t(x), 2, 2, 1, ceil_mode=True)
    got_exc = TF.avg_pool1d(_t(x), 2, 2, 1, ceil_mode=True)
    got_inc = TF.avg_pool1d(_t(x), 2, 2, 1, exclusive=False, ceil_mode=True)
    assert torch.nn.functional.max_pool1d(_t(x), 2, 2, 1,
                                          ceil_mode=True).shape[-1] == 3
    np.testing.assert_array_equal(_np(got_max),
                                  [[[0.0, 2.0, 4.0, -np.inf]]])
    np.testing.assert_array_equal(_np(got_exc), [[[0.0, 1.5, 3.5, np.nan]]])
    np.testing.assert_array_equal(_np(got_inc), [[[0.0, 1.5, 3.5, 0.0]]])
    _close(got_max, JF.max_pool1d(_j(x), 2, 2, 1, ceil_mode=True))
    _close(got_exc, JF.avg_pool1d(_j(x), 2, 2, 1, ceil_mode=True))
    _close(got_inc, JF.avg_pool1d(_j(x), 2, 2, 1, exclusive=False,
                                  ceil_mode=True))
    # width 6, k=3, s=2, p=0: the two agree
    y = np.arange(1, 7, dtype=np.float32).reshape(1, 1, 6)
    np.testing.assert_array_equal(
        _np(TF.max_pool1d(_t(y), 3, 2, 0, ceil_mode=True)), [[[3, 5, 6]]])


POOL_CASES = [
    # kind, nd, kernel, stride, padding, ceil_mode, exclusive
    ("max", 2, 3, 2, 1, False, True),          # ResNet's stem pool
    ("max", 2, 3, 2, 0, True, True),
    ("max", 2, (2, 3), (2, 1), (1, 1), True, True),
    ("max", 2, 2, 2, 1, False, True),          # a pad torch takes itself
    ("max", 1, 3, 2, 1, True, True),
    ("max", 3, 2, 2, 1, True, True),
    ("avg", 2, 3, 2, 1, False, True),          # exclusive with padding
    ("avg", 2, 3, 2, 1, False, False),         # inclusive with padding
    ("avg", 2, 3, 2, 1, True, False),          # inclusive, ceil left out
    ("avg", 2, 3, 2, 1, True, True),
    ("avg", 2, 2, 2, 0, False, True),          # DenseNet's transition
    ("avg", 1, 3, 2, 1, True, True),
    ("avg", 3, 3, 2, 1, True, False),
    ("max", 2, 3, 2, "SAME", False, True),
    ("avg", 2, 3, 2, "SAME", False, True),     # divides by the kernel
    ("avg", 2, 3, 1, "VALID", False, True),
]


@pytest.mark.parametrize("kind,nd,k,s,p,ceil,exc", POOL_CASES)
def test_pools_match(kind, nd, k, s, p, ceil, exc):
    shape = {1: (2, 3, 11), 2: (2, 3, 9, 8), 3: (1, 2, 5, 6, 7)}[nd]
    x = _rng(10).standard_normal(shape).astype(np.float32)
    name = f"{kind}_pool{nd}d"
    jf, tf = getattr(JF, name), getattr(TF, name)
    if kind == "max":
        kw = dict(ceil_mode=ceil)
    else:
        kw = dict(ceil_mode=ceil, exclusive=exc)
    _check(lambda a: jf(a, k, s, p, **kw), lambda a: tf(a, k, s, p, **kw),
           [x])


def test_avg_divisor_override_and_channels_last():
    x = _rng(11).standard_normal((2, 3, 7, 7)).astype(np.float32)
    _check(lambda a: JF.avg_pool2d(a, 3, 2, 1, divisor_override=4),
           lambda a: TF.avg_pool2d(a, 3, 2, 1, divisor_override=4), [x])
    xl = np.moveaxis(x, 1, -1)
    for fn in (TF.max_pool2d, TF.avg_pool2d):
        _close(fn(_t(xl), 3, 2, 1, data_format="NHWC"),
               np.moveaxis(_np(fn(_t(x), 3, 2, 1)), 1, -1))


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_mask_matches(k, s, p):
    """int32 flat indices into the unpadded plane, as the JAX mask."""
    x = _rng(12).standard_normal((2, 3, 7, 6)).astype(np.float32)
    tout, tmask = TF.max_pool2d(_t(x), k, s, p, return_mask=True)
    jout, jmask = JF.max_pool2d(_j(x), k, s, p, return_mask=True)
    _close(tout, jout)
    assert tmask.dtype == torch.int32
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    # the mask unpools back: each maximum at its own place
    back = TF.max_unpool2d(tout, tmask, k, s, p, output_size=x.shape)
    want = JF.max_unpool2d(jout, jmask, k, s, p, output_size=x.shape)
    _close(back, want)


@pytest.mark.parametrize("nd,size,out", [
    (1, (2, 3, 10), 4), (2, (2, 3, 7, 9), (3, 4)), (2, (1, 2, 8, 8), 1),
    (2, (2, 2, 14, 14), (7, 7)), (3, (1, 2, 5, 7, 6), (2, 3, 4))])
def test_adaptive_pools_match(nd, size, out):
    """Bins from floor(i n / o) to ceil((i + 1) n / o), sizes that do not
    divide included."""
    x = _rng(13).standard_normal(size).astype(np.float32)
    for kind in ("avg", "max"):
        name = f"adaptive_{kind}_pool{nd}d"
        _check(lambda a: getattr(JF, name)(a, out),
               lambda a: getattr(TF, name)(a, out), [x])
    if nd in (1, 3):   # the JAX masks of 1-D and 3-D
        name = f"adaptive_max_pool{nd}d"
        _, tm = getattr(TF, name)(_t(x), out, return_mask=True)
        _, jm = getattr(JF, name)(_j(x), out, return_mask=True)
        np.testing.assert_array_equal(_np(tm), _np(jm))


@pytest.mark.parametrize("nd,norm,k,s,p,ceil", [
    (1, 2.0, 3, 2, 0, False), (2, 3.0, 2, 2, 1, True),
    (2, 1.5, 3, 1, 0, False)])
def test_lp_pools_match(nd, norm, k, s, p, ceil):
    shape = (2, 3, 9) if nd == 1 else (2, 2, 7, 8)
    x = (0.1 + np.abs(_rng(14).standard_normal(shape))).astype(np.float32)
    name = f"lp_pool{nd}d"
    _check(lambda a: getattr(JF, name)(a, norm, k, s, p, ceil),
           lambda a: getattr(TF, name)(a, norm, k, s, p, ceil), [x])


@pytest.mark.parametrize("nd,u", [(2, 0.0), (2, 0.77), (3, 0.3)])
def test_fractional_max_pools_match(nd, u):
    shape = (2, 3, 11, 10) if nd == 2 else (1, 2, 6, 7, 6)
    out = (5, 4) if nd == 2 else (3, 3, 2)
    x = _rng(15).standard_normal(shape).astype(np.float32)
    name = f"fractional_max_pool{nd}d"
    _check(lambda a: getattr(JF, name)(a, out, random_u=u),
           lambda a: getattr(TF, name)(a, out, random_u=u), [x])
    _, tm = getattr(TF, name)(_t(x), out, random_u=u, return_mask=True)
    _, jm = getattr(JF, name)(_j(x), out, random_u=u, return_mask=True)
    np.testing.assert_array_equal(_np(tm), _np(jm))
    # the port's own draw: explicit generators give the same windows
    a = getattr(TF, name)(_t(x), out,
                          generator=torch.Generator().manual_seed(3))
    b = getattr(TF, name)(_t(x), out,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("nd", [1, 3])
def test_max_unpool_matches(nd):
    shape = (2, 3, 6) if nd == 1 else (1, 2, 2, 3, 2)
    x = _rng(16).standard_normal(shape).astype(np.float32)
    idx = np.stack([np.random.default_rng(i).permutation(
        int(np.prod([2 * d for d in shape[2:]])))[:int(np.prod(shape[2:]))]
        for i in range(shape[0] * shape[1])]).reshape(shape).astype(np.int32)
    name = f"max_unpool{nd}d"
    _close(getattr(TF, name)(_t(x), _t(idx), 2),
           getattr(JF, name)(_j(x), _j(idx), 2))


POOL_LAYERS = [
    ("MaxPool1D", (3, 2, 1), (2, 3, 9)),
    ("MaxPool2D", (3, 2, 1), (2, 3, 8, 8)),
    ("MaxPool3D", (2, 2, 0), (1, 2, 4, 6, 6)),
    ("AvgPool1D", (3, 2, 1), (2, 3, 9)),
    ("AvgPool2D", (3, 2, 1), (2, 3, 8, 8)),
    ("AvgPool3D", (2, 2, 0), (1, 2, 4, 6, 6)),
    ("AdaptiveAvgPool1D", (3,), (2, 3, 10)),
    ("AdaptiveAvgPool2D", ((2, 3),), (2, 3, 7, 8)),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 5, 6, 7)),
    ("AdaptiveMaxPool1D", (3,), (2, 3, 10)),
    ("AdaptiveMaxPool2D", (3,), (2, 3, 7, 8)),
    ("AdaptiveMaxPool3D", (2,), (1, 2, 5, 6, 7)),
    ("LPPool1D", (2.0, 3, 2), (2, 3, 9)),
    ("LPPool2D", (2.0, 2, 2), (2, 3, 8, 8)),
    ("FractionalMaxPool2D", ((4, 4), None, 0.4), (2, 3, 9, 9)),
    ("FractionalMaxPool3D", ((2, 3, 3), None, 0.4), (1, 2, 6, 7, 7)),
]


@pytest.mark.parametrize("name,args,shape", POOL_LAYERS)
def test_pool_layers_match(name, args, shape):
    x = np.abs(_rng(17).standard_normal(shape)).astype(np.float32) + 0.1
    _close(getattr(nn, name)(*args)(_t(x)), getattr(jnn, name)(*args)(_j(x)))


def test_pool_layers_pass_every_argument():
    """The port's layers pass what they take (some JAX layers drop
    ``ceil_mode`` or ``exclusive``: ROADMAP Queue 3)."""
    x = _t(_rng(18).standard_normal((1, 2, 5, 5)).astype(np.float32))
    assert nn.AvgPool2D(2, 2, 1, ceil_mode=True, exclusive=False)(x).shape \
        == TF.avg_pool2d(x, 2, 2, 1, ceil_mode=True).shape
    _close(nn.AvgPool2D(3, 2, 1, exclusive=False)(x),
           TF.avg_pool2d(x, 3, 2, 1, exclusive=False))
    out, mask = nn.MaxPool2D(2, 2, return_mask=True)(x)
    _close(nn.MaxUnPool2D(2, 2, output_size=(5, 5))(out, mask),
           JF.max_unpool2d(_j(_np(out)), _j(_np(mask)), 2, 2,
                           output_size=(5, 5)))


# -- norms ---------------------------------------------------------------

@pytest.mark.parametrize("shape,fmt", [((4, 3, 5, 6), "NCHW"),
                                       ((6, 5), "NCHW"),
                                       ((4, 3, 7), "NCL"),
                                       ((2, 3, 4, 5, 3), "NCDHW"),
                                       ((4, 5, 6, 3), "NHWC")])
def test_batch_norm_running_stats_two_steps_then_eval(shape, fmt):
    """Two training calls update the running statistics as m * running +
    (1 - m) * batch with the biased variance; eval normalises by them;
    outputs and every gradient of the training call as JAX's."""
    rng = _rng(20)
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rm = (0.2 * rng.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.3 * rng.random(c)).astype(np.float32)
    jrm, jrv, trm, trv = _j(rm), _j(rv), _t(rm.copy()), _t(rv.copy())
    for step in range(2):
        x = (2 + 3 * rng.standard_normal(shape)).astype(np.float32)
        jout = JF.batch_norm(_j(x), jrm, jrv, _j(w), _j(b), training=True,
                             momentum=0.9, data_format=fmt)
        tout = TF.batch_norm(_t(x), trm, trv, _t(w), _t(b), training=True,
                             momentum=0.9, data_format=fmt)
        _close(tout, jout, msg=f"step {step}")
        _close(trm, jrm, msg="running mean")
        _close(trv, jrv, msg="running variance")
    _check(lambda a, w_, b_: JF.batch_norm(
               a, paddle.to_tensor(rm), paddle.to_tensor(rv), w_, b_,
               training=True, data_format=fmt),
           lambda a, w_, b_: TF.batch_norm(
               a, None, None, w_, b_, training=True, data_format=fmt),
           [x, w, b])
    y = rng.standard_normal(shape).astype(np.float32)
    _close(TF.batch_norm(_t(y), trm, trv, _t(w), _t(b), data_format=fmt),
           JF.batch_norm(_j(y), jrm, jrv, _j(w), _j(b), data_format=fmt))


@pytest.mark.parametrize("cls,shape", [("BatchNorm2D", (4, 3, 5, 5)),
                                       ("BatchNorm1D", (8, 6)),
                                       ("BatchNorm3D", (2, 3, 3, 4, 4)),
                                       ("BatchNorm", (4, 3, 5, 5))])
def test_batch_norm_layers_match(cls, shape):
    rng = _rng(21)
    c = shape[1]
    jl = getattr(jnn, cls)(c)
    tl = getattr(nn, cls)(c, device="cpu")
    for p in jl.parameters():
        p.set_value(p.numpy() + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32))
    params, buffers = state_arrays(jl)
    assert sorted(buffers) == ["_mean", "_variance"]
    load_numpy(tl, (params, buffers))
    for _ in range(2):
        x = (1 + 2 * rng.standard_normal(shape)).astype(np.float32)
        _close(tl(_t(x)), jl(_j(x)))
    _close(tl._mean, jl._mean)
    _close(tl._variance, jl._variance)
    jl.eval()
    tl.eval()
    x = rng.standard_normal(shape).astype(np.float32)
    _close(tl(_t(x)), jl(_j(x)))
    assert nn.BatchNorm2D(3, weight_attr=False, device="cpu").weight is None


def _sync_batch_norm_over_two_ranks(via):
    """Two thread ranks, each half of the batch: the output, the running
    statistics and the input gradient equal the JAX BatchNorm over the
    whole batch (its single controller reduces in XLA). The group is the
    layer's own (``via="layer"``), or the one of the ``DataParallel``
    that wraps it."""
    rng = _rng(22)
    x = (1 + 2 * rng.standard_normal((8, 4, 3, 3))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jl = jnn.BatchNorm2D(4)
    for p in jl.parameters():
        p.set_value(p.numpy() + 0.2 * rng.standard_normal(4).astype(
            np.float32))
    params, buffers = state_arrays(jl)
    jx = _j(x)
    jx.stop_gradient = False
    jout = jl(jx)
    (jout * _j(g)).sum().backward()
    jgrad = _np(jx.grad)

    def rank(r, group):
        tl = nn.SyncBatchNorm(4, group=group if via == "layer" else None,
                              device="cpu")
        load_numpy(tl, (params, buffers))
        net = tl if via == "layer" else DataParallel(tl, group=group)
        assert tl.group is group
        xs = _t(x[4 * r:4 * r + 4], grad=True)
        out = net(xs)
        (out * _t(g[4 * r:4 * r + 4])).sum().backward()
        if via == "data_parallel":
            net.cleanup()
        return out.detach(), xs.grad, tl._mean.clone(), tl._variance.clone()

    got = ThreadRankSet(2, rank, timeout=60).join(120)
    for r in range(2):
        out, grad, mean, var = got[r]
        _close(out, _np(jout)[4 * r:4 * r + 4])
        _close(grad, jgrad[4 * r:4 * r + 4])
        _close(mean, jl._mean)
        _close(var, jl._variance)


def test_sync_batch_norm_over_two_ranks_equals_jax_batch_norm():
    _sync_batch_norm_over_two_ranks("layer")


def test_sync_batch_norm_takes_the_data_parallel_group():
    _sync_batch_norm_over_two_ranks("data_parallel")


def test_convert_sync_batchnorm_keeps_weights_and_stats():
    net = nn.Sequential(nn.Conv2D(3, 4, 3, device="cpu"),
                        nn.BatchNorm2D(4, device="cpu"))
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
        net[1].weight.fill_(2.0)
    got = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(got[1], nn.SyncBatchNorm)
    assert float(got[1]._mean[0]) == 0.5 and float(got[1].weight[0]) == 2.0
    assert sorted(dict(got.named_parameters())) == \
        sorted(dict(net.named_parameters()))


@pytest.mark.parametrize("shape", [(2, 3, 7), (2, 3, 4, 5), (1, 2, 3, 4, 5)])
def test_instance_norm_matches(shape):
    rng = _rng(23)
    c = shape[1]
    x = (1 + 2 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    _check(lambda a, w_, b_: JF.instance_norm(a, weight=w_, bias=b_),
           lambda a, w_, b_: TF.instance_norm(a, weight=w_, bias=b_),
           [x, w, b])
    cls = {3: "InstanceNorm1D", 4: "InstanceNorm2D", 5: "InstanceNorm3D"}[
        len(shape)]
    jl, tl = getattr(jnn, cls)(c), getattr(nn, cls)(c, device="cpu")
    _pair(jl, tl)
    _close(tl(_t(x)), jl(_j(x)))
    xl = np.moveaxis(x, 1, -1)
    _close(TF.instance_norm(_t(xl), data_format="NHWC"),
           np.moveaxis(_np(TF.instance_norm(_t(x))), 1, -1))


@pytest.mark.parametrize("size", [3, 4, 5])
def test_local_response_norm_matches(size):
    x = _rng(24).standard_normal((2, 7, 4, 3)).astype(np.float32)
    _check(lambda a: JF.local_response_norm(a, size, 1e-2, 0.75, 2.0),
           lambda a: TF.local_response_norm(a, size, 1e-2, 0.75, 2.0), [x])
    _close(nn.LocalResponseNorm(size, 1e-2)(_t(x)),
           jnn.LocalResponseNorm(size, 1e-2)(_j(x)))


def test_spectral_norm_matches():
    """weight / sigma over two power iterations from the same u / v
    (numpy's generators 0 and 1, as the JAX layer draws them); training
    writes the new estimates back, eval does not."""
    w = _rng(25).standard_normal((6, 4, 3)).astype(np.float32)
    jl = jnn.SpectralNorm(w.shape, dim=1, power_iters=2)
    tl = nn.SpectralNorm(w.shape, dim=1, power_iters=2, device="cpu")
    params, _ = state_arrays(jl)
    assert sorted(params) == ["weight_u", "weight_v"]
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == \
        {n: tuple(a.shape) for n, a in params.items()}
    _close(tl.weight_u, params["weight_u"], 0.0)
    _close(tl(_t(w)), jl(_j(w)))
    _close(tl.weight_u, jl.weight_u)
    _close(tl.weight_v, jl.weight_v)
    jl.eval()
    tl.eval()
    u = tl.weight_u.clone()
    _close(tl(_t(w)), jl(_j(w)))
    assert torch.equal(tl.weight_u, u)


# -- activations ---------------------------------------------------------

ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("silu", {}),
    ("swish", {}), ("hardsigmoid", {}), ("hardsigmoid", dict(slope=0.2,
                                                           offset=0.4)),
    ("hardswish", {}), ("hardtanh", dict(min=-0.5, max=0.7)),
    ("hardshrink", dict(threshold=0.3)), ("softshrink", dict(threshold=0.3)),
    ("tanhshrink", {}), ("thresholded_relu", dict(threshold=0.2)),
    ("leaky_relu", dict(negative_slope=0.1)), ("elu", dict(alpha=0.7)),
    ("selu", {}), ("celu", dict(alpha=1.3)), ("mish", {}),
    ("softplus", dict(beta=2.0, threshold=5.0)), ("softsign", {}),
    ("tanh", {}), ("softmax", dict(axis=1)), ("log_softmax", dict(axis=-1)),
    ("log_sigmoid", {}), ("glu", dict(axis=1)), ("maxout", dict(groups=2)),
]


@pytest.mark.parametrize("name,kw", ACTIVATIONS)
def test_activations_match(name, kw):
    x = (3 * _rng(30).standard_normal((3, 8, 5))).astype(np.float32)
    _check(lambda a: getattr(JF, name)(a, **kw),
           lambda a: getattr(TF, name)(a, **kw), [x])


def test_hardsigmoid_keeps_paddles_constants():
    x = _t(np.linspace(-4, 4, 101).astype(np.float32))
    want = torch.clamp(torch.tensor(0.1666667) * x + 0.5, 0, 1)
    assert torch.equal(TF.hardsigmoid(x), want)
    assert torch.equal(nn.Hardsigmoid()(x), want)


@pytest.mark.parametrize("n,fmt,shape", [(1, "NCHW", (2, 3, 4, 4)),
                                         (3, "NCHW", (2, 3, 4, 4)),
                                         (5, "NLC", (2, 4, 5))])
def test_prelu_matches(n, fmt, shape):
    rng = _rng(31)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.25 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    _check(lambda a, w_: JF.prelu(a, w_, fmt),
           lambda a, w_: TF.prelu(a, w_, fmt), [x, w])
    jl, tl = jnn.PReLU(n, 0.3, data_format=fmt), \
        nn.PReLU(n, 0.3, data_format=fmt, device="cpu")
    _pair(jl, tl)
    _close(tl(_t(x)), jl(_j(x)))


def test_rrelu_train_draws_and_eval_is_deterministic():
    x = _t(_rng(32).standard_normal((64, 64)).astype(np.float32))
    a = TF.rrelu(x, generator=torch.Generator().manual_seed(1))
    b = TF.rrelu(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    neg = x < 0
    slope = a[neg] / x[neg]
    assert float(slope.min()) >= 0.125 and float(slope.max()) < 0.3333334
    assert torch.equal(a[~neg], x[~neg])
    layer, jlayer = nn.RReLU(), jnn.RReLU()
    layer.eval()
    jlayer.eval()
    _close(layer(x), jlayer(_j(_np(x))))
    _close(TF.rrelu(x, training=False), TF.leaky_relu(x, (0.125 + 0.3333333)
                                                      / 2))


ACT_LAYERS = [("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("Tanh", ()),
              ("SiLU", ()), ("Swish", ()), ("Mish", ()), ("Softsign", ()),
              ("Tanhshrink", ()), ("Hardswish", ()), ("LogSigmoid", ()),
              ("GELU", (True,)), ("LeakyReLU", (0.2,)), ("ELU", (0.5,)),
              ("SELU", ()), ("CELU", (0.8,)), ("Softmax", (1,)),
              ("LogSoftmax", ()), ("Softplus", (1.5, 10.0)),
              ("Softshrink", (0.2,)), ("Hardshrink", (0.2,)),
              ("Hardtanh", (-0.3, 0.4)), ("Hardsigmoid", ()),
              ("ThresholdedReLU", (0.1,)), ("Maxout", (2,)), ("GLU", (1,))]


@pytest.mark.parametrize("name,args", ACT_LAYERS)
def test_activation_layers_match(name, args):
    x = (2 * _rng(33).standard_normal((2, 4, 6))).astype(np.float32)
    _close(getattr(nn, name)(*args)(_t(x)), getattr(jnn, name)(*args)(_j(x)))


def test_inplace_activations_write_their_input():
    x = _t(_rng(34).standard_normal((3, 4)).astype(np.float32))
    want = TF.leaky_relu(x, 0.2)
    y = TF.leaky_relu_(x, 0.2)
    assert y is x and torch.equal(x, want)


# -- containers ----------------------------------------------------------

def test_sequential_names_and_slices_match_jax():
    def build(m, kw):
        return [m.Linear(3, 4, **kw), m.ReLU(), m.Linear(4, 2, **kw)]
    cpu = dict(device="cpu")
    forms = [
        (lambda: jnn.Sequential(*build(jnn, {})),
         lambda: nn.Sequential(*build(nn, cpu))),
        (lambda: jnn.Sequential(*zip(("a", "act", "b"), build(jnn, {}))),
         lambda: nn.Sequential(*zip(("a", "act", "b"), build(nn, cpu)))),
        (lambda: jnn.Sequential(collections.OrderedDict(
            zip(("a", "act", "b"), build(jnn, {})))),
         lambda: nn.Sequential(collections.OrderedDict(
             zip(("a", "act", "b"), build(nn, cpu))))),
    ]
    x = _rng(35).standard_normal((5, 3)).astype(np.float32)
    for jbuild, tbuild in forms:
        js, ts = jbuild(), tbuild()
        _pair(js, ts)
        assert sorted(dict(ts.named_parameters())) == \
            sorted(state_arrays(js)[0])
        _close(ts(_t(x)), js(_j(x)))
        assert len(ts) == len(js) == 3
        head = ts[:2]
        assert isinstance(head, nn.Sequential) and len(head) == 2
        assert sorted(dict(head.named_parameters())) == \
            sorted(state_arrays(js[:2])[0])
        assert ts[-1] is list(ts.children())[-1]


def test_parameter_list_and_layer_dict_names():
    ps = nn.ParameterList([torch.nn.Parameter(torch.zeros(2)),
                           torch.nn.Parameter(torch.ones(3))])
    assert [n for n, _ in ps.named_parameters()] == ["0", "1"]
    jps = jnn.ParameterList([paddle.create_parameter([2], "float32"),
                             paddle.create_parameter([3], "float32")])
    assert [n for n, _ in jps.named_parameters()] == ["0", "1"]
    d = nn.LayerDict({"x": nn.Linear(2, 2, device="cpu")})
    d["y"] = nn.ReLU()
    assert list(d.keys()) == ["x", "y"] and "x" in d and len(d) == 2
    assert sorted(dict(d.named_parameters())) == ["x.bias", "x.weight"]
    d.pop("y")
    assert list(d) == ["x"]


def test_reference_pools_drop_arguments_the_port_honours():
    """The JAX ``AvgPool2D`` drops ``ceil_mode``, ``max_pool2d`` reads a
    channels-last input channels first, ``adaptive_max_pool2d`` drops
    ``return_mask`` and the fractional pools fix u = 0.5 without
    ``random_u``; the port honours each (ROADMAP Queue 3)."""
    x = _rng(80).standard_normal((1, 2, 5, 5)).astype(np.float32)
    assert tuple(jnn.AvgPool2D(2, 2, 0, ceil_mode=True)(_j(x)).shape) == \
        (1, 2, 2, 2)
    assert tuple(nn.AvgPool2D(2, 2, 0, ceil_mode=True)(_t(x)).shape) == \
        (1, 2, 3, 3)
    xl = np.moveaxis(x, 1, -1)
    jl = JF.max_pool2d(_j(xl), 2, 2, data_format="NHWC")
    assert tuple(jl.shape) == (1, 5, 2, 1)          # pooled H and C
    tl = TF.max_pool2d(_t(xl), 2, 2, data_format="NHWC")
    _close(tl, np.moveaxis(_np(TF.max_pool2d(_t(x), 2, 2)), 1, -1))
    assert not isinstance(JF.adaptive_max_pool2d(_j(x), 2, return_mask=True),
                          tuple)
    out, mask = TF.adaptive_max_pool2d(_t(x), 2, return_mask=True)
    assert mask.dtype == torch.int32 and mask.shape == out.shape
    y = _rng(81).standard_normal((1, 1, 12, 12)).astype(np.float32)
    _close(JF.fractional_max_pool2d(_j(y), 5),
           JF.fractional_max_pool2d(_j(y), 5, random_u=0.5))
    draws = {tuple(_np(TF.fractional_max_pool2d(
        _t(y), 5, generator=torch.Generator().manual_seed(s))).ravel())
        for s in range(6)}
    assert len(draws) > 1


def test_thread_ranks_keep_their_groups_until_join():
    """A rank whose ``fn`` returns at once keeps its gloo group until
    ``join``: dropping it could close pairs a peer was still connecting
    (ROADMAP Queue 3)."""
    for _ in range(5):
        rs = ThreadRankSet(4, lambda r, group: group.size(), timeout=60)
        for t in rs.threads:
            t.join(60)
        assert len(rs._groups) == 4
        assert rs.join(60) == {0: 4, 1: 4, 2: 4, 3: 4}
        assert rs._groups == {}


def test_sync_batch_norm_takes_its_data_parallel_group():
    """Inside ``DataParallel`` a ``SyncBatchNorm`` without a group of its
    own reduces over the wrapper's group."""
    from paddle_tpu_torch.distributed.parallel import DataParallel
    x = _rng(82).standard_normal((8, 3, 4, 4)).astype(np.float32)

    def rank(r, group):
        net = nn.Sequential(nn.SyncBatchNorm(3, device="cpu"))
        dp = DataParallel(net, group=group)
        assert net[0].group is group
        return dp(_t(x[4 * r:4 * r + 4])).detach()

    got = ThreadRankSet(2, rank, timeout=60).join(120)
    want = TF.batch_norm(_t(x), None, None, training=True)
    _close(torch.cat([got[0], got[1]]), want)
