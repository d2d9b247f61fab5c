"""The PyTorch port's vision zoo (``paddle_tpu_torch.vision.models``)
held against the JAX package's on the CPU.

* Every zoo constructor: the parameter and buffer names and shapes equal
  ``jit.functional.state_arrays``' (the JAX forward is not run).
* ResNet-18: one Momentum step (lr 0.1, momentum 0.9, weight decay 1e-4)
  at B=2, 64 x 64, training mode: the loss, the logits, every parameter
  after the step and every batch-norm buffer. (At 32 x 32 layer4 runs at
  1 x 1, so its batch norms normalise 2 values a channel; where two
  values lie within ~sqrt(eps) the f32 rounding of the convolution sums
  is amplified ~50x: the port's f32 logits differ from its own float64
  ones by 3.4e-3 there, JAX's by 8.0e-4, so no f32 pair of frameworks
  agrees to 1e-5. At 64 x 64, 8 values a channel, both lie within 6.2e-6
  of the float64 logits.)
* ResNet-18 in eval with non-trivial running statistics carried by
  ``models.state_from_numpy``'s buffers: the logits.
* MobileNetV3-small (scale 0.5): one eval forward.

The JAX models run eagerly (their batch norms update the running
statistics only outside a trace). Tolerance: float32 within 1e-5 of the
reference's largest magnitude (at least 1), as
``tests/test_torch_model_families.py`` holds the model families.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.jit.functional import state_arrays  # noqa: E402
from paddle_tpu.vision import models as JM  # noqa: E402
from paddle_tpu_torch import models as T  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models.state import load_numpy  # noqa: E402
from paddle_tpu_torch.vision import models as TM  # noqa: E402

ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _close(got, want, atol=ATOL, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                               err_msg=msg)


ZOO = ["LeNet", "resnet18", "resnet34", "resnet50", "resnet101",
       "resnet152", "resnext50_32x4d", "resnext50_64x4d",
       "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
       "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2", "vgg11",
       "vgg13", "vgg16", "vgg19", "alexnet", "mobilenet_v1", "mobilenet_v2",
       "mobilenet_v3_small", "mobilenet_v3_large", "squeezenet1_0",
       "squeezenet1_1", "densenet121", "densenet161", "densenet169",
       "densenet201", "densenet264", "googlenet", "shufflenet_v2_x0_25",
       "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
       "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
       "inception_v3"]


def _shapes(named):
    return {n: tuple(np.shape(a)) for n, a in named}


@pytest.fixture
def jax_zeros_init(monkeypatch):
    """The JAX initializers return zeros from numpy: these tests read
    names and shapes only, and a JAX draw compiles once a shape."""
    from paddle_tpu.nn import initializer as JI
    for cls in vars(JI).values():
        if isinstance(cls, type) and issubclass(cls, JI.Initializer):
            monkeypatch.setattr(
                cls, "__call__", lambda self, shape, dtype: np.zeros(
                    shape, np.float32))


@pytest.mark.parametrize("name", ZOO + ["vgg16_bn", "mobilenet_v3_half"])
def test_zoo_names_and_shapes_equal_state_arrays(name, jax_zeros_init):
    """Built with 10 classes (the 1000-way heads are only wider); the
    port's parameters and buffers by name and shape."""
    if name == "vgg16_bn":
        jm, tm = (JM.vgg16(batch_norm=True, num_classes=10),
                  TM.vgg16(batch_norm=True, num_classes=10, device="cpu"))
    elif name == "mobilenet_v3_half":
        jm, tm = (JM.mobilenet_v3_large(scale=0.5, num_classes=10),
                  TM.mobilenet_v3_large(scale=0.5, num_classes=10,
                                        device="cpu"))
    else:
        jm = getattr(JM, name)(num_classes=10)
        tm = getattr(TM, name)(num_classes=10, device="cpu")
    params, buffers = state_arrays(jm)
    assert _shapes(tm.named_parameters()) == _shapes(params.items())
    assert _shapes(tm.named_buffers()) == _shapes(buffers.items())
    # every batch norm's statistics are buffers, as in the JAX model
    n_bn = sum(isinstance(m, tnn.layers.norm._BatchNormBase)
               for m in tm.modules())
    assert len(buffers) == 2 * n_bn


def _randomize_stats(jm, rng):
    """Non-trivial running statistics in the JAX model's batch norms."""
    for name, b in jm.named_buffers():
        if name.endswith("_mean"):
            b.set_value(0.3 * rng.standard_normal(b.shape).astype(np.float32))
        else:
            b.set_value((0.5 + rng.random(b.shape)).astype(np.float32))


def _carry(jm, build, **kw):
    """The port's model holding the JAX model's parameters and buffers."""
    tm = T.state_from_numpy(state_arrays(jm), build, device="cpu", **kw)
    params, buffers = T.state_to_numpy(tm, with_buffers=True)
    jp, jb = state_arrays(jm)
    assert all(np.array_equal(params[n], np.asarray(jp[n])) for n in jp)
    assert all(np.array_equal(buffers[n], np.asarray(jb[n])) for n in jb)
    return tm


def test_state_from_numpy_refuses_a_load_without_buffers(jax_zeros_init):
    jm = JM.resnet18(num_classes=10)
    params, buffers = state_arrays(jm)
    np_params = {n: np.asarray(a) for n, a in params.items()}
    with pytest.raises(KeyError, match="buffers missing"):
        T.state_from_numpy(np_params, TM.resnet18, num_classes=10,
                           device="cpu")
    short = dict(list(buffers.items())[1:])
    with pytest.raises(KeyError, match="buffers missing"):
        T.state_from_numpy((np_params, short), TM.resnet18, num_classes=10,
                           device="cpu")
    bad = dict(buffers)
    bad["bn1._mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="bn1._mean"):
        T.state_from_numpy((np_params, bad), TM.resnet18, num_classes=10,
                           device="cpu")


def test_resnet18_eval_logits_with_carried_running_stats():
    paddle.seed(0)
    rng = np.random.default_rng(0)
    jm = JM.resnet18(num_classes=10)
    _randomize_stats(jm, rng)
    jm.eval()
    tm = _carry(jm, TM.resnet18, num_classes=10).eval()
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = jm(paddle.to_tensor(x))
    got = tm(torch.from_numpy(x))
    _close(got, want)
    # the statistics matter: the port's default 0 / 1 give other logits
    fresh = TM.resnet18(num_classes=10, device="cpu").eval()
    load_numpy(fresh, (state_arrays(jm)[0], {
        n: b.detach().numpy() for n, b in fresh.named_buffers()}))
    assert not np.allclose(_np(fresh(torch.from_numpy(x))), _np(want),
                           atol=1e-3)


def test_resnet18_momentum_step_equals_jax():
    """One training step through the batch norms' batch statistics:
    loss, logits, every parameter after Momentum and every running
    statistic after its update."""
    paddle.seed(1)
    rng = np.random.default_rng(1)
    jm = JM.resnet18(num_classes=10)
    _randomize_stats(jm, rng)
    tm = _carry(jm, TM.resnet18, num_classes=10)
    jm.train()
    tm.train()
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (2, 1)).astype(np.int64)
    kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    jopt = paddle.optimizer.Momentum(parameters=jm.parameters(), **kw)
    topt_ = topt.Momentum(parameters=tm.parameters(), **kw)
    jout = jm(paddle.to_tensor(x))
    jloss = paddle.nn.functional.cross_entropy(jout, paddle.to_tensor(y))
    jloss.backward()
    jopt.step()
    tout = tm(torch.from_numpy(x))
    tloss = tnn.functional.cross_entropy(tout, torch.from_numpy(y))
    tloss.backward()
    topt_.step()
    _close(tout, jout, msg="logits")
    _close(tloss, jloss, msg="loss")
    params, buffers = state_arrays(jm)
    for n, p in tm.named_parameters():
        _close(p, params[n], msg=n)
    for n, b in tm.named_buffers():
        _close(b, buffers[n], msg=n)


def test_mobilenet_v3_small_half_eval_forward_equals_jax():
    paddle.seed(2)
    rng = np.random.default_rng(2)
    jm = JM.mobilenet_v3_small(scale=0.5, num_classes=10)
    _randomize_stats(jm, rng)
    jm.eval()
    tm = _carry(jm, TM.mobilenet_v3_small, scale=0.5,
                num_classes=10).eval()
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    _close(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


def test_constructors_take_pretrained_and_draw_from_their_seed():
    a = TM.resnet18(pretrained=True, num_classes=4, device="cpu", seed=3)
    b = TM.resnet18(num_classes=4, device="cpu", seed=3)
    c = TM.resnet18(num_classes=4, device="cpu", seed=4)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.fc.weight, c.fc.weight)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.resnet18()
