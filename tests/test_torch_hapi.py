"""The PyTorch port's ``hapi`` (``Model``, callbacks, ``summary``,
``flops``), ``metric`` and ``framework.save`` / ``load`` held against the
JAX package on the CPU.

* ``Model.fit`` of a LeNet for 2 epochs on seeded 1 x 28 x 28 data
  (Momentum, CrossEntropyLoss, Accuracy top-1 / top-2, no shuffle): every
  step's loss and accuracy logs equal JAX's, and so do ``evaluate`` and
  ``predict``.
* The callbacks' order, ``EarlyStopping`` (the epoch it stops at) and
  ``ModelCheckpoint``: the ``.pdparams`` / ``.pdopt`` files the port
  writes load in the JAX ``framework.load`` (and into a JAX model), and
  the JAX ones in the port's ``Model.load``.
* ``summary``'s printed table and parameter counts and ``flops`` equal
  JAX's (LeNet; ResNet-18).
* ``Precision``, ``Recall``, ``Auc``, ``Accuracy`` and ``accuracy`` equal
  JAX's on inputs without ties.

Tolerance: losses and outputs within 1e-5 of the reference's largest
magnitude (at least 1); accuracies, counts and printed tables exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import framework as jframework  # noqa: E402
from paddle_tpu import metric as jmetric  # noqa: E402
from paddle_tpu.hapi import callbacks as jcb  # noqa: E402
from paddle_tpu.jit.functional import state_arrays  # noqa: E402
from paddle_tpu.vision import models as JM  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
from paddle_tpu_torch import framework as tframework  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch import metric as tmetric  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.hapi import callbacks as tcb  # noqa: E402
from paddle_tpu_torch.models import state_from_numpy  # noqa: E402
from paddle_tpu_torch.vision import models as TM  # noqa: E402

ATOL = 1e-5
N, B = 32, 8


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


def _data(seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (n, 1)).astype(np.int64)
    return x, y


class Recorder:
    """A callback for either framework: the events in order and each
    train step's logs."""

    def __init__(self):
        self.events, self.logs = [], []

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        self.events.append(("begin", mode))

    def on_end(self, mode, logs=None):
        self.events.append(("end", mode))

    def on_epoch_begin(self, epoch, logs=None):
        self.events.append(("epoch_begin", epoch))

    def on_epoch_end(self, epoch, logs=None):
        self.events.append(("epoch_end", epoch))

    def on_batch_begin(self, mode, step, logs=None):
        self.events.append(("batch_begin", mode, step))

    def on_batch_end(self, mode, step, logs=None):
        self.events.append(("batch_end", mode, step))
        self.logs.append(dict(logs))


def _models(lr=0.01, seed=0):
    """(JAX Model, port Model) of one LeNet's weights, prepared alike."""
    paddle.seed(seed)
    jnet = JM.LeNet()
    tnet = state_from_numpy(state_arrays(jnet), TM.LeNet, device="cpu")
    jm = paddle.Model(jnet).prepare(
        paddle.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                  parameters=jnet.parameters()),
        paddle.nn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 2)))
    tm = tpaddle.Model(tnet).prepare(
        topt.Momentum(learning_rate=lr, momentum=0.9,
                      parameters=tnet.parameters()),
        tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 2)))
    return jm, tm


def _datasets(x, y):
    return (paddle.io.TensorDataset([x, y]), tio.TensorDataset([x, y]))


@pytest.fixture(scope="module")
def fitted():
    """Both LeNets after 2 epochs of ``Model.fit``, with their recorders
    and a checkpoint directory each (filled by ``ModelCheckpoint``)."""
    import tempfile
    x, y = _data(0)
    jm, tm = _models()
    jds, tds = _datasets(x, y)
    jrec, trec = Recorder(), Recorder()
    jdir, tdir = tempfile.mkdtemp(), tempfile.mkdtemp()
    jm.fit(jds, batch_size=B, epochs=2, shuffle=False,
           callbacks=[jrec, jcb.ModelCheckpoint(1, jdir)])
    tm.fit(tds, batch_size=B, epochs=2, shuffle=False,
           callbacks=[trec, tcb.ModelCheckpoint(1, tdir)])
    return dict(jm=jm, tm=tm, jrec=jrec, trec=trec, jdir=jdir, tdir=tdir)


def test_fit_logs_equal_jax_step_by_step(fitted):
    jlogs, tlogs = fitted["jrec"].logs, fitted["trec"].logs
    assert len(tlogs) == len(jlogs) == 2 * N // B
    for i, (t, j) in enumerate(zip(tlogs, jlogs)):
        assert sorted(t) == sorted(j) == ["acc_top1", "acc_top2", "loss",
                                          "step"]
        _close(np.float32(t["loss"]), np.float32(j["loss"]),
               msg=f"step {i}")
        assert t["acc_top1"] == j["acc_top1"] and \
            t["acc_top2"] == j["acc_top2"], (i, t, j)
        assert t["step"] == j["step"]
    # the weights after the fit
    params = state_arrays(fitted["jm"].network)[0]
    for n, p in fitted["tm"].network.named_parameters():
        _close(p, params[n], msg=n)


def test_callbacks_run_in_the_jax_order(fitted):
    assert fitted["trec"].events == fitted["jrec"].events
    ev = fitted["trec"].events
    assert ev[0] == ("begin", "train") and ev[-1] == ("end", "train")
    assert ev[1] == ("epoch_begin", 0) and ("epoch_end", 1) in ev


def test_evaluate_and_predict_equal_jax(fitted):
    x, y = _data(1, 16)
    jds, tds = _datasets(x, y)
    jlogs = fitted["jm"].evaluate(jds, batch_size=B, verbose=0)
    tlogs = fitted["tm"].evaluate(tds, batch_size=B, verbose=0)
    assert sorted(tlogs) == sorted(jlogs)
    _close(np.float32(tlogs["loss"]), np.float32(jlogs["loss"]))
    assert tlogs["acc_top1"] == jlogs["acc_top1"]
    assert tlogs["acc_top2"] == jlogs["acc_top2"]
    jout = fitted["jm"].predict(paddle.io.TensorDataset([x]), batch_size=B)
    tout = fitted["tm"].predict(tio.TensorDataset([x]), batch_size=B)
    assert len(tout[0]) == len(jout[0]) == 2
    for a, b in zip(tout[0], jout[0]):
        _close(a, b)
    stacked = fitted["tm"].predict(tio.TensorDataset([x]), batch_size=B,
                                   stack_outputs=True)
    assert stacked[0].shape == (16, 10)


def test_checkpoints_cross_load_both_ways(fitted):
    """``ModelCheckpoint`` wrote 0 / 1 .pdparams and .pdopt on each side:
    the port's load in JAX's ``framework.load`` and give JAX's network the
    port's forward; the JAX ones load in the port's ``Model.load``."""
    import os
    tdir, jdir = fitted["tdir"], fitted["jdir"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams"]
    x = _data(2, 4)[0]
    want = fitted["tm"].network(torch.from_numpy(x))
    # the port's files in JAX
    state = jframework.load(os.path.join(tdir, "1.pdparams"))
    jnet = JM.LeNet()
    jnet.set_state_dict(state)
    _close(jnet(paddle.to_tensor(x)), want)
    jopt = jframework.load(os.path.join(tdir, "1.pdopt"))
    topt_state = fitted["tm"]._optimizer.state_dict()
    assert sorted(jopt) == sorted(topt_state)
    _close(jopt["param_0.velocity"], topt_state["param_0.velocity"], 0.0)
    # the JAX files in the port
    _, tm = _models()
    tm.load(os.path.join(jdir, "1"))
    _close(tm.network(torch.from_numpy(x)),
           fitted["jm"].network(paddle.to_tensor(x)))
    jstate = fitted["jm"]._optimizer.state_dict()
    got = tm._optimizer.state_dict()
    assert got["@step"] == jstate["@step"]
    _close(got["param_2.velocity"], jstate["param_2.velocity"], 0.0)


def test_early_stopping_stops_at_the_jax_epoch():
    x, y = _data(3)
    runs = []
    for side in ("jax", "port"):
        jm, tm = _models(lr=0.01, seed=3)
        rec = Recorder()
        if side == "jax":
            jm.fit(_datasets(x, y)[0], batch_size=B, epochs=5,
                   shuffle=False, callbacks=[rec, jcb.EarlyStopping(
                       "loss", mode="max", patience=0)])
        else:
            tm.fit(_datasets(x, y)[1], batch_size=B, epochs=5,
                   shuffle=False, callbacks=[rec, tcb.EarlyStopping(
                       "loss", mode="max", patience=0)])
        runs.append([e for e in rec.events if e[0] == "epoch_end"])
    assert runs[0] == runs[1]
    assert 1 < len(runs[1]) < 5


def test_save_load_carries_batch_norm_buffers_across():
    """A port network with a batch norm after one training step, saved by
    ``Model.save``: JAX loads it and its eval forward equals the port's."""
    import os
    import tempfile
    from paddle_tpu import nn as jnn

    def net(m, **kw):
        return m.Sequential(m.Conv2D(3, 4, 3, **kw), m.BatchNorm2D(4, **kw),
                            m.ReLU(), m.AdaptiveAvgPool2D(1), m.Flatten(),
                            m.Linear(4, 3, **kw))
    tnet = net(tnn, device="cpu")
    model = tpaddle.Model(tnet).prepare(
        topt.SGD(learning_rate=0.1, parameters=tnet.parameters()),
        tnn.CrossEntropyLoss())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 6, 6)).astype(np.float32)
    model.train_batch(torch.from_numpy(x),
                      torch.from_numpy(np.array([[0], [1], [2], [0]])))
    path = os.path.join(tempfile.mkdtemp(), "ck")
    model.save(path)
    jnet = net(jnn)
    jnet.set_state_dict(jframework.load(path + ".pdparams"))
    jnet.eval()
    tnet.eval()
    assert float(np.abs(_np(jnet[1]._mean)).max()) > 0
    _close(jnet(paddle.to_tensor(x)), tnet(torch.from_numpy(x)))


def test_framework_save_load_round_trip(tmp_path):
    obj = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "b": [torch.ones(2, dtype=torch.bfloat16), 3, "x"],
           "c": (np.arange(3), {"d": torch.zeros(1, dtype=torch.int64)})}
    tframework.save(obj, str(tmp_path / "o.pdparams"))
    back = tframework.load(str(tmp_path / "o.pdparams"))
    assert torch.equal(back["a"], obj["a"])
    assert back["b"][0].dtype == torch.float32 and back["b"][1:] == [3, "x"]
    assert back["c"][1]["d"].dtype == torch.int64
    assert tframework.load(str(tmp_path / "o.pdparams"),
                           return_numpy=True)["a"].shape == (2, 3)
    jback = jframework.load(str(tmp_path / "o.pdparams"))
    np.testing.assert_array_equal(_np(jback["a"]), _np(obj["a"]))


def test_prepare_jit_is_refused_naming_the_item():
    tnet = TM.LeNet(device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tpaddle.Model(tnet).prepare(jit=True)
    assert tpaddle.Model(tnet).prepare(amp_configs={"level": "O1"})


@pytest.fixture
def jax_zeros_init(monkeypatch):
    """Counting needs no JAX draw (a draw compiles once a shape)."""
    from paddle_tpu.nn import initializer as JI
    for cls in vars(JI).values():
        if isinstance(cls, type) and issubclass(cls, JI.Initializer):
            monkeypatch.setattr(
                cls, "__call__", lambda self, shape, dtype: np.zeros(
                    shape, np.float32))


@pytest.mark.parametrize("name,size", [("LeNet", (1, 1, 28, 28)),
                                       ("resnet18", (1, 3, 32, 32))])
def test_summary_and_flops_equal_jax(name, size, capsys, jax_zeros_init):
    kw = {} if name == "LeNet" else dict(num_classes=10)
    jnet = getattr(JM, name)(**kw)
    tnet = getattr(TM, name)(device="cpu", **kw)
    jsum = paddle.summary(jnet, size)
    jtext = capsys.readouterr().out
    tsum = tpaddle.summary(tnet, size)
    ttext = capsys.readouterr().out
    assert tsum == jsum
    assert ttext == jtext
    assert tpaddle.flops(tnet, size) == paddle.flops(jnet, size)
    assert tpaddle.Model(tnet).summary(size) == jsum


def _binary(seed, n=64):
    rng = np.random.default_rng(seed)
    preds = rng.random((n, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (n, 1)).astype(np.int64)
    return preds, labels


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal_jax(name):
    jm, tm = getattr(jmetric, name)(), getattr(tmetric, name)()
    for seed in (5, 6):
        p, y = _binary(seed)
        jm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        tm.update(torch.from_numpy(p), torch.from_numpy(y))
    assert tm.accumulate() == pytest.approx(jm.accumulate(), abs=1e-12)
    assert tm.name() == jm.name()
    tm.reset()
    assert tm.accumulate() == 0.0


def test_accuracy_metric_and_function_equal_jax():
    rng = np.random.default_rng(7)
    jm, tm = jmetric.Accuracy(topk=(1, 3)), tmetric.Accuracy(topk=(1, 3))
    for _ in range(3):
        pred = rng.permutation(40).reshape(4, 10).astype(np.float32)
        label = rng.integers(0, 10, (4, 1)).astype(np.int64)
        jr = jm.update(jm.compute(paddle.to_tensor(pred),
                                  paddle.to_tensor(label)))
        tr = tm.update(tm.compute(torch.from_numpy(pred),
                                  torch.from_numpy(label)))
        assert tr == jr
        for k in (1, 2):
            assert float(tmetric.accuracy(torch.from_numpy(pred),
                                          torch.from_numpy(label), k)) == \
                pytest.approx(float(jmetric.accuracy(
                    paddle.to_tensor(pred), paddle.to_tensor(label), k)))
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == ["acc_top1", "acc_top3"]
