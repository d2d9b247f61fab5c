"""The port's ASP (``paddle_tpu_torch.incubate.asp``) held against the JAX
package's: masks exactly, density, the mask checks, ``prune_model``
with excluded and custom-pruned parameters, and ``decorate`` keeping the
zeros through an optimizer's steps (parameters at rtol 1e-5, atol 1e-7,
in f32).

Among equal magnitudes the port keeps the lower index (a stable sort, on
the weight's device). The JAX package's numpy ``argsort`` promises no
order there (on AVX-512 hosts it is a SIMD sort), so on arrays with ties
the masks are compared by what they keep: each group's kept magnitudes
equal JAX's, and the port's choice equals numpy's stable order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.incubate import asp as jasp  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate import asp  # noqa: E402


@pytest.fixture(autouse=True)
def _registries():
    """Each test starts with empty excluded-layer registries."""
    jasp.reset_excluded_layers()
    asp.reset_excluded_layers()
    yield
    jasp.reset_excluded_layers()
    asp.reset_excluded_layers()


def _arrays(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _groups(a, m):
    flat = np.abs(a).reshape(-1, a.shape[-1])
    pad = (-flat.shape[1]) % m
    return np.pad(flat, ((0, 0), (0, pad))).reshape(flat.shape[0], -1, m)


def _kept(a, mask, m):
    """Each group's kept magnitudes, sorted."""
    return np.sort(_groups(a * mask, m), axis=-1)


def _stable_mask(a, n, m):
    """The n largest of each group, the lower index first on ties."""
    g = _groups(a, m)
    order = np.argsort(-g, axis=-1, kind="stable")
    keep = np.zeros(g.shape, bool)
    np.put_along_axis(keep, order[..., :n], True, axis=-1)
    flat = keep.reshape(g.shape[0], -1)[:, :a.shape[-1]]
    return flat.reshape(a.shape).astype(a.dtype)


@pytest.mark.parametrize("shape", [(8, 16), (6, 10), (3, 5, 12), (7,)])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
def test_create_mask_equals_jax(shape, kind, n, m):
    a = _arrays(kind, shape)
    want = jasp.create_mask(paddle.to_tensor(a), n=n, m=m).numpy()
    got = asp.create_mask(torch.tensor(a), n=n, m=m)
    assert got.dtype == torch.float32
    if kind == "ties":
        assert np.array_equal(_kept(a, got.numpy(), m), _kept(a, want, m))
        want = _stable_mask(a, n, m)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(asp.create_mask(a, "mask_2d", n, m).numpy(), want)
    pruned = a * want
    assert asp.calculate_density(torch.tensor(pruned)) == \
        jasp.calculate_density(pruned)
    for fn in ("check_mask_1d", "check_mask_2d"):
        for arr in (pruned, a):
            assert getattr(asp, fn)(torch.tensor(arr), n, m) == \
                getattr(jasp, fn)(arr, n, m)


def test_density_of_a_2_4_mask_is_half():
    a = _arrays("random", (16, 64))
    mask = asp.create_mask(torch.tensor(a))
    assert asp.calculate_density(mask) == 0.5
    assert asp.check_mask_1d(torch.tensor(a) * mask)


class _Lin(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(w))
        self.bias = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return x @ self.weight + self.bias


class _Custom(_Lin):
    pass


def _models(seed=0, custom=False):
    paddle.seed(seed)
    jl = [jnn.Linear(8, 16), jnn.Linear(16, 4)]
    jmodel = jnn.Sequential(jl[0], jnn.ReLU(), jl[1])
    arrs = [(l.weight.numpy().copy(), l.bias.numpy().copy()) for l in jl]
    cls = _Custom if custom else _Lin
    tmodel = torch.nn.Sequential(cls(*arrs[0]), torch.nn.ReLU(),
                                 cls(*arrs[1]))
    return jmodel, tmodel


def _close(jmodel, tmodel):
    for (n, jp), (tn, tp) in zip(jmodel.named_parameters(),
                                 tmodel.named_parameters()):
        assert n == tn
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("excluded", [[], ["2.weight"]])
def test_prune_model_and_decorate_equal_jax(excluded):
    jmodel, tmodel = _models()
    jasp.set_excluded_layers(excluded)
    asp.set_excluded_layers(excluded)
    jm = jasp.prune_model(jmodel)
    tm = asp.prune_model(tmodel)
    assert sorted(jm) == sorted(tm) == sorted(
        {"0.weight", "2.weight"} - set(excluded))
    for k in jm:
        assert np.array_equal(tm[k].numpy(), jm[k].numpy())
    _close(jmodel, tmodel)
    jopt = jasp.decorate(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jmodel.parameters()))
    topt_ = asp.decorate(topt.SGD(learning_rate=0.1,
                                  parameters=tmodel.parameters()))
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal((5, 8)).astype(np.float32)
        (jmodel(paddle.to_tensor(x)) ** 2).mean().backward()
        jopt.step()
        jopt.clear_grad()
        (tmodel(torch.tensor(x)) ** 2).mean().backward()
        topt_.step()
        topt_.clear_grad()
        _close(jmodel, tmodel)
    w = tmodel[0].weight.detach()
    assert asp.calculate_density(w) == 0.5
    assert asp.check_mask_1d(w)
    if excluded:
        assert asp.calculate_density(tmodel[2].weight) == 1.0


def test_custom_pruning_function_equals_jax():
    def prune_rows(w, m, n, algo, name):
        mask = np.zeros_like(w)
        mask[::2] = 1.0
        return w * mask, mask

    jmodel, tmodel = _models(custom=True)
    jasp.add_supported_layer(jnn.Linear, prune_rows)
    asp.add_supported_layer(_Custom, prune_rows)
    try:
        jm = jasp.prune_model(jmodel)
        tm = asp.prune_model(tmodel)
    finally:
        jasp._custom_pruning.pop("Linear", None)
        jasp._supported_layer_types.discard("Linear")
        asp._custom_pruning.pop("_Custom", None)
        asp._supported_layer_types.discard("_Custom")
    for k in ("0.weight", "2.weight"):
        assert np.array_equal(tm[k].numpy(), jm[k].numpy())
    _close(jmodel, tmodel)
