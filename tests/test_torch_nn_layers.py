"""The PyTorch port's ``nn`` layers and functionals for the model families
held against the JAX package on the CPU: ``gelu`` (exact and tanh),
``layer_norm``, ``group_norm``, ``conv2d`` (stride, padding, groups),
``interpolate``, ``dropout``, ``Linear`` with a bias, ``Conv2D``,
``MultiHeadAttention`` (self; cross with kdim != embed_dim; additive and
bool masks; the cache) and ``TransformerEncoderLayer`` pre- and
post-norm, their outputs and every gradient. The JAX side's attention is
``_sdpa_ref`` (the flash path needs a TPU); the port's runs the flash
kernels' plain versions on CPU tensors. Also the initializers' and
``ParamAttr``'s rule, and the Llama model's parameters after ``Linear``
gained its bias.

Weights come from the JAX layer (``state_arrays``) into the port's
(``models.state.load_numpy``); inputs from numpy with a seed. Tolerance:
float32 within 1e-5 of the reference's largest magnitude (at least 1:
values are O(1), and the weight gradients of a convolution sum ~200
products to O(30), where f32 sums in another order differ by ~1e-5);
bf16 outputs as each test states.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.jit.functional import pure_call, state_arrays  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.models.state import load_numpy  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn import initializer as TI  # noqa: E402

ATOL = 1e-5


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _t(x, grad=False):
    t = torch.as_tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, msg=""):
    """|got - want| <= atol * max(1, max |want|) elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                               err_msg=msg)


def _functional_grads(jfn, tfn, xs, seed=0):
    """jfn / tfn over the float32 arrays ``xs``: outputs and the
    gradients of sum(out * g) with respect to each input, both sides."""
    jout = jfn(*[jnp.asarray(x) for x in xs])
    g = _rng(seed + 100).standard_normal(np.shape(jout)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                              argnums=tuple(range(len(xs)))))(
        *[jnp.asarray(x) for x in xs])
    leaves = [_t(x, grad=True) for x in xs]
    tout = tfn(*leaves)
    (tout * _t(g)).sum().backward()
    return jout, jgrads, tout, [x.grad for x in leaves]


def _layer_pair(jlayer, tlayer):
    """Load the JAX layer's weights into the port's; both in eval."""
    jlayer.eval()
    tlayer.eval()
    params, buffers = state_arrays(jlayer)
    np_params = {n: np.asarray(a) for n, a in params.items()}
    load_numpy(tlayer, np_params)
    assert sorted(dict(tlayer.named_parameters())) == sorted(np_params)
    return params, buffers


def _layer_grads(jlayer, tlayer, xs, seed=0, **kw):
    """Outputs, input gradients and parameter gradients of sum(out * g)
    through both layers (the JAX one by ``jax.grad`` over ``pure_call``)."""
    params, buffers = _layer_pair(jlayer, tlayer)
    jx = [jnp.asarray(x) for x in xs]
    jout = pure_call(jlayer, params, buffers, *jx, **kw)
    g = _rng(seed + 200).standard_normal(np.shape(jout)).astype(np.float32)

    def loss(p, *a):
        return jnp.sum(pure_call(jlayer, p, buffers, *a, **kw) * g)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs) + 1))))(
        params, *jx)
    leaves = [_t(x, grad=True) for x in xs]
    tout = tlayer(*leaves, **kw)
    (tout * _t(g)).sum().backward()
    return (jout, grads[1:], grads[0]), (tout, [x.grad for x in leaves],
                                         dict(tlayer.named_parameters()))


def _check_layer(jlayer, tlayer, xs, seed=0, atol=ATOL, **kw):
    (jout, jxg, jpg), (tout, txg, tparams) = _layer_grads(
        jlayer, tlayer, xs, seed, **kw)
    _close(tout, jout, atol, "output")
    for i, (a, b) in enumerate(zip(txg, jxg)):
        _close(a, b, atol, f"input {i} grad")
    for n, p in tparams.items():
        _close(p.grad, jpg[n], atol, n)


# -- functionals ---------------------------------------------------------

@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches(approximate):
    x = (3 * _rng(0).standard_normal((4, 33))).astype(np.float32)
    jout, jg, tout, tg = _functional_grads(
        lambda a: JF.gelu(paddle.to_tensor(a), approximate=approximate).data,
        lambda a: TF.gelu(a, approximate=approximate), [x])
    _close(tout, jout)
    _close(tg[0], jg[0])
    # bf16: the f32 formula rounded once; the JAX op rounds its chain in
    # bf16, which near the negative tail costs up to an ulp of |x|
    xb = _t(x).bfloat16()
    got = TF.gelu(xb, approximate=approximate)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, TF.gelu(xb.float(), approximate).bfloat16())
    want = _np(JF.gelu(paddle.to_tensor(x).astype("bfloat16"),
                       approximate=approximate).astype("float32"))
    bound = 2.0 ** -7 * np.maximum(1.0, np.abs(xb.float().numpy()))
    assert (np.abs(got.float().numpy() - want) <= bound).all()


def test_tanh_and_relu_match():
    x = _rng(1).standard_normal((3, 17)).astype(np.float32)
    for jf, tf in ((JF.tanh, TF.tanh), (JF.relu, TF.relu)):
        _close(tf(_t(x)), jf(paddle.to_tensor(x)), 1e-6)


@pytest.mark.parametrize("with_affine", [True, False])
def test_layer_norm_matches(with_affine):
    rng = _rng(2)
    x = (2 + 3 * rng.standard_normal((3, 5, 24))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    xs = [x, w, b] if with_affine else [x]

    def jfn(*a):
        wb = a[1:] if with_affine else (None, None)
        return JF.layer_norm(paddle.to_tensor(a[0]), 24, *[
            None if t is None else paddle.to_tensor(t) for t in wb]).data

    def tfn(*a):
        wb = a[1:] if with_affine else (None, None)
        return TF.layer_norm(a[0], 24, *wb)

    jout, jg, tout, tg = _functional_grads(jfn, tfn, xs)
    _close(tout, jout)
    for a, b_ in zip(tg, jg):
        _close(a, b_)
    # a bf16 input keeps its dtype; the f32 scale is cast to it
    got = TF.layer_norm(_t(x).bfloat16(), [24], _t(w), _t(b))
    want = JF.layer_norm(paddle.to_tensor(x).astype("bfloat16"), [24],
                         paddle.to_tensor(w), paddle.to_tensor(b))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype("float32")), atol=2e-2)


@pytest.mark.parametrize("groups,shape", [(4, (2, 8, 5, 6)), (2, (3, 6, 7)),
                                          (1, (2, 4, 3, 3))])
def test_group_norm_matches(groups, shape):
    rng = _rng(3)
    c = shape[1]
    x = (1 + 2 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jout, jg, tout, tg = _functional_grads(
        lambda *a: JF.group_norm(*[paddle.to_tensor(t) for t in a[:1]],
                                 groups, paddle.to_tensor(a[1]),
                                 paddle.to_tensor(a[2])).data,
        lambda *a: TF.group_norm(a[0], groups, a[1], a[2]), [x, w, b])
    _close(tout, jout)
    for a, b_ in zip(tg, jg):
        _close(a, b_)
    # channels-last goes through the channels-first form
    xl = np.moveaxis(x, 1, -1)
    fmt = "NHWC" if x.ndim == 4 else "NLC"
    _close(TF.group_norm(_t(xl), groups, _t(w), _t(b), data_format=fmt),
           JF.group_norm(paddle.to_tensor(xl), groups, paddle.to_tensor(w),
                         paddle.to_tensor(b), data_format=fmt))
    # an f32 scale promotes a bf16 input's output to f32, as in JAX
    got = TF.group_norm(_t(x).bfloat16(), groups, _t(w), _t(b))
    want = JF.group_norm(paddle.to_tensor(x).astype("bfloat16"), groups,
                         paddle.to_tensor(w), paddle.to_tensor(b))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-2)


@pytest.mark.parametrize("stride,padding,groups,dilation", [
    (1, 1, 1, 1), (2, 1, 1, 1), (2, 0, 2, 1), (1, [1, 2], 4, 1),
    (1, [0, 1, 2, 1], 1, 1), (1, "SAME", 1, 1), (1, "VALID", 2, 2),
    (3, 2, 1, 2)])
def test_conv2d_matches(stride, padding, groups, dilation):
    rng = _rng(4)
    x = rng.standard_normal((2, 8, 9, 10)).astype(np.float32)
    w = (0.3 * rng.standard_normal((12, 8 // groups, 3, 3))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(12)).astype(np.float32)
    kw = dict(stride=stride, padding=padding, groups=groups,
              dilation=dilation)
    jout, jg, tout, tg = _functional_grads(
        lambda *a: JF.conv2d(*[paddle.to_tensor(t) for t in a], **kw).data,
        lambda *a: TF.conv2d(*a, **kw), [x, w, b])
    assert tuple(tout.shape) == tuple(np.shape(jout))
    _close(tout, jout)
    for a, b_ in zip(tg, jg):
        _close(a, b_)


def test_conv2d_channels_last_and_bf16_promotion():
    rng = _rng(5)
    x = rng.standard_normal((2, 7, 6, 4)).astype(np.float32)
    w = (0.3 * rng.standard_normal((5, 4, 3, 3))).astype(np.float32)
    b = (0.1 * rng.standard_normal(5)).astype(np.float32)
    _close(TF.conv2d(_t(x), _t(w), _t(b), padding=1, data_format="NHWC"),
           JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b), padding=1, data_format="NHWC"))
    xc = np.moveaxis(x, -1, 1)
    got = TF.conv2d(_t(xc).bfloat16(), _t(w).bfloat16(), _t(b))
    want = JF.conv2d(paddle.to_tensor(xc).astype("bfloat16"),
                     paddle.to_tensor(w).astype("bfloat16"),
                     paddle.to_tensor(b))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), _np(want), atol=3e-2)


@pytest.mark.parametrize("kw", [dict(scale_factor=2), dict(scale_factor=3),
                                dict(size=(5, 7)), dict(size=(9, 3)),
                                dict(scale_factor=(2, 1))])
def test_interpolate_nearest_matches(kw):
    x = _rng(6).standard_normal((2, 3, 4, 6)).astype(np.float32)
    jout, jg, tout, tg = _functional_grads(
        lambda a: JF.interpolate(paddle.to_tensor(a), mode="nearest",
                                 **kw).data,
        lambda a: TF.interpolate(a, mode="nearest", **kw), [x])
    assert tuple(tout.shape) == tuple(np.shape(jout))
    _close(tout, jout, 0.0)
    _close(tg[0], jg[0])
    xl = np.moveaxis(x, 1, -1)
    _close(TF.interpolate(_t(xl), data_format="NHWC", **kw),
           JF.interpolate(paddle.to_tensor(xl), data_format="NHWC", **kw),
           0.0)
    # the modes the JAX function has (bilinear and bicubic are held in
    # tests/test_torch_nn_vision.py); any other raises
    with pytest.raises(ValueError, match="mode"):
        TF.interpolate(_t(x), scale_factor=2, mode="area")


def test_dropout_semantics():
    """Out of training the identity (downscale_in_infer: times 1 - p); in
    training each element (or slice along ``axis``) kept with 1 - p and
    scaled by 1 / (1 - p) in upscale mode, from the port's seed chain."""
    from paddle_tpu_torch.core import random as trand
    x = torch.ones(64, 128)
    assert TF.dropout(x, 0.3, training=False) is x
    assert torch.equal(TF.dropout(x, 0.3, training=False,
                                  mode="downscale_in_infer"), x * 0.7)
    trand.seed(5)
    a = TF.dropout(x, 0.25)
    trand.seed(5)
    assert torch.equal(TF.dropout(x, 0.25), a)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.65 < float(kept.float().mean()) < 0.85
    rows = TF.dropout(x, 0.5, axis=0)
    assert all(bool((r == 0).all() or (r == 2).all()) for r in rows)
    plain = TF.dropout(x, 0.5, mode="downscale_in_infer")
    assert set(plain.unique().tolist()) <= {0.0, 1.0}
    layer = nn.Dropout(0.5)
    layer.eval()
    assert layer(x) is x


# -- initializers and ParamAttr ------------------------------------------

def test_initializer_defaults_and_fans():
    """The JAX rule: fans from paddle's layouts, XavierNormal's std,
    KaimingUniform's limit over the fan-in, constants."""
    gen = torch.Generator().manual_seed(0)
    assert TI.fan_in_out((3, 5)) == JI._fan_in_out((3, 5))
    assert TI.fan_in_out((4, 2, 3, 3)) == JI._fan_in_out((4, 2, 3, 3))
    assert TI.fan_in_out((7,)) == JI._fan_in_out((7,))
    w = TI.XavierNormal()((400, 600), gen, "cpu")
    assert abs(float(w.std()) - (2.0 / 1000) ** 0.5) < 2e-3
    k = TI.KaimingUniform(fan_in=27)((64, 3, 3, 3), gen, "cpu")
    assert float(k.abs().max()) <= (6.0 / 27) ** 0.5
    assert float(k.abs().max()) > 0.9 * (6.0 / 27) ** 0.5
    assert torch.equal(TI.Constant(1.5)((2, 3), gen, "cpu"),
                       torch.full((2, 3), 1.5))
    n = TI.Normal(0.5, 2.0)((20000,), gen, "cpu")
    assert abs(float(n.mean()) - 0.5) < 0.05 and abs(float(n.std()) - 2) < 0.05


def test_param_attr_and_layer_defaults():
    """Linear: XavierNormal weight, zero bias, ``bias_attr=False`` drops
    it; the attr's initializer wins; ``trainable=False``, the learning
    rate and need_clip land on the parameter; LayerNorm / GroupNorm ones
    and zeros; Embedding Normal(0, 1); a model's generator fixes the
    bits."""
    gen = torch.Generator().manual_seed(3)
    lin = nn.Linear(4, 6, generator=gen, device="cpu")
    assert lin.weight.shape == (4, 6) and torch.equal(lin.bias,
                                                      torch.zeros(6))
    assert nn.Linear(4, 6, device="cpu", bias_attr=False).bias is None
    attr = nn.ParamAttr(initializer=nn.initializer.Constant(0.25),
                        learning_rate=0.5, need_clip=False, trainable=False)
    lin = nn.Linear(4, 6, device="cpu", weight_attr=attr,
                    bias_attr=nn.ParamAttr(
                        initializer=nn.initializer.Constant(1.0)))
    assert torch.equal(lin.weight, torch.full((4, 6), 0.25))
    assert not lin.weight.requires_grad
    assert lin.weight.optimize_attr == {"learning_rate": 0.5}
    assert lin.weight.need_clip is False
    assert torch.equal(lin.bias, torch.ones(6))
    ln = nn.LayerNorm(5, device="cpu")
    assert torch.equal(ln.weight, torch.ones(5)) and torch.equal(
        ln.bias, torch.zeros(5))
    assert nn.LayerNorm(5, device="cpu", bias_attr=False).bias is None
    gn = nn.GroupNorm(2, 6, device="cpu", weight_attr=False)
    assert gn.weight is None and gn.bias is None
    emb = nn.Embedding(1000, 64, device="cpu")
    assert abs(float(emb.weight.detach().std()) - 1.0) < 0.02
    a = nn.Linear(8, 8, generator=torch.Generator().manual_seed(9),
                  device="cpu")
    b = nn.Linear(8, 8, generator=torch.Generator().manual_seed(9),
                  device="cpu")
    assert torch.equal(a.weight, b.weight)
    p = nn.create_parameter([1, 1, 16], device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert p.shape == (1, 1, 16) and p.requires_grad


def test_linear_llama_form_stays_bias_free():
    """``Linear(in, out, std, generator, device)``: a Normal(0, std)
    weight, the same draw as before the bias option, and no bias."""
    gen = torch.Generator().manual_seed(1)
    lin = nn.Linear(8, 4, 0.02, gen, "cpu")
    assert lin.bias is None
    assert [n for n, _ in lin.named_parameters()] == ["weight"]
    want = torch.empty(8, 4).normal_(0.0, 0.02,
                                     generator=torch.Generator().manual_seed(1))
    assert torch.equal(lin.weight.detach(), want)
    assert nn.Linear(8, 4, 0.02, gen, "cpu",
                     bias_attr=nn.ParamAttr()).bias is not None


def test_llama_parameter_names_unchanged():
    """After ``Linear`` gained its bias, the Llama model's parameter names
    and shapes still equal the JAX model's."""
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    for kw in ({}, dict(tie_word_embeddings=True),
               dict(fuse_attention_qkv=True, fuse_attention_ffn=True)):
        jp, _ = state_arrays(JLlama(JConfig.tiny(dtype="float32", **kw)))
        tm = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32", **kw),
                              device="cpu")
        got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
        assert got == {n: tuple(a.shape) for n, a in jp.items()}
        assert not any(n.endswith(".bias") for n in got)


# -- layers ----------------------------------------------------------------

def test_linear_with_bias_matches():
    paddle.seed(10)
    x = _rng(10).standard_normal((3, 4, 12)).astype(np.float32)
    _check_layer(jnn.Linear(12, 7), nn.Linear(12, 7, device="cpu"), [x])


def test_conv2d_layer_matches():
    paddle.seed(11)
    x = _rng(11).standard_normal((2, 6, 8, 8)).astype(np.float32)
    _check_layer(jnn.Conv2D(6, 4, 3, stride=2, padding=1, groups=2),
                 nn.Conv2D(6, 4, 3, stride=2, padding=1, groups=2,
                           device="cpu"), [x])


@pytest.mark.parametrize("norm", ["layer", "group"])
def test_norm_layers_match(norm):
    paddle.seed(12)
    if norm == "layer":
        x = _rng(12).standard_normal((2, 5, 16)).astype(np.float32)
        pair = jnn.LayerNorm(16), nn.LayerNorm(16, device="cpu")
    else:
        x = _rng(12).standard_normal((2, 8, 4, 4)).astype(np.float32)
        pair = jnn.GroupNorm(4, 8), nn.GroupNorm(4, 8, device="cpu")
    # non-trivial scale and shift through the loaded weights
    for p in pair[0].parameters():
        p.set_value(_rng(13).standard_normal(p.shape).astype(np.float32))
    _check_layer(*pair, [x])


def _mha_pair(kdim=None, vdim=None):
    paddle.seed(14)
    j = jnn.MultiHeadAttention(32, 4, kdim=kdim, vdim=vdim)
    t = nn.MultiHeadAttention(32, 4, kdim=kdim, vdim=vdim, device="cpu")
    return j, t


def test_mha_self_attention_matches():
    x = _rng(15).standard_normal((2, 9, 32)).astype(np.float32)
    _check_layer(*_mha_pair(), [x])


def test_mha_cross_attention_matches():
    """Keys and values of another width and length (kdim != embed_dim)."""
    rng = _rng(16)
    q = rng.standard_normal((2, 11, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 24)).astype(np.float32)
    _check_layer(*_mha_pair(kdim=24, vdim=24), [q, ctx, ctx])


@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_mha_masks_match(kind):
    """An attention mask sends both packages to the plain attention; an
    additive [B, 1, 1, S] padding mask and a bool [S, S] one."""
    rng = _rng(17)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    if kind == "additive":
        keep = np.ones((2, 7), np.float32)
        keep[1, 4:] = 0
        mask = ((1.0 - keep) * -1e4)[:, None, None, :]
        jm, tm = jnp.asarray(mask), _t(mask)
    else:
        mask = np.tril(np.ones((7, 7), bool))
        jm, tm = jnp.asarray(mask), _t(mask)
    j, t = _mha_pair()
    params, buffers = _layer_pair(j, t)
    want = pure_call(j, params, buffers, jnp.asarray(x), attn_mask=jm)
    _close(t(_t(x), attn_mask=tm), want)


def test_mha_cache_appends_keys_and_values():
    """The ``cache`` dict: each call's keys and values are appended along
    the sequence and stored back, in both packages."""
    rng = _rng(18)
    steps = [rng.standard_normal((1, n, 32)).astype(np.float32)
             for n in (3, 1, 1)]
    j, t = _mha_pair()
    params, buffers = _layer_pair(j, t)
    jc, tc = {}, {}
    for x in steps:
        want = pure_call(j, params, buffers, jnp.asarray(x), cache=jc)
        got = t(_t(x), cache=tc)
        _close(got, want)
    assert tuple(tc["k"].shape) == (1, 5, 4, 8) == tuple(jc["k"].shape)
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("normalize_before", [True, False])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_transformer_encoder_layer_matches(normalize_before, activation):
    paddle.seed(19)
    kw = dict(d_model=32, nhead=4, dim_feedforward=48, dropout=0.1,
              activation=activation, normalize_before=normalize_before)
    x = _rng(19).standard_normal((2, 6, 32)).astype(np.float32)
    _check_layer(jnn.TransformerEncoderLayer(**kw),
                 nn.TransformerEncoderLayer(**kw, device="cpu"), [x])


def test_transformer_encoder_copies_its_layer():
    """Every layer starts from the first's weights (a deep copy), the
    names are ``layers.{i}...`` and ``norm...``, and the stack matches."""
    paddle.seed(20)
    kw = dict(d_model=32, nhead=4, dim_feedforward=48, dropout=0.0,
              normalize_before=True)
    j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(**kw), 3,
                               norm=jnn.LayerNorm(32))
    t = nn.TransformerEncoder(nn.TransformerEncoderLayer(**kw, device="cpu"),
                              3, norm=nn.LayerNorm(32, device="cpu"))
    w0 = t.layers[0].linear1.weight
    assert all(torch.equal(layer.linear1.weight, w0) for layer in t.layers)
    assert t.layers[1].linear1.weight is not w0
    x = _rng(20).standard_normal((2, 5, 32)).astype(np.float32)
    _check_layer(j, t, [x])
