"""The PyTorch port's ``nn`` for the vision path held against the JAX
package on the CPU, part 2 (part 1: ``tests/test_torch_nn_vision.py``,
whose helpers this file uses): the common functionals and layers
(``interpolate``'s bilinear and bicubic modes, ``pad``, ``fold`` /
``unfold``, ``bilinear``, ``one_hot``, ``Embedding``'s ``padding_idx``,
the channel and alpha dropouts), every loss that ``nn.layers.loss``
wraps but ``CTCLoss`` with the element-wise functionals up to
``gaussian_nll_loss``, the convolutions in 1-3D and their transposes
(``output_padding``, ``output_size``, groups, dilation, asymmetric and
string pads, channels-last) and the initializers.

Tolerance: float32 within 1e-5 of the reference's largest magnitude (at
least 1), as part 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.jit.functional import state_arrays  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn import initializer as TI  # noqa: E402
from test_torch_nn_vision import (  # noqa: E402
    _check, _close, _j, _np, _pair, _rng, _t)


# -- common functionals and layers -----------------------------------------

@pytest.mark.parametrize("mode,kw", [
    ("bilinear", dict(scale_factor=2)), ("bilinear", dict(size=(5, 11))),
    ("bilinear", dict(size=(3, 2))), ("bicubic", dict(scale_factor=2)),
    ("bicubic", dict(size=(7, 4))), ("bicubic", dict(size=(3, 3))),
    ("linear", dict(size=(4, 9)))])
def test_interpolate_bilinear_and_bicubic_match(mode, kw):
    """``jax.image.resize``'s linear and cubic, up and down (its
    antialiasing on a downscale), half-pixel centers."""
    x = _rng(40).standard_normal((2, 3, 6, 8)).astype(np.float32)
    _check(lambda a: JF.interpolate(a, mode=mode, **kw),
           lambda a: TF.interpolate(a, mode=mode, **kw), [x])
    xl = np.moveaxis(x, 1, -1)
    _close(TF.interpolate(_t(xl), mode=mode, data_format="NHWC", **kw),
           JF.interpolate(_j(xl), mode=mode, data_format="NHWC", **kw))


def test_upsample_layers_match():
    x = _rng(41).standard_normal((1, 2, 4, 5)).astype(np.float32)
    for jl, tl in ((jnn.Upsample(scale_factor=2, mode="bilinear"),
                    nn.Upsample(scale_factor=2, mode="bilinear")),
                   (jnn.UpsamplingBilinear2D(size=(7, 3)),
                    nn.UpsamplingBilinear2D(size=(7, 3))),
                   (jnn.UpsamplingNearest2D(scale_factor=3),
                    nn.UpsamplingNearest2D(scale_factor=3))):
        _close(tl(_t(x)), jl(_j(x)))


COMMON = [
    ("normalize", lambda F: (lambda a: F.normalize(a, p=2, axis=1)), 1),
    ("normalize_p3", lambda F: (lambda a: F.normalize(a, p=3, axis=-1)), 1),
    ("pixel_shuffle", lambda F: (lambda a: F.pixel_shuffle(a, 2)), 1),
    ("pixel_unshuffle", lambda F: (lambda a: F.pixel_unshuffle(a, 2)), 1),
    ("unfold", lambda F: (lambda a: F.unfold(a, [2, 3], 1, 1, 1)), 1),
    ("unfold_strided", lambda F: (lambda a: F.unfold(a, 3, 2, 0, 2)), 1),
    ("label_smooth", lambda F: (lambda a: F.label_smooth(a, epsilon=0.2)), 1),
    ("cosine_similarity",
     lambda F: (lambda a, b: F.cosine_similarity(a, b, axis=1)), 2),
    ("pairwise_distance",
     lambda F: (lambda a, b: F.pairwise_distance(a, b, p=3.0)), 2),
]


@pytest.mark.parametrize("name,make,n", COMMON, ids=[c[0] for c in COMMON])
def test_common_functionals_match(name, make, n):
    rng = _rng(42)
    shape = (2, 8, 6, 6)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    _check(make(JF), make(TF), xs)


def test_fold_inverts_unfold_as_jax():
    x = _rng(43).standard_normal((2, 3 * 4, 20)).astype(np.float32)
    _check(lambda a: JF.fold(a, (5, 6), 2, 1, 0, 1),
           lambda a: TF.fold(a, (5, 6), 2, 1, 0, 1), [x])
    y = _rng(44).standard_normal((1, 2 * 9, 9)).astype(np.float32)
    _check(lambda a: JF.fold(a, 5, 3, 2, 1, 1),
           lambda a: TF.fold(a, 5, 3, 2, 1, 1), [y])


def test_bilinear_matches():
    rng = _rng(45)
    x1 = rng.standard_normal((4, 3)).astype(np.float32)
    x2 = rng.standard_normal((4, 5)).astype(np.float32)
    w = rng.standard_normal((2, 3, 5)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    _check(JF.bilinear, TF.bilinear, [x1, x2, w, b])
    jl, tl = jnn.Bilinear(3, 5, 2), nn.Bilinear(3, 5, 2, device="cpu")
    _pair(jl, tl)
    _close(tl(_t(x1), _t(x2)), jl(_j(x1), _j(x2)))


@pytest.mark.parametrize("spec,mode,fmt", [
    ([1, 2, 0, 3], "constant", "NCHW"), ([2, 1], "reflect", "NCHW"),
    ([1, 1, 2, 0], "replicate", "NCHW"), ([1, 2, 1, 1], "circular", "NCHW"),
    ([0, 0, 1, 2, 3, 0, 0, 0], "constant", "NCHW"),
    ([1, 0, 2, 1], "constant", "NHWC"), ([2, 1, 1, 0], "reflect", "NHWC")])
def test_pad_matches(spec, mode, fmt):
    from paddle_tpu import ops as jops
    x = _rng(46).standard_normal((2, 3, 4, 5)).astype(np.float32)
    _check(lambda a: jops.pad(a, spec, mode=mode, value=0.5,
                              data_format=fmt),
           lambda a: TF.pad(a, spec, mode=mode, value=0.5, data_format=fmt),
           [x])


def test_pad_layers_and_zero_pad_match():
    x = _rng(47).standard_normal((2, 3, 4, 5)).astype(np.float32)
    for jl, tl in ((jnn.Pad2D([1, 2, 0, 1], mode="reflect"),
                    nn.Pad2D([1, 2, 0, 1], mode="reflect")),
                   (jnn.ZeroPad2D([1, 0, 2, 1]), nn.ZeroPad2D([1, 0, 2, 1])),
                   (jnn.ZeroPad2D(2), nn.ZeroPad2D(2))):
        _close(tl(_t(x)), jl(_j(x)))
    xl = np.moveaxis(x, 1, -1)
    _close(nn.ZeroPad2D([1, 0, 2, 1], data_format="NHWC")(_t(xl)),
           jnn.ZeroPad2D([1, 0, 2, 1], data_format="NHWC")(_j(xl)))


def test_one_hot_and_embedding_padding_idx_match():
    ids = np.array([[0, 3, 5], [2, 5, 1]], dtype=np.int64)
    _close(TF.one_hot(_t(ids), 6), JF.one_hot(_j(ids), 6), 0.0)
    _close(TF.one_hot(_t(np.array([-1, 7])), 6),
           JF.one_hot(_j(np.array([-1, 7])), 6), 0.0)
    w = _rng(48).standard_normal((6, 4)).astype(np.float32)
    _close(TF.embedding(_t(ids), _t(w), padding_idx=5),
           JF.embedding(_j(ids), _j(w), padding_idx=5))
    jl = jnn.Embedding(6, 4, padding_idx=5)
    tl = nn.Embedding(6, 4, padding_idx=5, device="cpu")
    _pair(jl, tl)
    out = tl(_t(ids))
    _close(out, jl(_j(ids)))
    out.sum().backward()
    assert float(tl.weight.grad[5].abs().sum()) == 0.0
    assert float(tl.weight.grad[3].abs().sum()) > 0.0


def test_simple_common_layers_match():
    rng = _rng(49)
    x = rng.standard_normal((2, 8, 4, 6)).astype(np.float32)
    y = rng.standard_normal((2, 8, 4, 6)).astype(np.float32)
    for jl, tl, args in (
            (jnn.Identity(), nn.Identity(), (x,)),
            (jnn.Flatten(), nn.Flatten(), (x,)),
            (jnn.Flatten(2, 3), nn.Flatten(2, 3), (x,)),
            (jnn.PixelShuffle(2), nn.PixelShuffle(2), (x,)),
            (jnn.PixelUnshuffle(2), nn.PixelUnshuffle(2), (x,)),
            (jnn.CosineSimilarity(axis=2), nn.CosineSimilarity(axis=2),
             (x, y)),
            (jnn.PairwiseDistance(), nn.PairwiseDistance(), (x, y)),
            (jnn.Unfold(2, 2), nn.Unfold(2, 2), (x,)),
            (jnn.Fold((3, 4), 2, 1), nn.Fold((3, 4), 2, 1),
             (x.reshape(2, 8, 24)[:, :, :6],))):
        _close(tl(*[_t(a) for a in args]), jl(*[_j(a) for a in args]))


def test_channel_dropouts_and_alpha_dropout():
    """Dropout2D / 3D drop whole (N, C) maps; AlphaDropout keeps the
    SELU statistics; all are the identity in eval."""
    from paddle_tpu_torch.core import random as trand
    trand.seed(3)
    x = torch.ones(8, 16, 5, 5)
    out = nn.Dropout2D(0.5)(x)
    maps = out.reshape(8, 16, -1)
    assert bool(((maps == 0).all(-1) | (maps == 2).all(-1)).all())
    out3 = TF.dropout3d(torch.ones(4, 8, 2, 3, 3), 0.5)
    assert bool(((out3 == 0).flatten(2).all(-1)
                 | (out3 == 2).flatten(2).all(-1)).all())
    z = _t(_rng(50).standard_normal((200, 200)).astype(np.float32))
    a = TF.alpha_dropout(z, 0.2)
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05
    for layer in (nn.Dropout2D(0.5), nn.Dropout3D(0.5), nn.AlphaDropout()):
        layer.eval()
        assert layer(x) is x


# -- losses --------------------------------------------------------------

def _loss_inputs(rng, name):
    """(float inputs, fixed integer / label inputs) of a loss."""
    n, c = 6, 5
    z = rng.standard_normal((n, c)).astype(np.float32)
    y01 = (rng.random((n, c)) > 0.5).astype(np.float32)
    p = (0.05 + 0.9 * rng.random((n, c))).astype(np.float32)
    lbl = rng.integers(0, c, (n,)).astype(np.int64)
    pm = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    return {"z": z, "y01": y01, "p": p, "lbl": lbl, "pm": pm,
            "z2": rng.standard_normal((n, c)).astype(np.float32),
            "z3": rng.standard_normal((n, c)).astype(np.float32),
            "pos": (rng.random((n, c)) * 3).astype(np.float32),
            "var": (0.5 + rng.random((n, c))).astype(np.float32),
            "w": (0.5 + rng.random(c)).astype(np.float32)}


LOSSES = [
    # name, float args, fixed args (as keywords or trailing), kwargs
    ("mse_loss", ["z", "z2"], [], {}),
    ("l1_loss", ["z", "z2"], [], dict(reduction="sum")),
    ("smooth_l1_loss", ["z", "z2"], [], dict(delta=0.5)),
    ("huber_loss", ["z", "z2"], [], dict(delta=0.7, reduction="none")),
    ("binary_cross_entropy", ["p"], ["y01"], {}),
    ("binary_cross_entropy_with_logits", ["z"], ["y01"], {}),
    ("kl_div", ["z"], ["p"], dict(reduction="batchmean")),
    ("kl_div", ["z", "z2"], [], dict(log_target=True)),
    ("log_loss", ["p"], ["y01"], {}),
    ("square_error_cost", ["z", "z2"], [], {}),
    ("soft_margin_loss", ["z"], ["y01"], {}),
    ("multi_label_soft_margin_loss", ["z"], ["y01"], {}),
    ("poisson_nll_loss", ["z"], ["pos"], dict(full=True)),
    ("poisson_nll_loss", ["var"], ["pos"], dict(log_input=False)),
    ("gaussian_nll_loss", ["z", "z2", "var"], [], dict(full=True)),
    ("sigmoid_focal_loss", ["z"], ["y01"], {}),
    ("triplet_margin_loss", ["z", "z2", "z3"], [], dict(swap=True)),
    ("cosine_embedding_loss", ["z", "z2"], ["pm"], dict(margin=0.1)),
    ("nll_loss", ["z"], ["lbl"], {}),
    ("multi_margin_loss", ["z"], ["lbl"], dict(p=2, margin=0.5)),
    ("cross_entropy", ["z"], ["lbl"], dict(label_smoothing=0.1)),
    ("cross_entropy", ["p"], ["y01"], dict(soft_label=True)),
]


@pytest.mark.parametrize("name,floats,fixed,kw", LOSSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_losses_match(name, floats, fixed, kw):
    vals = _loss_inputs(_rng(60), name)
    fixed_v = [vals[k] for k in fixed]

    def jf(*a):
        return getattr(JF, name)(*a, *[_j(v) for v in fixed_v], **kw)

    def tf(*a):
        return getattr(TF, name)(*a, *[_t(v) for v in fixed_v], **kw)
    _check(jf, tf, [vals[k] for k in floats])


def test_weighted_losses_match():
    vals = _loss_inputs(_rng(61), "w")
    w = vals["w"]
    _check(lambda a: JF.nll_loss(a, _j(vals["lbl"]), _j(w)),
           lambda a: TF.nll_loss(a, _t(vals["lbl"]), _t(w)), [vals["z"]])
    _check(lambda a: JF.binary_cross_entropy(a, _j(vals["y01"]), _j(w)),
           lambda a: TF.binary_cross_entropy(a, _t(vals["y01"]), _t(w)),
           [vals["p"]])
    _check(lambda a: JF.binary_cross_entropy_with_logits(
               a, _j(vals["y01"]), pos_weight=_j(w)),
           lambda a: TF.binary_cross_entropy_with_logits(
               a, _t(vals["y01"]), pos_weight=_t(w)), [vals["z"]])
    _check(lambda a, b: JF.margin_ranking_loss(a, b, _j(vals["pm"][:, None]),
                                               0.2),
           lambda a, b: TF.margin_ranking_loss(a, b, _t(vals["pm"][:, None]),
                                               0.2),
           [vals["z"], vals["z2"]])
    _check(lambda a: JF.hinge_embedding_loss(a, _j(vals["pm"][:, None])),
           lambda a: TF.hinge_embedding_loss(a, _t(vals["pm"][:, None])),
           [vals["z"]])
    lbl = vals["lbl"][:, None]
    _check(lambda a: JF.dice_loss(JF.softmax(a), _j(lbl)),
           lambda a: TF.dice_loss(TF.softmax(a), _t(lbl)), [vals["z"]])
    _check(lambda a: JF.softmax_with_cross_entropy(a, _j(lbl)),
           lambda a: TF.softmax_with_cross_entropy(a, _t(lbl)), [vals["z"]])


LOSS_LAYERS = [
    ("MSELoss", (), ["z", "z2"]), ("L1Loss", ("sum",), ["z", "z2"]),
    ("NLLLoss", (), ["z", "lbl"]), ("BCELoss", (), ["p", "y01"]),
    ("BCEWithLogitsLoss", (), ["z", "y01"]),
    ("SmoothL1Loss", (), ["z", "z2"]), ("HuberLoss", (), ["z", "z2"]),
    ("KLDivLoss", ("sum",), ["z", "p"]),
    ("MarginRankingLoss", (0.1,), ["z", "z2", "pm1"]),
    ("CosineEmbeddingLoss", (0.1,), ["z", "z2", "pm"]),
    ("TripletMarginLoss", (), ["z", "z2", "z3"]),
    ("CrossEntropyLoss", (), ["z", "lbl1"]),
]


@pytest.mark.parametrize("name,args,ins", LOSS_LAYERS)
def test_loss_layers_match(name, args, ins):
    vals = _loss_inputs(_rng(62), name)
    vals["pm1"] = vals["pm"][:, None]
    vals["lbl1"] = vals["lbl"][:, None]
    _close(getattr(nn, name)(*args)(*[_t(vals[k]) for k in ins]),
           getattr(jnn, name)(*args)(*[_j(vals[k]) for k in ins]))


def test_cross_entropy_loss_takes_vision_labels_to_kernel_c():
    """A vision label [B, 1] int64 reaches the token CE kernel's route
    (its plain version on the CPU), as a [B] label does."""
    from paddle_tpu_torch.ops import token_ce
    calls = []
    real = token_ce.TokenCrossEntropy.apply
    token_ce.TokenCrossEntropy.apply = \
        lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        z = _rng(63).standard_normal((8, 1000)).astype(np.float32)
        y = _rng(64).integers(0, 1000, (8, 1)).astype(np.int64)
        got = nn.CrossEntropyLoss()(_t(z), _t(y))
    finally:
        token_ce.TokenCrossEntropy.apply = real
    assert calls == [torch.Size([8, 1000])]
    _close(got, jnn.CrossEntropyLoss()(_j(z), _j(y)))


# -- convolutions ----------------------------------------------------------

CONVS = [
    # nd, fmt, stride, padding, groups, dilation
    (1, "NCL", 1, 1, 1, 1), (1, "NCL", 2, [1, 2], 2, 1),
    (1, "NLC", 1, "SAME", 1, 2), (3, "NCDHW", 1, 1, 1, 1),
    (3, "NCDHW", 2, [0, 1, 1, 0, 1, 2], 2, 1), (3, "NDHWC", 1, 0, 1, 1),
    (2, "NCHW", 1, 1, 8, 1),                   # depthwise
]


@pytest.mark.parametrize("nd,fmt,s,p,g,d", CONVS)
def test_conv1d_conv3d_match(nd, fmt, s, p, g, d):
    rng = _rng(70)
    sp = {1: (11,), 2: (7, 6), 3: (5, 6, 4)}[nd]
    cin, cout = 8, 8
    x = rng.standard_normal((2, cin) + sp).astype(np.float32)
    if not fmt.startswith("NC"):
        x = np.moveaxis(x, 1, -1)
    w = (0.3 * rng.standard_normal((cout, cin // g) + (3,) * nd)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    kw = dict(stride=s, padding=p, groups=g, dilation=d, data_format=fmt)
    name = f"conv{nd}d"
    _check(lambda *a: getattr(JF, name)(*a, **kw),
           lambda *a: getattr(TF, name)(*a, **kw), [x, w, b])


TRANSPOSES = [
    # nd, stride, padding, output_padding, groups, dilation, output_size
    (2, 2, 1, 1, 1, 1, None), (2, 2, 1, 0, 2, 1, None),
    (2, 2, 0, 0, 1, 1, (12, 14)), (2, 3, 1, 0, 1, 2, None),
    (2, 2, [1, 0, 0, 1], 0, 1, 1, None), (2, 2, "SAME", 0, 1, 1, None),
    (2, 1, "VALID", 0, 2, 1, None), (2, 2, 1, 1, 4, 1, (9, 11)),
    (1, 2, 1, 1, 1, 1, None), (1, 3, 0, 0, 2, 1, (23,)),
    (3, 2, 1, 1, 1, 1, None), (3, 2, 0, 0, 2, 1, None),
]


@pytest.mark.parametrize("nd,s,p,op,g,d,osz", TRANSPOSES)
def test_conv_transposes_match(nd, s, p, op, g, d, osz):
    """Transposed convolutions with output_padding, output_size, groups,
    dilation and asymmetric / string pads (paddle's [in, out / groups, *k]
    weight)."""
    rng = _rng(71)
    sp = {1: (7,), 2: (5, 6), 3: (3, 4, 3)}[nd]
    cin, cout = 4, 8
    x = rng.standard_normal((2, cin) + sp).astype(np.float32)
    w = (0.3 * rng.standard_normal((cin, cout // g) + (3,) * nd)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    name = f"conv{nd}d_transpose"
    kw = dict(stride=s, padding=p, output_padding=op, groups=g, dilation=d,
              output_size=osz)
    out = _check(lambda *a: getattr(JF, name)(*a, **kw),
                 lambda *a: getattr(TF, name)(*a, **kw), [x, w, b])
    if osz is not None:
        assert tuple(out.shape[2:]) == tuple(osz)


def test_conv_transpose_channels_last_and_unreachable_size():
    rng = _rng(72)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 3, 3, 3))).astype(np.float32)
    _close(TF.conv2d_transpose(_t(x), _t(w), stride=2, padding=1,
                               data_format="NHWC"),
           JF.conv2d_transpose(_j(x), _j(w), stride=2, padding=1,
                               data_format="NHWC"))
    with pytest.raises(ValueError, match="not reachable"):
        TF.conv2d_transpose(_t(np.moveaxis(x, -1, 1)), _t(w), stride=2,
                            output_size=(20, 20))


CONV_LAYERS = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9)),
    ("Conv3D", (4, 6, 3), dict(padding=1, groups=2), (1, 4, 4, 5, 4)),
    ("Conv2D", (4, 8, 3), dict(padding=1, groups=4), (2, 4, 6, 6)),
    ("Conv1DTranspose", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 5)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                        output_padding=1), (2, 4, 4, 5)),
    ("Conv3DTranspose", (4, 6, 3), dict(stride=2, groups=2), (1, 4, 3, 3, 2)),
]


@pytest.mark.parametrize("name,args,kw,shape", CONV_LAYERS)
def test_conv_layers_match(name, args, kw, shape):
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(nn, name)(*args, **kw, device="cpu")
    params = state_arrays(jl)[0]
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == \
        {n: tuple(a.shape) for n, a in params.items()}
    _pair(jl, tl)
    x = _rng(73).standard_normal(shape).astype(np.float32)
    _close(tl(_t(x)), jl(_j(x)))


# -- initializers ----------------------------------------------------------

def test_deterministic_initializers_equal_jax():
    gen = torch.Generator().manual_seed(0)
    for ti, ji, shape in ((TI.Dirac(), JI.Dirac(), (4, 4, 3, 3)),
                          (TI.Dirac(2), JI.Dirac(2), (6, 3, 3)),
                          (TI.Bilinear(), JI.Bilinear(), (2, 3, 4, 4)),
                          (TI.Bilinear(), JI.Bilinear(), (1, 1, 3, 5)),
                          (TI.Assign(np.arange(6.0)), JI.Assign(np.arange(6.0)),
                           (2, 3))):
        np.testing.assert_array_equal(_np(ti(shape, gen, "cpu")),
                                      np.asarray(ji(shape, "float32")))
    for name in ("sigmoid", "tanh", "relu", "selu", "conv2d", "linear"):
        assert TI.calculate_gain(name) == JI.calculate_gain(name)
    assert TI.calculate_gain("leaky_relu", 0.3) == \
        JI.calculate_gain("leaky_relu", 0.3)
    for alias in ("constant_", "normal_", "uniform_", "xavier_normal_",
                  "xavier_uniform_", "kaiming_normal_", "kaiming_uniform_"):
        assert getattr(TI, alias).__name__ == getattr(JI, alias).__name__


def test_random_initializers_keep_the_jax_laws():
    """The two frameworks draw different numbers: the laws (bounds, stds,
    orthogonality) are held, and a generator's seed gives the same draw."""
    gen = torch.Generator().manual_seed(1)
    t = TI.TruncatedNormal(0.5, 2.0, -1.0, 1.5)((20000,), gen, "cpu")
    assert float(t.min()) >= 0.5 - 2.0 - 1e-6
    assert float(t.max()) <= 0.5 + 3.0 + 1e-6
    u = TI.XavierUniform()((300, 500), gen, "cpu")
    assert float(u.abs().max()) <= (6.0 / 800) ** 0.5
    assert abs(float(u.std()) - (2.0 / 800) ** 0.5) < 2e-3
    k = TI.KaimingNormal()((256, 64, 3, 3), gen, "cpu")
    assert abs(float(k.std()) - (2.0 / (64 * 9)) ** 0.5) < 2e-3
    o = TI.Orthogonal(2.0)((6, 10), gen, "cpu")
    np.testing.assert_allclose(_np(o @ o.T), 4.0 * np.eye(6), atol=1e-5)
    a = TI.XavierUniform()((4, 4), torch.Generator().manual_seed(3), "cpu")
    b = TI.XavierUniform()((4, 4), torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a, b)
