"""The serving half of ``fused_multi_transformer``'s options and the rest of
``incubate.nn`` in the PyTorch port, held against the JAX package on the
CPU on the same seeded numpy inputs (f32, matmuls at float32 precision,
atol 2e-5 as tests/test_pallas_fused.py holds the JAX ops):

* ``pre_caches`` (prompt-prefix KV in dense prefill, MHA and GQA) against
  JAX and against one prefill over the concatenated tokens;
* ``attn_mask`` in dense prefill and dense decode;
* dropout: p = 0 in training and p > 0 in eval equal JAX; with p > 0 in
  training the keep share is within 6 sigma of 1 - p and the kept values
  are scaled exactly (the bits of the draw differ from JAX's by design);
* ``fused_multi_head_attention`` (with and without a cache, a mask, pre-
  and post-LN), ``fused_feedforward`` (pre- and post-LN, each
  activation) and ``variable_length_memory_efficient_attention`` (causal,
  ``pre_cache_length``, a mask);
* the seven fused layers with the JAX layers' weights carried over by
  ``fused_layer_state_from_numpy``;
* one gradient check of ``fused_multi_transformer`` in training (no
  caches) against the JAX package's autograd (``jax.vjp``);
* the refusals the JAX package makes, with its messages.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate import nn as JN  # noqa: E402
from paddle_tpu.incubate.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.incubate import nn as TN  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TF  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _f32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _weights(rng, L, E, H, D, F, G=0, glu=False):
    def mk(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    qkv = (H + 2 * G, D, E) if G else (3, H, D, E)
    return dict(
        ln_scales=[mk(E, scale=1.0) for _ in range(L)],
        ln_biases=[mk(E) for _ in range(L)],
        qkv_weights=[mk(*qkv) for _ in range(L)],
        qkv_biases=[mk(*qkv[:-1]) for _ in range(L)],
        linear_weights=[mk(H * D, E) for _ in range(L)],
        linear_biases=[mk(E) for _ in range(L)],
        ffn_ln_scales=[mk(E, scale=1.0) for _ in range(L)],
        ffn_ln_biases=[mk(E) for _ in range(L)],
        ffn1_weights=[mk(E, 2 * F if glu else F) for _ in range(L)],
        ffn1_biases=[mk(2 * F if glu else F) for _ in range(L)],
        ffn2_weights=[mk(F, E) for _ in range(L)],
        ffn2_biases=[mk(E) for _ in range(L)])


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _both(fn_j, fn_t, w, x, caches=(), **kw):
    """Run fused_multi_transformer (or a wrapper) on both packages from
    numpy; returns (port out, JAX out, port caches, JAX caches)."""
    jc = [_j(c.copy()) for c in caches]
    tc = [_t(c.copy()) for c in caches]
    jkw = {k: ([_j(a) for a in v] if isinstance(v, list)
               else _j(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: ([_t(a) for a in v] if isinstance(v, list)
               else _t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jo = fn_j(_j(x), cache_kvs=jc or None,
              **{k: [_j(a) for a in v] for k, v in w.items()}, **jkw)
    to = fn_t(_t(x), cache_kvs=tc or None,
              **{k: [_t(a) for a in v] for k, v in w.items()}, **tkw)
    return _np(to), _np(jo), [_np(c) for c in tc], [_np(c) for c in jc]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


GEOMS = {"mha": dict(H=4, G=0, glu=False, kw={}),
         "gqa": dict(H=4, G=2, glu=True,
                     kw=dict(norm_type="rmsnorm", activation="swiglu",
                             gqa_group_size=2))}


class TestPreCaches:
    @pytest.mark.parametrize("geom", sorted(GEOMS))
    def test_prefix_matches_jax_and_concatenated_prefill(self, geom):
        g = GEOMS[geom]
        rng = np.random.default_rng(11)
        B, SP, S, E, D, F, L = 2, 3, 4, 32, 8, 48, 1
        H, G = g["H"], g["G"]
        kvh = G or H
        w = _weights(rng, L, E, H, D, F, G=G, glu=g["glu"])
        xp = rng.standard_normal((B, SP, E)).astype(np.float32)
        xs = rng.standard_normal((B, S, E)).astype(np.float32)
        smax = SP + S + 2
        # the concatenated prefill, whose cache holds the prefix KV
        zeros = [np.zeros((2, B, kvh, smax, D), np.float32)
                 for _ in range(L)]
        full, _, fc, _ = _both(JF.fused_multi_transformer,
                               TF.fused_multi_transformer, w,
                               np.concatenate([xp, xs], 1), zeros, **g["kw"])
        pre = [c[:, :, :, :SP].copy() for c in fc]
        to, jo, tc, jc = _both(JF.fused_multi_transformer,
                               TF.fused_multi_transformer, w, xs, zeros,
                               pre_caches=pre, **g["kw"])
        _close(to, jo)
        for a, b in zip(tc, jc):
            _close(a, b)
        _close(to, full[:, SP:])                  # the suffix rows
        for a, b in zip(tc, fc):                  # prefix + new from 0
            _close(a[:, :, :, :SP + S], b[:, :, :, :SP + S])

    def test_prefix_with_seq_lens_and_no_cache(self):
        rng = np.random.default_rng(12)
        B, SP, S, E, H, D, F, L = 3, 2, 5, 32, 4, 8, 48, 1
        w = _weights(rng, L, E, H, D, F)
        pre = [(rng.standard_normal((2, B, H, SP, D)) * 0.5).astype(
            np.float32) for _ in range(L)]
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        to, jo, _, _ = _both(JF.fused_multi_transformer,
                             TF.fused_multi_transformer, w, x,
                             pre_caches=pre,
                             seq_lens=np.array([2, 5, 4], np.int32))
        _close(to, jo)


class TestAttnMask:
    def test_prefill_mask(self):
        rng = np.random.default_rng(13)
        B, S, E, H, D, F, L, SMAX = 2, 5, 32, 4, 8, 48, 1, 8
        w = _weights(rng, L, E, H, D, F)
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        mask = np.where(rng.random((B, H, S, S)) < 0.3, -1e4,
                        rng.standard_normal((B, H, S, S))).astype(np.float32)
        caches = [np.zeros((2, B, H, SMAX, D), np.float32)
                  for _ in range(L)]
        to, jo, tc, jc = _both(JF.fused_multi_transformer,
                               TF.fused_multi_transformer, w, x, caches,
                               attn_mask=mask)
        _close(to, jo)
        for a, b in zip(tc, jc):
            _close(a, b)

    @pytest.mark.parametrize("geom", sorted(GEOMS))
    def test_decode_mask(self, geom):
        g = GEOMS[geom]
        rng = np.random.default_rng(14)
        B, S, E, D, F, L, SMAX = 2, 4, 32, 8, 48, 1, 8
        H, G = g["H"], g["G"]
        w = _weights(rng, L, E, H, D, F, G=G, glu=g["glu"])
        caches = [(rng.standard_normal((2, B, G or H, SMAX, D)) * 0.5)
                  .astype(np.float32) for _ in range(L)]
        x = rng.standard_normal((B, 1, E)).astype(np.float32)
        mh = 1 if G else H
        mask = (rng.standard_normal((B, mh, 1, SMAX)) * 2).astype(np.float32)
        to, jo, tc, jc = _both(JF.fused_multi_transformer,
                               TF.fused_multi_transformer, w, x, caches,
                               attn_mask=mask, time_step=S, **g["kw"])
        _close(to, jo)
        for a, b in zip(tc, jc):
            _close(a, b)

    def test_zero_mask_is_bit_equal_and_neg_mask_drops_columns(self):
        rng = np.random.default_rng(15)
        B, S, E, H, G, D, F, L = 2, 6, 32, 4, 2, 8, 48, 2
        w = {k: [_t(a) for a in v] for k, v in
             _weights(rng, L, E, H, D, F, G=G, glu=True).items()}
        kw = dict(w, norm_type="rmsnorm", activation="swiglu",
                  gqa_group_size=G)
        x = _t(rng.standard_normal((B, S, E)).astype(np.float32))
        base = TF.fused_multi_transformer(x, **kw)
        zero = TF.fused_multi_transformer(
            x, attn_mask=torch.zeros((B, 1, S, S)), **kw)
        assert torch.equal(base, zero)
        lens = np.array([4, 6], np.int32)
        mask = torch.zeros((B, 1, S, S))
        mask[0, :, :, 4:] = -1e30
        dropped = TF.fused_multi_transformer(x, seq_lens=lens, **kw)
        masked = TF.fused_multi_transformer(x, attn_mask=mask, **kw)
        assert torch.equal(dropped, masked)


class TestDropout:
    def _setup(self, rng, L=2):
        B, S, E, H, D, F = 2, 5, 32, 4, 8, 48
        w = _weights(rng, L, E, H, D, F)
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        return w, x

    @pytest.mark.parametrize("training,p", [(True, 0.0), (False, 0.5)],
                             ids=["train_p0", "eval_p05"])
    def test_matches_jax_without_a_draw(self, training, p):
        w, x = self._setup(np.random.default_rng(16))
        to, jo, _, _ = _both(JF.fused_multi_transformer,
                             TF.fused_multi_transformer, w, x,
                             training=training, dropout_rate=p)
        _close(to, jo)

    def test_eval_is_bit_equal_to_p0(self):
        w, x = self._setup(np.random.default_rng(17))
        tw = {k: [_t(a) for a in v] for k, v in w.items()}
        a = TF.fused_multi_transformer(_t(x), **tw, dropout_rate=0.3,
                                       training=False)
        b = TF.fused_multi_transformer(_t(x), **tw)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("mode", ["upscale_in_train",
                                      "downscale_in_infer"])
    def test_keep_share_and_scaling(self, mode):
        """A zero input and a zero FFN make the output the dropped
        attention projection itself (0 + a, then + 0, exactly): each
        element is 0 or the undropped value scaled exactly."""
        rng = np.random.default_rng(18)
        B, S, E, H, D, F = 4, 16, 64, 4, 16, 32
        w = _weights(rng, 1, E, H, D, F)
        w["ffn2_weights"] = [np.zeros((F, E), np.float32)]
        w["ffn2_biases"] = [np.zeros(E, np.float32)]
        tw = {k: [_t(a) for a in v] for k, v in w.items()}
        x = torch.zeros((B, S, E))
        p = 0.1
        kw = dict(tw, mode=mode)
        ref = TF.fused_multi_transformer(x, **kw)
        got = TF.fused_multi_transformer(x, training=True, dropout_rate=p,
                                         **kw)
        kept = got != 0
        n = kept.numel()
        share = float(kept.float().mean())
        assert abs(share - (1 - p)) <= 6 * math.sqrt(p * (1 - p) / n)
        want = ref / (1 - p) if mode == "upscale_in_train" else ref
        assert torch.equal(got[kept], want[kept])


class TestFunctions:
    @pytest.mark.parametrize("pre_ln", [True, False], ids=["pre", "post"])
    @pytest.mark.parametrize("cache", [False, True], ids=["nocache",
                                                          "cache"])
    def test_fused_multi_head_attention(self, pre_ln, cache):
        rng = np.random.default_rng(19)
        B, S, SC, E, H = 2, 4, 3, 32, 4
        D = E // H

        def mk(*shape, scale=0.2):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        x = mk(B, S, E, scale=1.0)
        args = dict(qkv_weight=mk(3, H, D, E), linear_weight=mk(E, E),
                    pre_ln_scale=mk(E) + 1, pre_ln_bias=mk(E),
                    ln_scale=mk(E) + 1, ln_bias=mk(E), qkv_bias=mk(3 * E),
                    linear_bias=mk(E))
        skv = S + (SC if cache else 0)
        args["attn_mask"] = mk(B, H, S, skv, scale=1.0)
        if cache:
            args["cache_kv"] = mk(2, B, SC, H, D, scale=1.0)
        jo = JF.fused_multi_head_attention(
            _j(x), pre_layer_norm=pre_ln, training=False,
            **{k: _j(v) for k, v in args.items()})
        to = TF.fused_multi_head_attention(
            _t(x), pre_layer_norm=pre_ln, training=False,
            **{k: _t(v) for k, v in args.items()})
        if cache:
            _close(_np(to[1]), _np(jo[1]))
            to, jo = to[0], jo[0]
        _close(_np(to), _np(jo))

    @pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
    @pytest.mark.parametrize("pre_ln", [True, False], ids=["pre", "post"])
    def test_fused_feedforward(self, act, pre_ln):
        rng = np.random.default_rng(20)
        B, S, E, Fd = 2, 3, 16, 24

        def mk(*shape, scale=0.3):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        x = mk(B, S, E, scale=1.0)
        args = dict(linear1_weight=mk(E, Fd), linear2_weight=mk(Fd, E),
                    linear1_bias=mk(Fd), linear2_bias=mk(E),
                    ln1_scale=mk(E) + 1, ln1_bias=mk(E),
                    ln2_scale=mk(E) + 1, ln2_bias=mk(E))
        jo = JF.fused_feedforward(_j(x), activation=act,
                                  pre_layer_norm=pre_ln, training=False,
                                  **{k: _j(v) for k, v in args.items()})
        to = TF.fused_feedforward(_t(x), activation=act,
                                  pre_layer_norm=pre_ln, training=False,
                                  **{k: _t(v) for k, v in args.items()})
        _close(_np(to), _np(jo))
        # p > 0 in training: the draw differs, the kept share does not
        big = _t(mk(64, 32, E, scale=1.0))
        tw = {k: _t(v) for k, v in args.items()}
        out = TF.fused_feedforward(big, dropout1_rate=0.0,
                                   dropout2_rate=0.25, activation=act,
                                   pre_layer_norm=pre_ln, training=True,
                                   **tw)
        assert out.shape == big.shape and bool(torch.isfinite(out).all())

    @pytest.mark.parametrize("causal,pre,masked", [
        (False, 0, False), (True, 0, False), (True, 2, True)],
        ids=["plain", "causal", "causal_pre_mask"])
    def test_variable_length_attention(self, causal, pre, masked):
        rng = np.random.default_rng(21)
        B, H, S, SKV, D = 3, 2, 5, 7, 8
        q, k, v = (rng.standard_normal((B, H, n, D)).astype(np.float32)
                   for n in (S, SKV, SKV))
        sl = np.array([5, 3, 1], np.int32)
        kvl = np.array([7, 4, 6], np.int32)
        mask = rng.standard_normal((B, 1, S, SKV)).astype(np.float32) \
            if masked else None
        jo = JF.variable_length_memory_efficient_attention(
            _j(q), _j(k), _j(v), _j(sl), _j(kvl),
            mask=None if mask is None else _j(mask), causal=causal,
            pre_cache_length=pre)
        to = TF.variable_length_memory_efficient_attention(
            _t(q), _t(k), _t(v), _t(sl), _t(kvl),
            mask=None if mask is None else _t(mask), causal=causal,
            pre_cache_length=pre)
        _close(_np(to), _np(jo))


def _carry(jlayer, tlayer):
    """The JAX layer's parameters into the port's; both in eval mode."""
    TN.fused_layer_state_from_numpy(
        tlayer, {n: np.asarray(p.numpy()) for n, p in
                 jlayer.named_parameters()})
    jlayer.eval()
    tlayer.eval()
    return jlayer, tlayer


def _perturbed(jlayer, rng):
    """Give every parameter of the JAX layer random values (the defaults
    leave biases zero and scales one)."""
    for _, p in jlayer.named_parameters():
        p.set_value((np.asarray(p.numpy()) + rng.standard_normal(
            p.shape).astype(np.float32) * 0.1).astype(np.float32))
    return jlayer


LAYERS = {
    "mha": (lambda m: m.FusedMultiHeadAttention(32, 4, normalize_before=True),
            lambda rng: ((rng.standard_normal((2, 5, 32)),), {})),
    "ffn": (lambda m: m.FusedFeedForward(32, 48, activation="gelu"),
            lambda rng: ((rng.standard_normal((2, 5, 32)),), {})),
    "encoder": (lambda m: m.FusedTransformerEncoderLayer(32, 4, 48),
                lambda rng: ((rng.standard_normal((2, 5, 32)),), {})),
    "bias_dropout_residual_ln": (
        lambda m: m.FusedBiasDropoutResidualLayerNorm(32),
        lambda rng: ((rng.standard_normal((2, 5, 32)),
                      rng.standard_normal((2, 5, 32))), {})),
    "linear": (lambda m: m.FusedLinear(32, 24),
               lambda rng: ((rng.standard_normal((2, 5, 32)),), {})),
    "dropout_add": (lambda m: m.FusedDropoutAdd(0.3),
                    lambda rng: ((rng.standard_normal((2, 5, 32)),
                                  rng.standard_normal((2, 5, 32))), {})),
    "multi_transformer": (
        lambda m: m.FusedMultiTransformer(
            32, 4, 24, num_layers=2, activation="swiglu",
            norm_type="rmsnorm", gqa_group_size=2),
        lambda rng: ((rng.standard_normal((2, 5, 32)),), {})),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_with_carried_weights(name):
    make, inputs = LAYERS[name]
    rng = np.random.default_rng(22)
    paddle.seed(5)
    jl = _perturbed(make(JN), rng)
    kwargs = {"device": "cpu"} if name != "dropout_add" else {}
    tl = make(_Kw(TN, **kwargs))
    jl, tl = _carry(jl, tl)
    assert [n for n, _ in jl.named_parameters()] == \
        [n for n, _ in tl.named_parameters()]
    args, _ = inputs(rng)
    args = [a.astype(np.float32) for a in args]
    jo = jl(*[_j(a) for a in args])
    to = tl(*[_t(a) for a in args])
    _close(_np(to), _np(jo))


class _Kw:
    """The port's layer module with constructor keywords bound (device)."""

    def __init__(self, mod, **kw):
        self._mod, self._kw = mod, kw

    def __getattr__(self, name):
        cls = getattr(self._mod, name)
        return lambda *a, **k: cls(*a, **{**self._kw, **k})


def test_multi_transformer_layer_equals_functional_with_caches():
    rng = np.random.default_rng(23)
    tl = TN.FusedMultiTransformer(32, 4, 24, num_layers=2, device="cpu")
    tl.eval()
    x = _t(rng.standard_normal((2, 5, 32)).astype(np.float32))
    caches = [torch.zeros((2, 2, 4, 8, 8)) for _ in range(2)]
    caches2 = [c.clone() for c in caches]
    a = tl(x, caches=caches)
    names = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
             "linear_weights", "linear_biases", "ffn_ln_scales",
             "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
             "ffn2_biases")
    b = TF.fused_multi_transformer(x, *(getattr(tl, n) for n in names),
                                   cache_kvs=caches2)
    assert torch.equal(a, b)
    assert all(torch.equal(c, d) for c, d in zip(caches, caches2))


def test_training_gradients_match_jax():
    rng = np.random.default_rng(24)
    B, S, E, H, G, D, F, L = 2, 4, 32, 4, 2, 8, 24, 1
    w = _weights(rng, L, E, H, D, F, G=G, glu=True)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    gy = rng.standard_normal((B, S, E)).astype(np.float32)
    kw = dict(norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
              training=True)

    def leaf_j(a):
        t = _j(a)
        t.stop_gradient = False
        return t

    def leaf_t(a):
        return _t(a).clone().requires_grad_(True)
    jx = leaf_j(x)
    jw = {k: [leaf_j(a) for a in v] for k, v in w.items()}
    tx = leaf_t(x)
    tw = {k: [leaf_t(a) for a in v] for k, v in w.items()}
    (JF.fused_multi_transformer(jx, **jw, **kw) * _j(gy)).sum().backward()
    (TF.fused_multi_transformer(tx, **tw, **kw) * _t(gy)).sum().backward()
    def grad(t):      # an operand the math never reads (a bias of an
        g = t.grad    # RMSNorm) has no gradient in the port, zeros in JAX
        return np.zeros(t.shape, np.float32) if g is None else _np(g)
    _close(grad(tx), grad(jx), atol=1e-4)
    for k in w:
        for a, b in zip(tw[k], jw[k]):
            _close(grad(a), grad(b), atol=1e-4)


REFUSALS = {
    "pre_caches_with_time_step": (
        dict(pre_caches=[np.zeros((2, 1, 2, 2, 8), np.float32)],
             time_step=2), "pre_caches apply to the context"),
    "attn_mask_paged": (
        dict(attn_mask=np.zeros((1, 2, 1, 4), np.float32),
             block_tables=np.zeros((1, 1), np.int32),
             seq_lens=np.zeros(1, np.int32), time_step=0,
             cache_kvs=[np.zeros((2, 2, 2, 4, 8), np.float32)]),
        "attn_mask unsupported on the paged"),
    "beam_offset": (dict(beam_offset=np.zeros(1, np.int32)),
                    "beam_offset unsupported"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_parity(case):
    kw, msg = REFUSALS[case]
    rng = np.random.default_rng(25)
    w = _weights(rng, 1, 16, 2, 8, 32)
    x = np.zeros((1, 1, 16), np.float32)

    def conv(v, f):
        return [f(a) for a in v] if isinstance(v, list) else \
            f(v) if isinstance(v, np.ndarray) else v
    with pytest.raises(NotImplementedError, match=msg):
        JF.fused_multi_transformer(
            _j(x), **{k: [_j(a) for a in v] for k, v in w.items()},
            **{k: conv(v, _j) for k, v in kw.items()})
    with pytest.raises(NotImplementedError, match=msg):
        TF.fused_multi_transformer(
            _t(x), **{k: [_t(a) for a in v] for k, v in w.items()},
            **{k: conv(v, _t) if k not in ("block_tables", "seq_lens")
               else v for k, v in kw.items()})
