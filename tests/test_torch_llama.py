"""The PyTorch port's Llama forward held against the JAX package on the
CPU: rope (neox and GPT-J, position ids, tables passed in), the
``rms_norm`` dtype rule, ``cross_entropy`` with ignored rows, and the
tiny ``LlamaForCausalLM`` — logits, loss and every parameter's gradient
— with the JAX model's weights loaded through ``llama_state_from_numpy``,
also with the two kernel options on (``fuse_rope_in_attention``: rope
inside the flash kernels; ``fused_lm_loss``: the blockwise LM-head loss),
the JAX model then running its Pallas kernels in interpret mode.

Tolerances: float32 elementwise ops agree to 1e-6; the model's logits
and loss to 2e-5 and its gradients to 2e-5 (atol; values are O(1) and
the two frameworks sum the 64-wide dots in another order). bf16 results
are compared to one bf16 unit in the last place.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional.attention as JATT  # noqa: E402
import paddle_tpu.ops.pallas.blockwise_ce as BC  # noqa: E402
import paddle_tpu.ops.pallas.flash_attention as FA  # noqa: E402
from paddle_tpu.jit.functional import pure_call, state_arrays  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,  # noqa: E402
                                     llama_state_from_numpy,
                                     llama_state_to_numpy)
from paddle_tpu_torch.models import llama as tllama  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import blockwise_ce as tbc  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 2e-5


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -- functionals ---------------------------------------------------------

@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("with_pos", [False, True])
def test_rope_matches(neox, with_pos):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 1, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 8)).astype(np.int64) if with_pos else None
    want = JF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k),
        position_ids=None if pos is None else jnp.asarray(pos),
        use_neox_rotary_style=neox, rotary_emb_base=500.0)
    got = TF.fused_rotary_position_embedding(
        _t(q), _t(k), position_ids=None if pos is None else _t(pos),
        use_neox_rotary_style=neox, rotary_emb_base=500.0)
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-6)
    assert got[2] is None


@pytest.mark.parametrize("neox", [True, False])
def test_rope_tables_passed_in(neox):
    """paddle's [1, S_max, 1, D] tables, reduced by the pair layout and
    gathered by position ids; bf16 activations rotate in bf16."""
    rng = np.random.default_rng(1)
    s_max, d = 12, 8
    ang = rng.standard_normal((1, s_max, 1, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    q = rng.standard_normal((2, 6, 2, d)).astype(np.float32)
    pos = rng.integers(0, s_max, (2, 6)).astype(np.int64)
    for p in (None, pos):
        want = JF.fused_rotary_position_embedding(
            paddle.to_tensor(q), sin=paddle.to_tensor(sin),
            cos=paddle.to_tensor(cos),
            position_ids=None if p is None else jnp.asarray(p),
            use_neox_rotary_style=neox)
        got = TF.fused_rotary_position_embedding(
            _t(q), sin=_t(sin), cos=_t(cos),
            position_ids=None if p is None else _t(p),
            use_neox_rotary_style=neox)
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=0,
                                   atol=1e-6)
    got = TF.fused_rotary_position_embedding(_t(q).bfloat16(),
                                             use_neox_rotary_style=neox)[0]
    assert got.dtype == torch.bfloat16


def test_rms_norm_keeps_the_activation_dtype():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    want = JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w), 1e-5)
    got = TF.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    # an f32 scale never promotes a bf16 activation
    xb = _t(x).bfloat16()
    got = TF.rms_norm(xb, _t(w), 1e-5)
    assert got.dtype == torch.bfloat16
    want = JF.rms_norm(paddle.to_tensor(x).astype("bfloat16"),
                       paddle.to_tensor(w), 1e-5)
    wb = _np(want.astype("float32"))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(wb), 2.0 ** -100))) - 7)
    assert (np.abs(got.float().numpy() - wb) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_with_ignored_rows(dtype):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((10, 17))).astype(np.float32)
    labels = rng.integers(0, 17, 10).astype(np.int64)
    labels[[1, 4, 7]] = -100
    jl = paddle.to_tensor(logits).astype(dtype)
    want = float(_np(JF.cross_entropy(jl, paddle.to_tensor(labels))))
    tl = _t(logits).to(getattr(torch, dtype)).requires_grad_(True)
    got = TF.cross_entropy(tl, _t(labels))
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - want) <= (1e-6 if dtype == "float32"
                                               else 1e-5)
    got.backward()
    assert (tl.grad[[1, 4, 7]] == 0).all()
    # every row ignored: the mean's denominator is clamped to one
    assert float(TF.cross_entropy(tl, torch.full((10,), -100)).detach()) == 0.0
    # the other modes are ported: they match the JAX function
    soft = rng.dirichlet(np.ones(17), 10).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-4
    for lab, kw in ((labels, dict(label_smoothing=0.1)),
                    (labels, dict(reduction="sum")),
                    (soft, dict(soft_label=True))):
        want = _np(JF.cross_entropy(jl, paddle.to_tensor(lab), **kw))
        got = TF.cross_entropy(tl, _t(lab), **kw).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_with_a_mask_matches(kind):
    """Masked attention goes through the plain ``_sdpa_ref`` on both
    sides: GQA (4 query heads over 2 kv heads), causal on top of a bool
    or an additive [B, 1, S, S] mask."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    if kind == "bool":
        mask = rng.random((2, 1, 10, 10)) > 0.3
        mask[..., 0] = True
    else:
        mask = (-5.0 * rng.random((2, 1, 10, 10))).astype(np.float32)
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), is_causal=True)
    got = TF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          attn_mask=_t(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)


# -- the model -----------------------------------------------------------

CONFIGS = {
    "unfused_gqa": dict(),
    "fused_gqa_tied": dict(fuse_attention_qkv=True, fuse_attention_ffn=True,
                           tie_word_embeddings=True),
    "fused_mha": dict(fuse_attention_qkv=True, fuse_attention_ffn=True,
                      num_key_value_heads=4),
}


def _jax_model(kw):
    paddle.seed(11)
    m = JLlama(JConfig.tiny(dtype="float32", **kw))
    m.eval()
    return m


def _batch(seed, b=2, s=16, v=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (b, s)).astype(np.int32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_logits_loss_and_grads_match(name):
    kw = CONFIGS[name]
    jm = _jax_model(kw)
    params, buffers = state_arrays(jm)
    ids, labels = _batch(4)

    def loss_fn(p):
        logits, loss = pure_call(jm, p, buffers, jnp.asarray(ids),
                                 labels=jnp.asarray(labels))
        return loss, logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    np_params = {n: np.asarray(a) for n, a in params.items()}
    tm = llama_state_from_numpy(np_params, LlamaConfig.tiny(dtype="float32",
                                                            **kw),
                                device="cpu")
    assert sorted(dict(tm.named_parameters())) == sorted(np_params)
    assert sorted(tm.state_dict()) == sorted(np_params)
    logits, loss = tm(_t(ids), labels=_t(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   rtol=0, atol=ATOL, err_msg=n)
    back = llama_state_to_numpy(tm)
    assert all(np.array_equal(back[n], np_params[n]) for n in np_params)


KERNEL_OPTIONS = dict(fuse_rope_in_attention=True, fused_lm_loss=True)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX model on its kernel path: flash attention and the
    blockwise loss as Pallas kernels in interpret mode."""
    monkeypatch.setattr(FA, "_INTERPRET", True)
    monkeypatch.setattr(BC, "_INTERPRET", True)
    monkeypatch.setattr(JATT, "_flash_available", lambda: True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_options_loss_and_grads_match(name, jax_kernels,
                                             monkeypatch):
    """Both options on: the port's forward returns (None, loss), hands the
    [S, D/2] tables to every flash call and computes the loss blockwise;
    loss and every gradient agree with the JAX model on its kernel path."""
    kw = dict(CONFIGS[name], **KERNEL_OPTIONS)
    jm = _jax_model(kw)
    params, buffers = state_arrays(jm)
    ids, labels = _batch(14)

    def loss_fn(p):
        logits, loss = pure_call(jm, p, buffers, jnp.asarray(ids),
                                 labels=jnp.asarray(labels))
        assert logits is None
        return loss

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="float32", **kw),
                                device="cpu")
    seen = []
    inner = tfa.flash_fwd

    def spy(*a):
        seen.append(a[5] is not None and a[6] is not None)
        return inner(*a)

    monkeypatch.setattr(tfa, "flash_fwd", spy)
    ce0 = tbc.ce_fwd.launches
    out, loss = tm(_t(ids), labels=_t(labels))
    assert out is None and loss.dtype == torch.float32
    assert seen == [True] * tm.config.num_hidden_layers
    assert tbc.ce_fwd.launches == ce0            # the CPU runs no kernel
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   rtol=0, atol=ATOL, err_msg=n)


def test_kernel_options_agree_with_the_default_path():
    """The options change where the work happens, not the result: loss
    and gradients within 2e-5 of the same model with both off."""
    cfg = LlamaConfig.tiny(dtype="float32", tie_word_embeddings=True)
    base = LlamaForCausalLM(cfg, device="cpu", seed=5)
    state = llama_state_to_numpy(base)
    fused = llama_state_from_numpy(
        state, LlamaConfig.tiny(dtype="float32", tie_word_embeddings=True,
                                **KERNEL_OPTIONS), device="cpu")
    ids, labels = _batch(15)
    _, l0 = base(_t(ids), labels=_t(labels))
    _, l1 = fused(_t(ids), labels=_t(labels))
    l0.backward()
    l1.backward()
    assert abs(float(l0.detach()) - float(l1.detach())) <= ATOL
    grads = dict(fused.named_parameters())
    for n, p in base.named_parameters():
        np.testing.assert_allclose(grads[n].grad.numpy(), p.grad.numpy(),
                                   rtol=0, atol=ATOL, err_msg=n)


def test_kernel_options_fall_back_with_a_mask_or_position_ids(jax_kernels,
                                                              monkeypatch):
    """A mask or position ids send rope back to
    ``fused_rotary_position_embedding`` before attention (no tables reach
    the flash kernels), as the JAX model does; with a mask the logits match
    the JAX model's, and position ids 0..S-1 give the tables' result."""
    kw = dict(CONFIGS["unfused_gqa"], fuse_rope_in_attention=True)
    jm = _jax_model(kw)
    params, buffers = state_arrays(jm)
    ids, _ = _batch(16, s=12)
    rng = np.random.default_rng(17)
    mask = rng.random((2, 1, 12, 12)) > 0.3
    mask[..., 0] = True
    want = pure_call(jm, params, buffers, jnp.asarray(ids), None,
                     jnp.asarray(mask))
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="float32", **kw),
                                device="cpu")
    tables = []
    inner = tfa.flash_fwd

    def spy(*a):
        tables.append(a[5] is not None)
        return inner(*a)

    monkeypatch.setattr(tfa, "flash_fwd", spy)
    pos = torch.arange(12).repeat(2, 1)
    with torch.no_grad():
        masked = tm(_t(ids), None, _t(mask))
        assert tables == []                      # _sdpa_ref, rotated first
        with_pos = tm(_t(ids), pos)
        assert tables == [False, False]
        fused = tm(_t(ids))
        assert tables == [False, False, True, True]
    np.testing.assert_allclose(masked.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(with_pos.numpy(), fused.numpy(), rtol=0,
                               atol=1e-5)


def test_attention_mask_and_position_ids_match():
    """A boolean mask sends attention through the plain ``_sdpa_ref`` on
    both sides; explicit position ids 0..S-1 equal the default ones."""
    kw = CONFIGS["unfused_gqa"]
    jm = _jax_model(kw)
    params, buffers = state_arrays(jm)
    ids, _ = _batch(5, s=12)
    rng = np.random.default_rng(6)
    mask = rng.random((2, 1, 12, 12)) > 0.3
    mask[..., 0] = True
    want = pure_call(jm, params, buffers, jnp.asarray(ids), None,
                     jnp.asarray(mask))
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="float32", **kw),
                                device="cpu")
    pos = torch.arange(12).repeat(2, 1)
    with torch.no_grad():
        got = tm(_t(ids), None, _t(mask))
        got_pos = tm(_t(ids), pos, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_pos.numpy(), got.numpy(), rtol=0,
                               atol=1e-6)


def test_reference_model_refuses_position_ids_the_port_takes():
    """A fault of the reference, not of the port: the JAX model hands
    ``position_ids`` to ``rotary_embedding_cos_sin`` as a framework
    Tensor (rope.py:29), and jnp.cos refuses it, so the JAX model cannot
    run with position ids at all. The port's model takes them; its
    rope with position ids matches the JAX functional (test_rope_matches)."""
    jm = _jax_model(CONFIGS["unfused_gqa"])
    params, buffers = state_arrays(jm)
    ids, _ = _batch(8, s=8)
    pos = np.tile(np.arange(3, 11, dtype=np.int32), (2, 1))
    with pytest.raises(TypeError):
        pure_call(jm, params, buffers, jnp.asarray(ids), jnp.asarray(pos))
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="float32"),
                                device="cpu")
    with torch.no_grad():
        shifted = tm(_t(ids), _t(pos))
        plain = tm(_t(ids))
    assert torch.isfinite(shifted).all()
    assert not torch.allclose(shifted, plain)


def test_bf16_forward_casts_like_the_jax_model():
    """dtype="bfloat16": the embedding output is cast to bf16 and the
    RMSNorm keeps it there; the f32 weights then promote the projections
    to f32 in both frameworks, so the logits come back f32 and agree."""
    kw = dict(fuse_attention_qkv=True, fuse_attention_ffn=True)
    paddle.seed(12)
    jm = JLlama(JConfig.tiny(dtype="bfloat16", **kw))
    params, buffers = state_arrays(jm)
    ids, _ = _batch(7)
    want = np.asarray(pure_call(jm, params, buffers, jnp.asarray(ids)))
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                LlamaConfig.tiny(dtype="bfloat16", **kw),
                                device="cpu")
    with torch.no_grad():
        got = tm(_t(ids))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # the bf16 rounding of the embedding rows and the first norm are the
    # same on both sides; what follows is f32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_state_loading_refuses_mismatched_keys():
    cfg = LlamaConfig.tiny(dtype="float32")
    tm = LlamaForCausalLM(cfg, device="cpu")
    good = llama_state_to_numpy(tm)
    bad = dict(good)
    bad.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        llama_state_from_numpy(bad, cfg, device="cpu")
    bad = dict(good, **{"llama.norm.weight": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="llama.norm.weight"):
        llama_state_from_numpy(bad, cfg, device="cpu")


def test_seeded_init_and_later_slice_options():
    cfg = LlamaConfig.tiny(dtype="float32")
    a = llama_state_to_numpy(LlamaForCausalLM(cfg, device="cpu", seed=3))
    b = llama_state_to_numpy(LlamaForCausalLM(cfg, device="cpu", seed=3))
    c = llama_state_to_numpy(LlamaForCausalLM(cfg, device="cpu", seed=4))
    assert all(np.array_equal(a[n], b[n]) for n in a)
    w = a["llama.layers.0.self_attn.q_proj.weight"]
    assert not np.array_equal(w, c["llama.layers.0.self_attn.q_proj.weight"])
    assert abs(float(w.std()) - 0.02) < 0.004
    assert (a["llama.norm.weight"] == 1.0).all()
    # context_parallel is taken now (tests/test_torch_context_parallel.py):
    # off a mesh with an sp axis it draws the same weights and computes
    # the same logits
    cp = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32",
                                           context_parallel=True),
                          device="cpu", seed=3)
    assert all(np.array_equal(a[n], v) for n, v in
               llama_state_to_numpy(cp).items())
    ids0 = torch.as_tensor(np.arange(32).reshape(2, 16) % 128)
    base = LlamaForCausalLM(cfg, device="cpu", seed=3)
    with torch.no_grad():
        assert torch.equal(cp(ids0), base(ids0))
    # the pipe form builds now (tests/test_torch_pipeline.py trains it):
    # off a pp axis every element, under the JAX PipelineLayer's names,
    # partitioned [embedding + block 1 | block 2 + norm and head]
    pipe = tllama.LlamaForCausalLMPipe(cfg, 2, device="cpu")
    assert pipe.segments == [[0, 1], [2, 3]]
    assert sorted(tllama.llama_pipe_state_to_numpy(
        pipe, names="causal_lm")) == sorted(a)
    # recompute is taken now (tests/test_torch_recompute.py holds it
    # against the JAX model): the same weights and the same loss
    rc = LlamaForCausalLM(LlamaConfig.tiny(dtype="float32", recompute=True),
                          device="cpu", seed=3)
    assert all(np.array_equal(a[n], v) for n, v in
               llama_state_to_numpy(rc).items())
    ids = torch.as_tensor(np.arange(32).reshape(2, 16) % 128)
    full = LlamaForCausalLM(cfg, device="cpu", seed=3)
    assert torch.equal(rc(ids, labels=ids)[1], full(ids, labels=ids)[1])
    assert cfg.head_dim == 16
    m = LlamaForCausalLM(cfg, device="cpu")
    assert m.model is m.llama
