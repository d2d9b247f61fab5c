"""The PyTorch port's other model families held against the JAX package
on the CPU, at the tiny configs the JAX tests use: ``GPTForCausalLM``
(also three steps of ``pretrain.make_train_step``), ``vit_tiny``,
ERNIE's three heads (``ErnieModel``, ``ErnieForSequenceClassification``,
``ErnieForMaskedLM``) and ``UNet2DConditionModel``.

Each family's JAX model is built with a seed, its parameters taken by
``jit.functional.state_arrays`` and carried into the port's model by
``models.state_from_numpy``; the port's names and shapes must equal the
JAX ones key for key. Both run in float32 on the same seeded inputs, in
eval (ERNIE's dropout 0.1 is off there). The JAX gradient is
``jax.grad`` over ``jit.functional.pure_call``. The JAX attention runs
``_sdpa_ref`` (the flash path needs a TPU); the port's flash kernels run
their plain versions on CPU tensors.

Tolerances: outputs within 1e-5 and the loss and every parameter's
gradient within 2e-5, as ``tests/test_torch_llama.py`` holds Llama (the
two frameworks sum in another order), each times the reference's
largest magnitude where that is above 1 (ERNIE's tied decoder gives
logits of ~10). The UNet's convolution stack sums 3 x 3 x C products a
layer through ~20 layers: its outputs and gradients within 1e-4 on the
same scale. The GPT steps' loss and grad norm within 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as J  # noqa: E402
from paddle_tpu.jit.functional import pure_call, state_arrays  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import models as T  # noqa: E402
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

ATOL = 1e-5
GRAD_ATOL = 2e-5
UNET_TOL = 1e-4


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol, msg=""):
    """|got - want| <= atol * max(1, max |want|) elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _carry(jm, build, *args, **kwargs):
    """The JAX model's (params, buffers) and the port's model holding its
    weights, both in eval; names and shapes checked key for key."""
    jm.eval()
    params, buffers = state_arrays(jm)
    np_params = {n: np.asarray(a) for n, a in params.items()}
    tm = T.state_from_numpy(np_params, build, *args, device="cpu", **kwargs)
    tm.eval()
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: a.shape for n, a in np_params.items()}
    back = T.state_to_numpy(tm)
    assert all(np.array_equal(back[n], np_params[n]) for n in np_params)
    return params, buffers, tm


def _check(jm, tm, params, buffers, jloss, tloss, jargs, targs, atol=ATOL,
           grad_atol=GRAD_ATOL):
    """``jloss(out)`` / ``tloss(out)`` -> (loss, output to compare) of the
    model's output on ``jargs`` / ``targs``; checks the output, the loss
    and every parameter's gradient."""
    def loss_fn(p):
        return jloss(pure_call(jm, p, buffers, *jargs))

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tl, tout = tloss(tm(*targs))
    tl.backward()
    _close(tout, jout, atol, "output")
    _close(tl, jl, grad_atol, "loss")
    for n, p in tm.named_parameters():
        # a parameter off the loss's path (the MLM head's pooler) has no
        # gradient in torch and zeros in JAX
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, jgrads[n], grad_atol, n)


# -- GPT -----------------------------------------------------------------

def _gpt_pair(seed=0, **kw):
    paddle.seed(seed)
    jm = J.GPTForCausalLM(J.GPTConfig.tiny(dtype="float32", **kw))
    return (jm,) + _carry(jm, T.GPTForCausalLM,
                          T.GPTConfig.tiny(dtype="float32", **kw))


def _lm_batch(seed, b=2, s=16, v=128):
    rng = _rng(seed)
    ids = rng.integers(0, v, (b, s)).astype(np.int32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    return ids, labels


def test_gpt_logits_loss_and_grads_match():
    jm, params, buffers, tm = _gpt_pair()
    assert any(n.startswith("gpt.h.1.attn.qkv_proj") for n in params)
    assert not any(n.startswith("model.") for n in params)
    ids, labels = _lm_batch(1)
    _check(jm, tm, params, buffers,
           lambda out: (out[1], out[0]), lambda out: (out[1], out[0]),
           (jnp.asarray(ids), None, jnp.asarray(labels)),
           (_t(ids), None, _t(labels)))
    assert tm.model is tm.gpt


def test_gpt_bf16_config_computes_its_blocks_in_f32_as_jax():
    """``dtype="bfloat16"``: the embeddings' sum is cast to bf16, and the
    first projection's f32 bias promotes it back; both packages' logits
    come out f32 and agree."""
    paddle.seed(2)
    jm = J.GPTForCausalLM(J.GPTConfig.tiny())
    params, buffers, tm = _carry(jm, T.GPTForCausalLM, T.GPTConfig.tiny())
    ids, _ = _lm_batch(2)
    want = pure_call(jm, params, buffers, jnp.asarray(ids))
    got = tm(_t(ids))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    _close(got, want, 2e-2)


def test_gpt_three_make_train_steps_match():
    """Three f32 steps of the port's ``make_train_step`` against three of
    the JAX step on a one-device mesh: loss and grad norm each step."""
    cfg_kw = dict(dtype="float32")
    paddle.seed(3)
    jm = J.GPTForCausalLM(J.GPTConfig.tiny(**cfg_kw))
    mesh = jpre.make_mesh(1, dp=1, fsdp=1, mp=1, sp=1)
    jparams, jopt, jmeta = jpre.make_train_state(jm, mesh)
    jstep = jpre.make_train_step(jm, mesh, jmeta)
    np_params = {n: np.asarray(a) for n, a in jparams.items()}
    tm = T.state_from_numpy(np_params, T.GPTForCausalLM,
                            T.GPTConfig.tiny(**cfg_kw), device="cpu")
    tparams, topt, tmeta = tpre.make_train_state(tm, None)
    tstep = tpre.make_train_step(tm, None, tmeta)
    for i in range(3):
        ids, labels = _lm_batch(10 + i, b=4, s=32)
        b = {"input_ids": ids, "labels": labels}
        jparams, jopt, jl, jg = jstep(jparams, jopt, jpre.shard_batch(b, mesh))
        tparams, topt, tl, tg = tstep(tparams, topt,
                                      tpre.batch_to_device(b, "cpu"))
        assert abs(float(tl) - float(jl)) <= GRAD_ATOL, (i, tl, jl)
        assert abs(float(tg) - float(jg)) <= GRAD_ATOL, (i, tg, jg)


# -- ViT -----------------------------------------------------------------

def test_vit_logits_loss_and_grads_match():
    paddle.seed(4)
    jm = J.vit_tiny()
    params, buffers, tm = _carry(jm, T.vit_tiny)
    assert {"cls_token", "pos_embed", "patch_embed.proj.weight",
            "encoder.layers.1.self_attn.q_proj.bias",
            "encoder.norm.weight", "head.weight"} <= set(params)
    rng = _rng(4)
    x = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 10, 3).astype(np.int64)
    _check(jm, tm, params, buffers,
           lambda out: (JF.cross_entropy(paddle.to_tensor(out),
                                         paddle.to_tensor(labels)).data,
                        out),
           lambda out: (TF.cross_entropy(out, _t(labels)), out),
           (jnp.asarray(x),), (_t(x),))


# -- ERNIE ---------------------------------------------------------------

def _ernie_batch(seed, b=2, s=12, v=128):
    rng = _rng(seed)
    ids = rng.integers(1, v, (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, types


@pytest.mark.parametrize("masked", [False, True])
def test_ernie_model_matches(masked):
    """Hidden states and pooled output, without a mask (the flash path)
    and with a 2-D padding mask (the plain path with the -1e4 mask)."""
    paddle.seed(5)
    cfg = dict()
    jm = J.ErnieModel(J.ErnieConfig.tiny(**cfg))
    params, buffers, tm = _carry(jm, T.ErnieModel, T.ErnieConfig.tiny(**cfg))
    ids, types = _ernie_batch(5)
    mask = np.ones(ids.shape, np.float32)
    mask[1, 7:] = 0
    jargs = (jnp.asarray(ids), jnp.asarray(types), None,
             jnp.asarray(mask) if masked else None)
    targs = (_t(ids), _t(types), None, _t(mask) if masked else None)
    _check(jm, tm, params, buffers,
           lambda out: (jnp.mean(out[0] ** 2) + jnp.mean(out[1]), out[1]),
           lambda out: ((out[0] ** 2).mean() + out[1].mean(), out[1]),
           jargs, targs)
    hj = pure_call(jm, params, buffers, *jargs)[0]
    _close(tm(*targs)[0], hj, ATOL)


def test_ernie_sequence_classification_matches():
    paddle.seed(6)
    jm = J.ErnieForSequenceClassification(J.ErnieConfig.tiny(),
                                          num_classes=3)
    params, buffers, tm = _carry(jm, T.ErnieForSequenceClassification,
                                 T.ErnieConfig.tiny(), num_classes=3)
    ids, types = _ernie_batch(6, b=4)
    labels = _rng(6).integers(0, 3, 4).astype(np.int64)
    _check(jm, tm, params, buffers,
           lambda out: (out[1], out[0]), lambda out: (out[1], out[0]),
           (jnp.asarray(ids), jnp.asarray(types), None, None,
            jnp.asarray(labels)),
           (_t(ids), _t(types), None, None, _t(labels)))


def test_ernie_masked_lm_matches():
    """The tied decoder plus its ``bias``; ignored labels (-100)."""
    paddle.seed(7)
    jm = J.ErnieForMaskedLM(J.ErnieConfig.tiny())
    params, buffers, tm = _carry(jm, T.ErnieForMaskedLM,
                                 T.ErnieConfig.tiny())
    assert "bias" in params
    ids, types = _ernie_batch(7)
    labels = _rng(7).integers(0, 128, ids.shape).astype(np.int64)
    labels[0, :5] = -100
    _check(jm, tm, params, buffers,
           lambda out: (out[1], out[0]), lambda out: (out[1], out[0]),
           (jnp.asarray(ids), jnp.asarray(types), jnp.asarray(labels)),
           (_t(ids), _t(types), _t(labels)))


def test_ernie_padding_mask_hides_the_padded_ids():
    """With a padding mask the pooled output (and the unpadded rows) do
    not depend on what the padded ids hold, in both packages."""
    paddle.seed(8)
    jm = J.ErnieModel(J.ErnieConfig.tiny())
    params, buffers, tm = _carry(jm, T.ErnieModel, T.ErnieConfig.tiny())
    rng = _rng(8)
    ids = rng.integers(1, 128, (2, 10)).astype(np.int32)
    other = ids.copy()
    other[:, 6:] = rng.integers(1, 128, (2, 4))
    mask = np.ones((2, 10), np.float32)
    mask[:, 6:] = 0
    outs = []
    for x in (ids, other):
        h, pooled = tm(_t(x), None, None, _t(mask))
        jh, jpooled = pure_call(jm, params, buffers, jnp.asarray(x), None,
                                None, jnp.asarray(mask))
        _close(pooled, jpooled, ATOL)
        _close(h[:, :6], jh[:, :6], ATOL)
        outs.append((h.detach(), pooled.detach()))
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=1e-6)
    torch.testing.assert_close(outs[0][0][:, :6], outs[1][0][:, :6], rtol=0,
                               atol=1e-6)


# -- UNet ----------------------------------------------------------------

def test_unet_denoising_loss_and_grads_match():
    """The JAX test's tiny UNet (32 base channels, context 64): the
    predicted noise, the denoising MSE and every gradient."""
    paddle.seed(9)
    kw = dict(in_channels=4, out_channels=4, base_channels=32,
              context_dim=64)
    jm = J.UNet2DConditionModel(**kw)
    params, buffers, tm = _carry(jm, T.UNet2DConditionModel, **kw)
    assert {"down_blocks.1.self_attn.q_proj.weight",
            "down_blocks.1.cross_attn.k_proj.weight", "mid1.conv1.weight",
            "up_blocks.4.conv.weight", "conv_out.bias"} <= set(params)
    rng = _rng(9)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 300], np.int32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    _check(jm, tm, params, buffers,
           lambda out: (jnp.mean((out - jnp.asarray(noise)) ** 2), out),
           lambda out: (((out - _t(noise)) ** 2).mean(), out),
           (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)),
           (_t(x), _t(t), _t(ctx)), atol=UNET_TOL, grad_atol=UNET_TOL)


def test_timestep_embedding_matches():
    from paddle_tpu.models.unet import timestep_embedding as jte
    from paddle_tpu_torch.models.unet import timestep_embedding as tte
    t = np.array([0, 1, 17, 999], np.int32)
    _close(tte(_t(t), 32), jte(paddle.to_tensor(t), 32).numpy(), 1e-6)
