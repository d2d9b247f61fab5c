"""Activation recompute in the PyTorch port (``distributed.fleet.recompute``
and ``LlamaConfig.recompute``) held against the JAX package on the CPU:
the tiny Llama's loss and every gradient with each policy against the JAX
model with the same policy (its layers under ``jax.checkpoint``), a
recomputed function and ``recompute_sequential`` against ``jax.grad``,
dropout replayed in the recompute, and the 5-step training trajectory
with ``recompute`` in {True, "dots_saveable", "nothing"}: bit-equal to
the port without recompute, and within the trajectory test's rtol 1e-5 of
the JAX step with the same ``recompute``.

Tolerances: the model's loss and gradients atol 2e-5 (as
tests/test_torch_llama.py: O(1) values, 64-wide dots summed in another
order); functions 1e-6 (a few f32 products).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.jit.functional import pure_call, state_arrays  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import pretrain as jpre  # noqa: E402
from paddle_tpu_torch.core import random as trandom  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    recompute, recompute_hybrid, recompute_sequential)
from paddle_tpu_torch.models import (LlamaConfig,  # noqa: E402
                                     llama_state_from_numpy)
from paddle_tpu_torch.models import pretrain as tpre  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# the module (the package's ``recompute`` attribute is the function)
rcmod = importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")

ATOL = 2e-5
POLICIES = [True, "dots_saveable", "dots", "dots_with_no_batch_dims",
            "nothing", "everything"]


def _batch(seed, b=2, s=16, v=128):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, (b, s)).astype(np.int32),
            rng.integers(0, v, (b, s)).astype(np.int32))


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the flash forward's calls (its plain version here)."""
    calls = []
    real = tfa.flash_fwd

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_fwd", counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_model_loss_and_grads_with_recompute_match_jax(policy, flash_calls):
    """The tiny Llama trained with ``recompute=policy``: loss and every
    gradient against the JAX model with the same policy; the flash
    forward runs twice a layer (once for "everything")."""
    paddle.seed(11)
    jm = JLlama(JConfig.tiny(dtype="float32", recompute=policy))
    jm.train()
    params, buffers = state_arrays(jm)
    ids, labels = _batch(4)

    def loss_fn(p):
        return pure_call(jm, p, buffers, jnp.asarray(ids),
                         labels=jnp.asarray(labels))[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    cfg = LlamaConfig.tiny(dtype="float32", recompute=policy)
    tm = llama_state_from_numpy({n: np.asarray(a) for n, a in params.items()},
                                cfg, device="cpu")
    tm.train()
    _, loss = tm(torch.as_tensor(ids), labels=torch.as_tensor(labels))
    loss.backward()
    layers = cfg.num_hidden_layers
    assert len(flash_calls) == (layers if policy == "everything"
                                else 2 * layers)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   rtol=0, atol=ATOL, err_msg=n)


def test_eval_and_no_grad_skip_the_checkpoint(flash_calls):
    """Recompute engages only while the model trains with autograd on:
    an eval forward and a no_grad forward run each layer once."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    cfg = LlamaConfig.tiny(dtype="float32", recompute=True)
    tm = LlamaForCausalLM(cfg, device="cpu", seed=2)
    ids = torch.as_tensor(_batch(1)[0])
    tm.eval()
    tm(ids, labels=ids)[1].backward()
    tm.train()
    with torch.no_grad():
        tm(ids)
    assert len(flash_calls) == 2 * cfg.num_hidden_layers


def _mlp_np(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((5, 8)).astype(np.float32),
            rng.standard_normal((8, 16)).astype(np.float32) * 0.3,
            rng.standard_normal((16, 8)).astype(np.float32) * 0.3)


@pytest.mark.parametrize("policy", [None, "dots_saveable", "nothing"])
def test_recompute_of_a_function_matches_jax_grad(policy):
    x, w1, w2 = _mlp_np(1)

    def jf(a, b, c):
        return jnp.sum(jnp.tanh(jax.nn.silu(a @ b) @ c) ** 2)

    want = jax.grad(jax.checkpoint(jf), argnums=(0, 1, 2))(x, w1, w2)

    def tf(a, b, c):
        return torch.sum(torch.tanh(torch.nn.functional.silu(a @ b) @ c) ** 2)

    ts = [torch.tensor(t, requires_grad=True) for t in (x, w1, w2)]
    recompute(tf, *ts, policy=policy).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


class _Lin(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(w))

    def forward(self, x):
        return torch.tanh(TF.linear(x, self.weight))


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_matches_jax_grad(segments):
    """Three layers in ``segments`` checkpointed runs: input and weight
    gradients against ``jax.grad`` of the same chain."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    ws = [rng.standard_normal((8, 8)).astype(np.float32) * 0.4
          for _ in range(3)]

    def jf(a, *w):
        for m in w:
            a = jnp.tanh(a @ m)
        return jnp.sum(a * a)

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(x, *ws)
    seq = torch.nn.Sequential(*[_Lin(w) for w in ws])
    xt = torch.tensor(x, requires_grad=True)
    out = recompute_sequential({"segments": segments}, seq, xt)
    (out * out).sum().backward()
    got = [xt.grad] + [m.weight.grad for m in seq]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_recompute_hybrid_offload_falls_back_to_full_recompute():
    x, w1, w2 = _mlp_np(3)
    grads = []
    for ctx in (None, {"offload": True}, {"partition": True}):
        ts = [torch.tensor(t, requires_grad=True) for t in (x, w1, w2)]
        out = recompute_hybrid(ctx, lambda a, b, c: (a @ b @ c).sum(), *ts)
        out.backward()
        grads.append([t.grad for t in ts])
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], g))
    with pytest.raises(ValueError, match="unknown policy"):
        recompute(lambda a: a, ts[0], policy="some_other")
    keep = rcmod.policy_fn("dots_saveable")
    assert keep(None, torch.ops.aten.mm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert keep(None, torch.ops.aten.add.Tensor) == \
        torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    nb = rcmod.policy_fn("dots_with_no_batch_dims")
    assert nb(None, torch.ops.aten.bmm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def test_dropout_is_replayed_in_the_recompute():
    """Attention dropout inside a recomputed region: the recompute draws
    the forward's mask again (the default seed chain is replayed), so the
    gradients equal those of the run without recompute, and the chain
    after the region is where the run without recompute leaves it."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 32, 2, 32)).astype(np.float32)
               for _ in range(3))

    def region(a, b, c):
        out, _ = TF.flash_attention(a, b, c, dropout=0.3, causal=True)
        out2, _ = TF.flash_attention(out, b, c, dropout=0.3, causal=True)
        return (out2 ** 2).sum()

    runs = []
    for rc in (False, True):
        trandom.seed(9)
        ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
        loss = recompute(region, *ts) if rc else region(*ts)
        after_forward = trandom.fresh_seed("cpu")
        loss.backward()
        runs.append(([t.grad for t in ts], float(loss.detach()),
                     after_forward, trandom.fresh_seed("cpu")))
    (g0, l0, a0, b0), (g1, l1, a1, b1) = runs
    assert l0 == l1 and (a0, b0) == (a1, b1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


def _trajectory(cfg, steps=5, jax_recompute=None, seed=21):
    batch, seq = 4, 64
    paddle.seed(seed)
    jcfg = JConfig(**{k: v for k, v in vars(cfg).items()})
    jcfg.recompute = jax_recompute if jax_recompute is not None else False
    jm = JLlama(jcfg)
    mesh = jpre.make_mesh(1, dp=1, fsdp=1, mp=1, sp=1)
    jparams, jopt, jmeta = jpre.make_train_state(jm, mesh)
    np_params = {n: np.asarray(a) for n, a in jparams.items()}
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32)} for _ in range(steps)]
    want = []
    if jax_recompute is not None:
        jstep = jpre.make_train_step(jm, mesh, jmeta)
        for b in batches:
            jparams, jopt, jl, jg = jstep(jparams, jopt,
                                          jpre.shard_batch(b, mesh))
            want.append((float(jl), float(jg)))
    tm = llama_state_from_numpy(np_params, cfg, device="cpu")
    tparams, topt, tmeta = tpre.make_train_state(tm)
    tstep = tpre.make_train_step(tm, None, tmeta)
    got = []
    for b in batches:
        tparams, topt, tl, tg = tstep(tparams, topt,
                                      tpre.batch_to_device(b, "cpu"))
        got.append((float(tl), float(tg)))
    return np.array(got), np.array(want), tparams


@pytest.mark.parametrize("policy", [True, "dots_saveable", "nothing"])
def test_five_step_trajectory_with_recompute(policy):
    """Bit-equal to the port without recompute (the recomputed forward
    repeats the same ops), and within rtol 1e-5 of the JAX step with the
    same ``recompute``."""
    cfg, _, _ = tpre.flagship_config(on_tpu=False)
    plain, _, p0 = _trajectory(cfg)
    cfg.recompute = policy
    got, want, p1 = _trajectory(cfg, jax_recompute=policy)
    assert np.array_equal(got, plain)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
