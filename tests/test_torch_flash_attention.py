"""The PyTorch port's flash attention held against the JAX package on the
CPU: the plain forward (o, lse) and backward (dq, dk, dv) against the
Pallas kernels ``_flash_fwd`` / ``_flash_bwd`` in interpret mode, and the
port's autograd function against ``jax.vjp`` of the JAX
``flash_attention_bshd`` with grouped-query heads; each with and without
the rope operands (``rope_cos`` / ``rope_sin``). With rope, S is a
multiple of the Pallas tile: the reference reads a padded tail as NaN
(ROADMAP Queue 3, pinned below).

Tolerance: float32 throughout, atol 2e-5 (both sides sum a few dozen
f32 products in another order; the largest values are O(10)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import flash_attention as FA  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = FA._INTERPRET
    FA._INTERPRET = True
    yield
    FA._INTERPRET = old


def _inputs(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(4)]


def _tables(s, d, base=10000.0):
    """The model's [S, D/2] f32 neox tables."""
    inv = 1.0 / base ** (np.arange(0, d, 2, dtype=np.float32) / d)
    ang = np.outer(np.arange(s, dtype=np.float32), inv).astype(np.float32)
    return np.cos(ang), np.sin(ang)


def _jax_fwd_bwd(q, k, v, do, scale, causal, block, rope=None):
    rc, rs = (None, None) if rope is None else map(jnp.asarray, rope)
    o, lse = FA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, causal, block, block, rc, rs)
    dq, dk, dv = FA._flash_bwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), o, lse, jnp.asarray(do),
                               scale, causal, block, block, block, block,
                               rc, rs)
    return [np.asarray(x) for x in (o, lse[:, 0], dq, dk, dv)]


def _port_fwd_bwd(q, k, v, do, scale, causal, rope=None):
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    rc, rs = (None, None) if rope is None else map(torch.as_tensor, rope)
    o, lse = tfa.flash_fwd(tq, tk, tv, scale, causal, rc, rs)
    dq, dk, dv = tfa.flash_bwd(tq, tk, tv, o, lse, tdo, scale, causal, rc,
                               rs)
    return [x.numpy() for x in (o, lse, dq, dk, dv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,block", [(32, 16, 16), (32, 32, 16),
                                       (40, 16, 64), (40, 32, 64)])
def test_plain_fwd_bwd_match_the_pallas_kernels(s, d, block, causal):
    """S=32 runs the reference over 16-row tiles (2 x 2 of them, causal
    skips included); S=40 over one 40-row tile (``_pick_block`` clamps
    64 to S)."""
    q, k, v, do = _inputs(s + d, 3, s, d)
    scale = 1.0 / np.sqrt(d)
    want = _jax_fwd_bwd(q, k, v, do, scale, causal, block)
    got = _port_fwd_bwd(q, k, v, do, scale, causal)
    for name, w, g in zip(("o", "lse", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


def test_plain_backward_is_finite_where_a_masked_score_overflows():
    """A masked score far above its row's lse: exp(s - lse) overflows to
    inf there, and the plain backward selects it away as the kernels and
    the Pallas backward do (it once took inf * 0 = NaN). Row 0 sees only
    key 0 (score 0); its masked score against key 1 is ~565."""
    s, d = 32, 32
    q, k, v, do = _inputs(9, 3, s, d)
    q[:, 0, :] = 10.0
    k[:, 0, :] = 0.0
    k[:, 1, :] = 10.0
    scale = 1.0 / np.sqrt(d)
    want = _jax_fwd_bwd(q, k, v, do, scale, True, 16)
    got = _port_fwd_bwd(q, k, v, do, scale, True)
    for name, w, g in zip(("o", "lse", "dq", "dk", "dv"), want, got):
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,block", [(32, 16, 16), (32, 32, 16),
                                       (48, 16, 48), (64, 32, 32)])
def test_plain_fwd_bwd_with_rope_match_the_pallas_kernels(s, d, block,
                                                           causal):
    """The rope operands: q rotated once per q tile and k per k tile in
    the forward (k once and q per tile in the backward), dq and dk
    counter-rotated in f32. Tables longer than S are cut to S by both."""
    q, k, v, do = _inputs(s + d + 1, 3, s, d)
    rope = _tables(s, d, base=100.0)
    scale = 1.0 / np.sqrt(d)
    want = _jax_fwd_bwd(q, k, v, do, scale, causal, block, rope)
    got = _port_fwd_bwd(q, k, v, do, scale, causal, rope)
    for name, w, g in zip(("o", "lse", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    plain = _port_fwd_bwd(q, k, v, do, scale, causal)
    assert not np.allclose(plain[0], got[0], atol=1e-3)   # rope did rotate
    longer = [np.ascontiguousarray(np.concatenate(
        [r[:s], np.zeros((9, d // 2), np.float32)])) for r in rope]
    again = _port_fwd_bwd(q, k, v, do, scale, causal, longer)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(a, g)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_tail_tile_is_nan_where_the_port_is_exact(causal):
    """A fault of the reference, not of the port: with S not a multiple
    of the Pallas tile (S=40, 16-row tiles) the interpret-mode kernels
    read the padded tail of k/v/q as NaN and 0 * NaN poisons the tail
    rows (causal) or every row (full). The port masks the tail and
    agrees with the reference run over one whole tile."""
    q, k, v, do = _inputs(7, 2, 40, 16)
    scale = 0.25
    tiled = _jax_fwd_bwd(q, k, v, do, scale, causal, 16)
    whole = _jax_fwd_bwd(q, k, v, do, scale, causal, 64)
    got = _port_fwd_bwd(q, k, v, do, scale, causal)
    bad = np.isnan(tiled[0]).any(axis=(0, 2))
    assert bad[32:].all() and bad[:32].any() == (not causal)
    assert all(np.isfinite(x).all() for x in whole + got)
    np.testing.assert_allclose(got[0], whole[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_jax_vjp_with_gqa(causal):
    """[B, S, H, D] with H=4 query heads over KVH=2 kv heads: the port
    repeats kv heads before the kernel and autograd sums dk / dv over each
    group, as ``jnp.repeat``'s transpose does."""
    rng = np.random.default_rng(3)
    b, s, h, kvh, d = 2, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def f(q_, k_, v_):
        return FA.flash_attention_bshd(q_, k_, v_, causal=causal,
                                       block_q=16, block_k=16)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = tfa.flash_attention_bshd(tq, tk, tv, causal=causal)
    to.backward(torch.as_tensor(g))
    got = [to.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for name, w, x in zip(("o", "dq", "dk", "dv"), want, got):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x, w, rtol=0, atol=ATOL, err_msg=name)
    # the functional entry is the same path
    out, none = TF.flash_attention(tq, tk, tv, causal=causal)
    assert none is None
    np.testing.assert_allclose(out.detach().numpy(), got[0], rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_with_rope_matches_jax_vjp_with_gqa(causal):
    """Rope inside the kernels with H=4 query heads over KVH=2 kv heads:
    the tables apply per position to q and to the repeated k, and the
    tables get no gradient."""
    rng = np.random.default_rng(13)
    b, s, h, kvh, d = 2, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = _tables(s, d)

    def f(q_, k_, v_):
        return FA.flash_attention_bshd(q_, k_, v_, causal=causal,
                                       block_q=16, block_k=16,
                                       rope_cos=jnp.asarray(cos),
                                       rope_sin=jnp.asarray(sin))

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tc, ts = (torch.tensor(x, requires_grad=True) for x in (cos, sin))
    out, none = TF.flash_attention(tq, tk, tv, causal=causal, rope_cos=tc,
                                   rope_sin=ts)
    assert none is None
    out.backward(torch.as_tensor(g))
    got = [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for name, w, x in zip(("o", "dq", "dk", "dv"), want, got):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x, w, rtol=0, atol=ATOL, err_msg=name)
    assert tc.grad is None and ts.grad is None


def test_plain_versions_take_the_dtype_steps():
    """bf16 inputs: p is rounded to bf16 before p @ v, so the plain
    forward equals an f32 softmax over bf16-rounded probabilities, and
    the outputs come back in bf16 with lse in f32."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 24, 32))
                               .astype(np.float32)).bfloat16()
               for _ in range(3))
    o, lse = tfa.flash_fwd(q, k, v, 0.2, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = (q.float() @ k.float().transpose(1, 2)) * 0.2
    s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    assert torch.equal(o, ref.bfloat16())
    do = torch.ones_like(o)
    dq, dk, dv = tfa.flash_bwd(q, k, v, o, lse, do, 0.2, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_flash_attention_refuses_later_slice_options():
    """Dropout and return_softmax are taken now (the reference route, as
    the JAX package's: ``return_softmax`` gives (out, None) and dropout
    with ``training=False`` the dropout-free result, both equal to the
    kernel's here); the rope tables are taken and equal rotating q and k
    before the kernel."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 8, 2, 32))
                               .astype(np.float32)) for _ in range(3))
    plain, none = TF.flash_attention(q, k, v, causal=True)
    for kw in (dict(return_softmax=True), dict(dropout=0.1, training=False)):
        out, soft = TF.flash_attention(q, k, v, causal=True, **kw)
        assert soft is None and none is None
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0,
                                   atol=1e-6)
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 8, 2, 32))
                               .astype(np.float32)) for _ in range(3))
    cos, sin = (torch.as_tensor(t) for t in _tables(8, 32))
    fused, _ = TF.flash_attention(q, k, v, causal=True, rope_cos=cos,
                                  rope_sin=sin)
    rq = TF.apply_rotary_pos_emb(q, cos, sin)
    rk = TF.apply_rotary_pos_emb(k, cos, sin)
    ref, _ = TF.flash_attention(rq, rk, v, causal=True)
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_a_raising_kernel_is_not_swallowed(monkeypatch):
    """F.flash_attention has no fallback: a kernel that fails to build or
    launch surfaces to the caller (the JAX package's ``except Exception:
    pass`` at attention.py:99-100 is not copied)."""
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed with CUDA error 719")
    monkeypatch.setattr(tfa, "flash_fwd", broken)
    x = torch.zeros(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        TF.flash_attention(x, x, x, causal=True)


def test_wrappers_refuse_what_the_kernels_do_not_take_before_launching():
    """Shape checks run before the kernel is touched: a wrong layout or
    head dim raises ValueError even where no kernel could be built."""
    q = torch.zeros(2, 8, 48)
    with pytest.raises(ValueError):
        tfa._check("flash_fwd", q, q, q)
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError):
        tfa._check("flash_fwd", q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))
    with pytest.raises(ValueError):
        tfa._check("flash_fwd", q, q.bfloat16(), q.bfloat16())
    tfa._check("flash_fwd", q, q, q)
    shifted = torch.zeros(2 * 8 * 32 + 1)[1:].view(2, 8, 32)   # 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check("flash_fwd", shifted, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"), 1.0, True)
    tab = torch.zeros(8, 16)
    assert tfa._rope_ptrs("flash_fwd", q, q, None, None) == (None, None)
    for cos, sin in ((tab, None), (tab.double(), tab), (tab[:7], tab[:7]),
                     (torch.zeros(8, 8), torch.zeros(8, 8)),
                     (torch.zeros(16, 8).t(), tab)):
        with pytest.raises(ValueError, match="rope_cos"):
            tfa._rope_ptrs("flash_fwd", q, q, cos, sin)


# -- dropout and return_softmax (the reference route) ----------------------

def _uniform_case(s=64):
    """q = k = 0 gives every key the probability 1 / s, and v = I makes
    the output those probabilities: out[0, i, 0, j] = p(i, j) after the
    dropout."""
    z = torch.zeros(1, s, 1, s)
    v = torch.eye(s)[None, :, None, :].contiguous()
    return z, z.clone(), v


@pytest.mark.parametrize("p", [0.1, 0.25, 0.5])
def test_dropout_keeps_each_probability_with_one_minus_p_scaled_up(p):
    """Keep rate within 3 sigma of 1 - p over 4096 probabilities, and each
    kept one scaled by 1 / (1 - p), as the JAX package's
    ``jnp.where(keep, probs / (1 - p), 0)``."""
    from paddle_tpu_torch.core import random as trandom
    q, k, v = _uniform_case()
    trandom.seed(7)
    out, none = TF.flash_attention(q, k, v, dropout=p)
    assert none is None
    vals = out[0, :, 0, :].numpy()
    kept = vals != 0
    n = kept.size
    sigma = np.sqrt(n * p * (1 - p)) / n
    assert abs(kept.mean() - (1 - p)) <= 3 * sigma
    np.testing.assert_allclose(vals[kept], (1 / 64) / (1 - p), rtol=1e-6)


def test_dropout_zero_and_training_off_give_the_plain_result():
    """p = 0 and ``training=False`` take the flash route and equal the
    JAX package's reference attention exactly as the plain kernel does;
    with dropout the call takes the reference route instead."""
    import paddle_tpu.nn.functional.attention as JATT
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 16, 2, 32))
                               .astype(np.float32)) for _ in range(3))
    calls = []
    real = tfa.flash_attention_bshd

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    tfa.flash_attention_bshd = counting
    try:
        a, _ = TF.flash_attention(q, k, v, dropout=0.0, causal=True)
        b, _ = TF.flash_attention(q, k, v, dropout=0.3, causal=True,
                                  training=False)
        assert len(calls) == 2              # the kernel route, both times
        TF.flash_attention(q, k, v, dropout=0.3, causal=True)
        TF.flash_attention(q, k, v, causal=True, return_softmax=True)
        assert len(calls) == 2              # the reference route
    finally:
        tfa.flash_attention_bshd = real
    ref = np.asarray(JATT._sdpa_ref(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), causal=True))
    for out in (a, b):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_the_same_seed_gives_the_same_mask_and_the_chain_moves_on():
    """``core.random.seed`` resets the default chain: the same seed draws
    the same masks in the same order, consecutive calls draw new ones, and
    the gradient runs through the kept probabilities only."""
    from paddle_tpu_torch.core import random as trandom
    q, k, v = _uniform_case()
    trandom.seed(3)
    first = TF.flash_attention(q, k, v, dropout=0.4)[0]
    second = TF.flash_attention(q, k, v, dropout=0.4)[0]
    trandom.seed(3)
    again = TF.flash_attention(q, k, v, dropout=0.4)[0]
    assert torch.equal(first, again) and not torch.equal(first, second)
    vg = v.clone().requires_grad_(True)
    trandom.seed(3)
    out = TF.flash_attention(q, k, vg, dropout=0.4)[0]
    out.sum().backward()
    # d(sum out) / d v[j, d] = sum_i p(i, j) for every d: the kept
    # column sums
    cols = first[0, :, 0, :].sum(0)
    grad = vg.grad[0, :, 0, :]
    assert torch.equal(grad, grad[:, :1].expand_as(grad))
    np.testing.assert_allclose(grad[:, 0].numpy(), cols.numpy(), rtol=1e-6)


def test_sdpa_and_flashmask_take_dropout():
    """The masked routes drop too: scaled_dot_product_attention with a
    mask and flashmask_attention with an index."""
    from paddle_tpu_torch.core import random as trandom
    q, k, v = _uniform_case(32)
    mask = torch.ones(32, 32, dtype=torch.bool)
    trandom.seed(5)
    out = TF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          dropout_p=0.5)
    frac = float((out[0, :, 0, :] != 0).float().mean())
    assert 0.35 < frac < 0.65
    assert torch.equal(TF.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, dropout_p=0.5, training=False),
        TF.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    idx = torch.full((1, 1, 32, 1), 32, dtype=torch.int32)
    out = TF.flashmask_attention(q, k, v, idx, dropout=0.5, causal=False)
    frac = float((out[0, :, 0, :] != 0).float().mean())
    assert 0.35 < frac < 0.65
