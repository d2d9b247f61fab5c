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
    """Dropout and return_softmax still raise; the rope tables are taken
    now and equal rotating q and k before the kernel."""
    x = torch.zeros(1, 8, 2, 32)
    with pytest.raises(NotImplementedError, match="later slice"):
        TF.flash_attention(x, x, x, dropout=0.1)
    with pytest.raises(NotImplementedError, match="later slice"):
        TF.flash_attention(x, x, x, return_softmax=True)
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
