"""The PyTorch port's FlashMask attention and two-pass flash backward held
against the JAX package on the CPU: the plain forward (o, lse) and
backward (dq, dk, dv) against the Pallas kernels ``_fm_fwd`` /
``_fm_bwd`` in interpret mode over document, sliding-window, band,
random and dead-row masks; the autograd entry against ``jax.vjp`` of
the JAX ``flashmask_attention_bshd`` with grouped-query heads; the
``incubate`` entry against both JAX routes (the Pallas kernel and the
dense fallback); the two-pass backward against ``_flash_bwd_twopass``;
and the ``nn`` form against the JAX ``nn`` form, whose reading of a
2-column index differs (pinned below). S is a multiple of the 16-wide
Pallas tiles: the reference reads a padded tail as NaN (pinned below).

Tolerance: float32 throughout, atol 2e-5 (both sides sum a few dozen f32
products in another order; the largest values are O(10)).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate.nn import functional as JFI  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.ops.pallas import flash_attention as FA  # noqa: E402
from paddle_tpu.ops.pallas import flashmask as FM  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TFI  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops import flashmask as tfm  # noqa: E402

ATOL = 2e-5
BLOCK = 16


@pytest.fixture(autouse=True)
def _interpret():
    old = FA._INTERPRET
    FA._INTERPRET = True
    yield
    FA._INTERPRET = old


def _bounds(kind, b, mh, s, seed):
    """(sr, er) [B, MH, S] int32 of one mask kind."""
    rng = np.random.default_rng(seed)
    j = np.broadcast_to(np.arange(s), (b, mh, s))
    if kind == "document":          # column j masks the rows past its doc
        sr = np.empty((b, mh, s), np.int64)
        for i in range(b):
            for h in range(mh):
                ends = np.minimum(np.cumsum(rng.integers(3, 13, s)), s)
                sr[i, h] = ends[np.searchsorted(ends, np.arange(s),
                                                side="right")]
        er = np.full_like(sr, s)
    elif kind == "window":          # column j seen by rows [j, j + 7)
        sr = np.minimum(j + 7, s)
        er = np.full_like(sr, s)
    elif kind == "band":            # rows [j + 5, j + 14) masked, then seen
        sr, er = j + 5, j + 14
    elif kind == "random":
        sr = rng.integers(0, s + 1, (b, mh, s))
        er = sr + rng.integers(0, s + 1, (b, mh, s))
    else:                           # "dead": the first 8 columns masked for
        sr = np.where(j < 8, 0, s)  # every row, so rows 0-7 see nothing
        er = np.full_like(sr, s)
    return sr.astype(np.int32), er.astype(np.int32)


def _inputs(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(4)]


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _fm_pair(q, k, v, do, sr, er, scale, causal, block):
    """The Pallas forward and backward, jitted so that cases of one shape
    share one compilation of the interpret-mode kernels."""
    o, lse = FM._fm_fwd(q, k, v, sr, er, scale, causal, block, block)
    return (o, lse) + tuple(FM._fm_bwd(q, k, v, o, lse, do, sr, er, scale,
                                       causal, block, block))


def _jax_fwd_bwd(q, k, v, do, sr, er, scale, causal, block=BLOCK):
    bh = q.shape[0]
    rep = bh // sr.shape[0] // sr.shape[1]

    def lanes(x):                   # the TPU's [BH, 8, S] int32 tiles
        x = np.repeat(x, rep, axis=1).reshape(bh, 1, -1)
        return jnp.asarray(np.broadcast_to(x, (bh, 8, x.shape[-1])))

    o, lse, dq, dk, dv = _fm_pair(*(jnp.asarray(x) for x in (q, k, v, do)),
                                  lanes(sr), lanes(er), float(scale),
                                  bool(causal), block)
    return [np.asarray(x) for x in (o, lse[:, 0], dq, dk, dv)]


def _port_fwd_bwd(q, k, v, do, sr, er, scale, causal):
    tq, tk, tv, tdo, tsr, ter = (torch.as_tensor(x)
                                 for x in (q, k, v, do, sr, er))
    o, lse = tfm.flashmask_fwd(tq, tk, tv, tsr, ter, scale, causal)
    dq, dk, dv = tfm.flashmask_bwd(tq, tk, tv, o, lse, tdo, tsr, ter, scale,
                                   causal)
    return [x.numpy() for x in (o, lse, dq, dk, dv)]


@pytest.mark.parametrize("kind,causal,mh", [
    ("document", True, 1), ("document", False, 2), ("window", True, 1),
    ("band", True, 2), ("random", False, 2), ("random", True, 1),
    ("dead", True, 1)])
def test_plain_fwd_bwd_match_the_pallas_kernels(kind, causal, mh):
    """B=1, H=2 heads over 1 or 2 mask heads, S=32 over 16-wide tiles (the
    tile skip of the reference included)."""
    s, d = 32, 16
    q, k, v, do = _inputs(len(kind) + mh, 2, s, d)
    sr, er = _bounds(kind, 1, mh, s, 3)
    scale = 0.25
    want = _jax_fwd_bwd(q, k, v, do, sr, er, scale, causal)
    got = _port_fwd_bwd(q, k, v, do, sr, er, scale, causal)
    for name, w, g in zip(("o", "lse", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    if kind == "dead":              # rows that see nothing
        assert not got[0][:, :8].any() and not got[2][:, :8].any()
        assert (got[1][:, :8] == np.float32(-1e30)).all()
        assert not got[3][:, :8].any() and not got[4][:, :8].any()


@pytest.mark.parametrize("causal", [True, False])
def test_reference_tail_tile_is_nan_where_the_port_is_exact(causal):
    """A fault of the reference, not of the port: with S not a multiple
    of the Pallas tile (S=40, 16-row tiles) the interpret-mode FlashMask
    kernels read the padded tail of q / k / v / do as NaN; ``_mask_block``
    masks padded columns but not padded rows, so the tail rows of o and dq
    and every row of dk and dv come out NaN (causal), every row of all
    four (full). The port zero-fills and masks its tails and agrees with
    the reference run over one whole tile."""
    q, k, v, do = _inputs(7, 1, 40, 16)
    sr, er = _bounds("document", 1, 1, 40, 5)
    tiled = _jax_fwd_bwd(q, k, v, do, sr, er, 0.25, causal, block=16)
    whole = _jax_fwd_bwd(q, k, v, do, sr, er, 0.25, causal, block=64)
    got = _port_fwd_bwd(q, k, v, do, sr, er, 0.25, causal)
    bad = [np.isnan(x).any(axis=(0, 2)) for x in (tiled[0], tiled[3])]
    assert bad[0][32:].all() and bad[0][:32].any() == (not causal)
    assert bad[1].all()
    assert all(np.isfinite(x).all() for x in whole + got)
    for name, w, g in zip(("o", "lse", "dq", "dk", "dv"), whole, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kvh,mh,cols", [(2, 1, 1), (2, 2, 2), (4, 4, 2)])
def test_autograd_function_matches_jax_vjp_with_gqa(kvh, mh, cols):
    """[B, S, H, D] with H=4 query heads over KVH kv heads and MH mask
    heads: the port repeats kv heads before the kernel, reads the mask
    head in the kernel's own indexing and takes int64 indices; autograd
    sums dk / dv over each group, as ``jnp.repeat``'s transpose does."""
    rng = np.random.default_rng(kvh + 10 * mh + cols)
    b, s, h, d = 1, 32, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    sr, er = _bounds("document" if cols == 1 else "band", b, mh, s, 9)
    idx = (sr[..., None] if cols == 1 else np.stack([sr, er], -1))

    def f(q_, k_, v_):
        return FM.flashmask_attention_bshd(q_, k_, v_, jnp.asarray(idx),
                                           causal=True, block_q=BLOCK,
                                           block_k=BLOCK)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tidx = torch.as_tensor(idx.astype(np.int64))
    out = tfm.flashmask_attention_bshd(tq, tk, tv, tidx, causal=True)
    out.backward(torch.as_tensor(g))
    got = [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for name, w, x in zip(("o", "dq", "dk", "dv"), want, got):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x, w, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_incubate_entry_matches_both_jax_routes(causal):
    """``incubate.nn.functional.flashmask_attention`` against the JAX
    function with interpret mode on (the Pallas kernels) and off (its
    dense XLA fallback, :368-392): GQA 4/2, one mask head, 2 columns."""
    rng = np.random.default_rng(21)
    b, s, h, kvh, d = 1, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    sr, er = _bounds("random", b, 1, s, 4)
    idx = np.stack([sr, er], -1)
    got = TFI.flashmask_attention(*(torch.as_tensor(x)
                                    for x in (q, k, v, idx)),
                                  causal=causal).numpy()
    for interpret in (True, False):
        FA._INTERPRET = interpret
        want = JFI.flashmask_attention(*(paddle.to_tensor(x)
                                         for x in (q, k, v, idx)),
                                       causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"interpret={interpret}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_twopass_matches_the_pallas_two_pass(causal):
    """The port's two-pass backward on the CPU is ``flash_bwd_plain``: it
    matches ``_flash_bwd_twopass`` in interpret mode, which matches the
    fused ``_flash_bwd``, so one plain version serves both."""
    q, k, v, do = _inputs(31, 2, 32, 16)
    scale = 0.25
    args = [jnp.asarray(x) for x in (q, k, v)]
    o, lse = FA._flash_fwd(*args, scale, causal, BLOCK, BLOCK)
    two = FA._flash_bwd_twopass(*args, o, lse, jnp.asarray(do), scale,
                                causal, BLOCK, BLOCK, BLOCK, BLOCK)
    fused = FA._flash_bwd(*args, o, lse, jnp.asarray(do), scale, causal,
                          BLOCK, BLOCK, BLOCK, BLOCK)
    got = tfa.flash_bwd_twopass(*(torch.as_tensor(np.array(x)) for x in (
        q, k, v, o, lse[:, 0], do)), scale, causal)
    for name, t, f, g in zip(("dq", "dk", "dv"), two, fused, got):
        np.testing.assert_allclose(np.asarray(f), np.asarray(t), rtol=0,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=0,
                                   atol=ATOL, err_msg=name)
    x = torch.zeros(1, 8, 32)
    tab = torch.zeros(8, 16)
    with pytest.raises(NotImplementedError, match="no in-kernel rope"):
        tfa.flash_bwd_twopass(x, x, x, x, torch.zeros(1, 8), x, 1.0, True,
                              rope_cos=tab, rope_sin=tab)


@pytest.mark.parametrize("cols,mh,causal", [(1, 1, True), (2, 4, True),
                                            (2, 1, False)])
def test_nn_form_matches_the_jax_nn_form(cols, mh, causal):
    """``nn.functional.flashmask_attention`` runs the JAX ``nn`` form: the
    start column only, ``tril`` when causal, the dense softmax (the rows
    the band masks from every column are rows of uniform weights, as in
    JAX). With no index it is flash attention."""
    rng = np.random.default_rng(cols + mh)
    b, s, h, d = 2, 32, 4, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    sr, er = _bounds("band", b, mh, s, 2)
    idx = sr[..., None] if cols == 1 else np.stack([sr, er], -1)
    got = TF.flashmask_attention(*(torch.as_tensor(x)
                                   for x in (q, k, v, idx)),
                                 causal=causal).numpy()
    want = JF.flashmask_attention(*(paddle.to_tensor(x)
                                    for x in (q, k, v, idx)),
                                  causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = TF.flashmask_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                   causal=causal).numpy()
    flash, _ = TF.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                  causal=causal)
    np.testing.assert_allclose(plain, flash.numpy(), rtol=0, atol=0)


def test_the_two_jax_forms_read_a_two_column_index_differently():
    """A fault of the reference, kept by the port: the ``nn`` form
    (attention.py:142-167) reads only the start column and keeps rows r <
    start, while the ``incubate`` form (:355-395) masks [start, end). With
    end < S they disagree on the rows past end, in JAX and in the port
    alike; with end = S they agree. (The JAX ``incubate`` form runs its
    dense fallback here: the Pallas route is held to it above.)"""
    FA._INTERPRET = False
    rng = np.random.default_rng(8)
    b, s, h, d = 1, 32, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    sr, er = _bounds("band", b, 1, s, 0)
    for end, agree in ((er, False), (np.full_like(er, s), True)):
        idx = np.stack([sr, end], -1)
        outs = []
        for fn, conv in ((JF.flashmask_attention, paddle.to_tensor),
                         (JFI.flashmask_attention, paddle.to_tensor),
                         (TF.flashmask_attention, torch.as_tensor),
                         (TFI.flashmask_attention, torch.as_tensor)):
            outs.append(fn(*(conv(x) for x in (q, k, v, idx)),
                           causal=True).numpy())
        np.testing.assert_allclose(outs[2], outs[0], rtol=0, atol=ATOL)
        np.testing.assert_allclose(outs[3], outs[1], rtol=0, atol=ATOL)
        assert np.allclose(outs[0], outs[1], atol=1e-3) == agree


def test_plain_versions_take_the_dtype_steps():
    """bf16 inputs: p stays f32 (never rounded to bf16, unlike flash's), so
    the plain forward equals the f32 computation on the bf16 inputs
    rounded once at the end; the gradients come back in bf16."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 24, 32))
                               .astype(np.float32)).bfloat16()
               for _ in range(3))
    sr, er = (torch.as_tensor(x) for x in _bounds("document", 1, 2, 24, 1))
    o, lse = tfm.flashmask_fwd(q, k, v, sr, er, 0.2, True)
    ref, rlse = tfm.flashmask_fwd(q.float(), k.float(), v.float(), sr, er,
                                  0.2, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, ref.bfloat16()) and torch.equal(lse, rlse)
    grads = tfm.flashmask_bwd(q, k, v, o, lse, torch.ones_like(o), sr, er,
                              0.2, True)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_entries_refuse_what_they_do_not_take():
    """Index shapes and types are checked before anything runs; dropout in
    the ``nn`` form is taken now (the reference route, as the JAX
    package's; tests/test_torch_flash_attention.py holds its keep rate);
    a tensor neither on the CPU nor on a GPU raises."""
    x = torch.zeros(1, 16, 2, 32)
    for idx in (torch.zeros(1, 1, 16, 3, dtype=torch.int32),
                torch.zeros(1, 3, 16, 1, dtype=torch.int32),
                torch.zeros(1, 1, 15, 1, dtype=torch.int32),
                torch.zeros(1, 1, 16, 1)):
        with pytest.raises(ValueError, match="startend_row_indices"):
            TFI.flashmask_attention(x, x, x, idx)
    v = torch.ones(1, 16, 2, 32)
    full = torch.full((1, 1, 16, 1), 16, dtype=torch.int32)
    kept = TF.flashmask_attention(x, x, v, full, dropout=0.5)
    assert kept.shape == v.shape and bool(torch.isfinite(kept).all())
    assert not torch.equal(kept, TF.flashmask_attention(x, x, v, full))
    q = torch.zeros(2, 16, 32, device="meta")
    sr = torch.zeros(1, 1, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.flashmask_fwd(q, q, q, sr, sr, 1.0, True)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.flashmask_bwd(q, q, q, q, q[..., 0], q, sr, sr, 1.0, True)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_bwd_twopass(q, q, q, q, q[..., 0], q, 1.0, True)


@pytest.mark.parametrize("args", [[], ["--only", "fwd"], ["--only", "bwd"]])
def test_flashmask_kernel_ab_refuses_without_a_card(args):
    """``tools/flashmask_kernel_ab.py`` (forward and backward) measures only
    on a card: without one it exits 2 and prints no result."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(
        root, "tools", "flashmask_kernel_ab.py"), *args],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr and r.stdout == ""


def test_flashmask_kernel_ab_reads_ptxas_for_every_kernel():
    """The A/B tool's ``-Xptxas -v`` reader names the forward and backward
    kernels, tensor-core and f32, with their registers and spills."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "flashmask_kernel_ab", os.path.join(root, "tools",
                                            "flashmask_kernel_ab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ns = "_ZN45_GLOBAL__N__9f405fcc_12_flashmask_cu_20a05dd2"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}20flashmask_fwd_"
        "kernelI13__nv_bfloat16Li64ELi2EEEvPKT_S4_' for 'sm_90a'",
        "    56 bytes stack frame, 52 bytes spill stores, 76 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{ns}24flashmask_fwd_"
        "kernel_f32ILi32EEEvPKfS2_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{ns}23flashmask_bwd_dq_"
        "kernelI6__halfLi128ELb1ELi2EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 241 registers, used 1 barriers"])
    out = tool.ptxas_summary(log)
    assert out == {
        "flashmask_fwd_kernel<bf16,64,2>":
            "128 registers, spill 52/76 bytes",
        "flashmask_fwd_kernel_f32<32>": "64 registers, spill 0/0 bytes",
        "flashmask_bwd_dq_kernel<fp16,128,1,2>":
            "241 registers, spill 0/0 bytes"}
