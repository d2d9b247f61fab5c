"""The PyTorch port's legacy paged decode attention and the fused decode
ops around it, held against the JAX package on the CPU.

* ``paged_attention_plain`` against the Pallas ``paged_attention`` in
  interpret mode (as the JAX package's own tests run it): MHA and GQA,
  block sizes 16 and 64, rows with ctx 0, 1, a block boundary, the
  table's capacity and past it, free-slot ids (-1) past the last used
  block, an explicit scale. f32 within ATOL = 2e-5 (the same f32 products
  and online-softmax steps, summed in another order); bf16 within one bf16
  ulp of the largest output (both sides compute in f32 and round once).
* ``decode_plan``: the decode kernel's split plan from shapes alone, its
  invariants over a grid of shapes and its values at the smoke's shapes.
* ``paged_attention_split_plain`` (the kernel's split-and-combine
  arithmetic) at 1, 2, 3 and MAXNB splits against the Pallas
  ``paged_attention`` in interpret mode, on the same edge rows and
  tolerances as the plain version.
* ``block_multihead_attention``: output and both caches against JAX, MHA
  and GQA, one row at capacity (its write dropped) and one at ctx 0.
* ``block_kv_cache_rewind``, ``blha_get_max_len`` and
  ``masked_multihead_attention`` against JAX.
* ``tools/paged_decode_kernel_ab.py`` refuses to run without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate.nn import functional as JF  # noqa: E402
from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402
from paddle_tpu.ops.pallas import paged_attention as jpa  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402

ATOL = 2e-5     # f32: same products and softmax steps, another sum order


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    yield
    fa._INTERPRET = old


def _case(seed, b, h, kvh, d, bs, nb, max_nb, lens):
    """q, caches and tables; entries past each row's last used block are
    -1 (what a real allocator leaves there)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
    tables = np.stack([rng.choice(np.arange(1, nb), max_nb, replace=False)
                       for _ in range(b)]).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    used = np.minimum(-(-lens // bs), max_nb)
    for i in range(b):
        tables[i, used[i]:] = -1
    return q, kc, vc, tables, lens


def _jax(q, kc, vc, tables, lens, scale=None, dtype=jnp.float32):
    out = jpa.paged_attention(jnp.asarray(q, dtype), jnp.asarray(kc, dtype),
                              jnp.asarray(vc, dtype), jnp.asarray(tables),
                              jnp.asarray(lens), scale=scale)
    return np.asarray(out.astype(jnp.float32))


def _port(q, kc, vc, tables, lens, scale=None, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, kc, vc)]
    return tpa.paged_attention(*t, tables, lens, scale=scale)


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("bs", [16, 64])
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)], ids=["mha", "gqa4"])
    def test_f32_edge_lengths(self, h, kvh, bs):
        max_nb = 3
        cap = max_nb * bs
        lens = [0, 1, bs, cap, cap + 5, bs + 3]
        args = _case(h + bs, len(lens), h, kvh, 16, bs, 24, max_nb, lens)
        got = _port(*args)
        assert got.dtype == torch.float32 and got.shape == (len(lens), h, 16)
        np.testing.assert_allclose(got.numpy(), _jax(*args), rtol=0,
                                   atol=ATOL)
        assert float(got[0].abs().max()) == 0.0     # ctx 0: exact zeros

    def test_explicit_scale(self):
        args = _case(3, 3, 4, 2, 8, 16, 12, 3, [7, 33, 48])
        got = _port(*args, scale=0.3)
        np.testing.assert_allclose(got.numpy(), _jax(*args, scale=0.3),
                                   rtol=0, atol=ATOL)
        assert not np.allclose(got.numpy(), _port(*args).numpy())

    def test_bf16(self):
        args = _case(4, 4, 8, 4, 16, 16, 20, 4, [0, 17, 64, 40])
        got = _port(*args, dtype=torch.bfloat16)
        ref = _jax(*args, dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        # one bf16 ulp at the largest |out|: both sides sum in f32 from the
        # same bf16 inputs, then round once
        tol = 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)

    def test_int64_tables_and_tensor_lens(self):
        q, kc, vc, tables, lens = _case(5, 2, 4, 2, 8, 16, 10, 2, [9, 20])
        got = _port(q, kc, vc, torch.from_numpy(tables.astype(np.int64)),
                    torch.from_numpy(lens.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(),
                                   _jax(q, kc, vc, tables, lens), rtol=0,
                                   atol=ATOL)

    def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(self):
        args = _case(6, 2, 4, 4, 8, 16, 8, 2, [3, 30])
        before = tpa.paged_attention.launches
        t = [torch.from_numpy(a) for a in args[:3]]
        got = tpa.paged_attention(*t, *args[3:])
        ref = tpa.paged_attention_plain(*t, *args[3:])
        assert torch.equal(got, ref)
        assert tpa.paged_attention.launches == before
        with pytest.raises(ValueError, match="unsupported device"):
            tpa.paged_attention(t[0].to("meta"), *t[1:], *args[3:])


def _plan(b, h=16, kvh=8, max_nb=32, bs=16, d=64, sms=132):
    return tpa.decode_plan(b, h, kvh, max_nb, bs, d, torch.bfloat16, sms=sms)


class TestDecodePlan:
    """``decode_plan`` decides the kernel's grid from shapes alone."""

    @pytest.mark.parametrize("b,h,kvh,max_nb,bs,want", [
        # phase 16: the serving cache (B=8, H=16, KVH=8, 32 pages of 16),
        # serve_bench's 7 pages of 64, MHA 16/16, 4 pages of 128, MQA 16/1
        (8, 16, 8, 32, 16, (8, 4, 512, 8 * 8 * 16 * 66 * 4)),
        (8, 16, 8, 7, 64, (7, 1, 448, 7 * 8 * 16 * 66 * 4)),
        (8, 16, 16, 32, 16, (4, 8, 512, 4 * 8 * 16 * 66 * 4)),
        (8, 16, 8, 4, 128, (4, 1, 256, 4 * 8 * 16 * 66 * 4)),
        (8, 16, 1, 32, 16, (32, 1, 256, 32 * 8 * 16 * 66 * 4)),
        (64, 16, 8, 32, 16, (1, 32, 512, 0)),
    ])
    def test_pinned_at_the_smoke_shapes(self, b, h, kvh, max_nb, bs, want):
        got = _plan(b, h, kvh, max_nb, bs)
        assert tuple(got[k] for k in tpa.DECODE_PLAN_KEYS) == want, got

    @pytest.mark.parametrize("b", [1, 3, 8, 17, 64, 300])
    @pytest.mark.parametrize("h,kvh", [(16, 8), (16, 16), (16, 1), (12, 3)])
    @pytest.mark.parametrize("max_nb", [1, 5, 7, 32, 100])
    @pytest.mark.parametrize("sms", [132, 7])
    def test_invariants(self, b, h, kvh, max_nb, sms):
        p = _plan(b, h, kvh, max_nb, sms=sms)
        s, pps = p["splits"], p["pages_per_split"]
        unsplit = b * kvh
        assert s * pps >= max_nb and (s - 1) * pps < max_nb   # no idle split
        assert 1 <= s <= tpa.MAX_SPLITS and p["blocks"] == s * unsplit
        # one split when the unsplit grid already covers the SMs twice
        assert (s == 1) == (unsplit >= tpa.SPLIT_WAVES * sms or max_nb == 1)
        # else the grid reaches two waves, unless the splits ran out
        assert p["blocks"] >= tpa.SPLIT_WAVES * sms or s == 1 \
            or pps == max(1, -(-max_nb // tpa.MAX_SPLITS))
        assert p["workspace_bytes"] == (s * b * h * (64 + 2) * 4
                                        if s > 1 else 0)
        # the rule is the ragged kernel's over the same unsplit grid, and
        # neither the block size nor the dtype enters it
        assert (s, pps) == tpa.split_pages(unsplit, max_nb, sms)
        assert tpa.decode_plan(b, h, kvh, max_nb, 128, 64, torch.float32,
                               sms=sms) == p


class TestSplitPlainAgainstPallas:
    """The kernel's split arithmetic: partials per split in log2 units,
    summed in split order, against the Pallas kernel on the edge rows."""

    @pytest.mark.parametrize("splits", [1, 2, 3, "maxnb"])
    @pytest.mark.parametrize("bs", [16, 64])
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 4), (8, 2)],
                             ids=["g1", "g2", "g4"])
    def test_f32_edge_lengths(self, h, kvh, bs, splits):
        max_nb = 3
        cap = max_nb * bs
        lens = [0, 1, bs, cap, cap + 5, bs + 3]
        args = _case(h + bs + 1, len(lens), h, kvh, 16, bs, 24, max_nb, lens)
        s = max_nb if splits == "maxnb" else splits
        t = [torch.from_numpy(a) for a in args[:3]]
        got = tpa.paged_attention_split_plain(*t, *args[3:], s,
                                              -(-max_nb // s))
        assert got.dtype == torch.float32 and got.shape == (len(lens), h, 16)
        np.testing.assert_allclose(got.numpy(), _jax(*args), rtol=0,
                                   atol=ATOL)
        assert float(got[0].abs().max()) == 0.0     # ctx 0: exact zeros

    @pytest.mark.parametrize("splits", [1, 2, 3, 4])
    def test_bf16(self, splits):
        args = _case(4, 4, 8, 4, 16, 16, 20, 4, [0, 17, 64, 40])
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:3]]
        got = tpa.paged_attention_split_plain(*t, *args[3:], splits,
                                              -(-4 // splits))
        ref = _jax(*args, dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        tol = 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)


def test_paged_decode_kernel_ab_refuses_without_a_card():
    """``tools/paged_decode_kernel_ab.py`` measures only on a card:
    without one it exits 2 and prints no result."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(
        root, "tools", "paged_decode_kernel_ab.py"), "--variant",
        "parent=_archive/parent"], capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr and r.stdout == ""


def _T(a):
    return paddle.to_tensor(a)


class TestBlockMultiheadAttention:
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)], ids=["mha", "gqa4"])
    def test_append_then_attend_matches_jax(self, h, kvh):
        b, d, bs, nb, max_nb = 4, 16, 16, 20, 3
        lens = np.array([0, 17, max_nb * bs, 31], np.int32)   # 48: capacity
        rng = np.random.default_rng(h)
        kc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        vc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        tables = np.stack([rng.choice(np.arange(1, nb), max_nb,
                                      replace=False)
                           for _ in range(b)]).astype(np.int32)
        qkv = rng.standard_normal((b, 3, h, d)).astype(np.float32)
        jo, jk, jv = JF.block_multihead_attention(
            _T(qkv), _T(kc), _T(vc), _T(tables), _T(lens))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        to, rk, rv = TF.block_multihead_attention(
            torch.from_numpy(qkv), tk, tv, tables, lens)
        assert rk is tk and rv is tv                    # updated in place
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(tk.numpy(), jk.numpy())
        np.testing.assert_array_equal(tv.numpy(), jv.numpy())
        # the full row's write was dropped: its blocks are unchanged
        full = tables[2]
        np.testing.assert_array_equal(tk[:, full].numpy(), kc[:, full])
        # the GQA form appends the first KVH heads of the k and v slots
        blk, off = tables[1, 17 // bs], 17 % bs
        np.testing.assert_array_equal(tk[:, blk, off].numpy(),
                                      qkv[1, 1, :kvh])

    def test_scale_and_tensor_inputs(self):
        b, h, kvh, d, bs, nb, max_nb = 2, 4, 2, 8, 16, 8, 2
        rng = np.random.default_rng(9)
        kc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        vc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        tables = np.array([[1, 2], [3, 4]], np.int32)
        lens = np.array([5, 20], np.int32)
        qkv = rng.standard_normal((b, 3, h, d)).astype(np.float32)
        jo, _, _ = JF.block_multihead_attention(
            _T(qkv), _T(kc), _T(vc), _T(tables), _T(lens), scale=0.2)
        to, _, _ = TF.block_multihead_attention(
            torch.from_numpy(qkv), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), torch.from_numpy(tables),
            torch.from_numpy(lens), scale=0.2)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=0,
                                   atol=ATOL)


class TestNeighbourOps:
    def test_block_kv_cache_rewind_matches_jax(self):
        kvh, nb, bs, d = 2, 10, 4, 8
        rng = np.random.default_rng(11)
        kc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        vc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
        tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
        new = np.array([2, 7, 12], np.int32)
        old = np.array([5, 7, 14], np.int32)        # row 2 at capacity
        jk, jv = JF.block_kv_cache_rewind(_T(kc), _T(vc), _T(tables),
                                          _T(new), _T(old), 3)
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        rk, rv = TF.block_kv_cache_rewind(tk, tv, tables, new, old, 3)
        assert rk is tk and rv is tv
        np.testing.assert_array_equal(tk.numpy(), jk.numpy())
        np.testing.assert_array_equal(tv.numpy(), jv.numpy())
        assert not np.array_equal(tk.numpy(), kc)

    def test_blha_get_max_len_matches_jax(self):
        enc = np.array([3, 7, 1], np.int32)
        dec = np.array([0, 4, 2], np.int32)
        ref = JF.blha_get_max_len(_T(enc), _T(dec), _T(np.array(3)))
        for args in ((enc, dec), (torch.from_numpy(enc),
                                  torch.from_numpy(dec))):
            got = TF.blha_get_max_len(*args, 3)
            for g, r in zip(got, ref):
                assert g.dtype == torch.int32 and tuple(g.shape) == (1,)
                np.testing.assert_array_equal(g.numpy(), r.numpy())

    @pytest.mark.parametrize("with_mask", [False, True])
    def test_masked_multihead_attention_matches_jax(self, with_mask):
        b, h, smax, d = 3, 2, 8, 4
        rng = np.random.default_rng(12)
        cache = rng.standard_normal((2, b, h, smax, d)).astype(np.float32)
        lens = np.array([3, smax, 0], np.int32)      # row 1: write dropped
        x = rng.standard_normal((b, 3 * h * d)).astype(np.float32)
        mask = None
        if with_mask:
            mask = rng.standard_normal((b, 1, smax)).astype(np.float32)
        jargs = [_T(x), _T(cache), _T(lens)]
        jo, jc = JF.masked_multihead_attention(
            *jargs, src_mask=None if mask is None else _T(mask))
        tc = torch.from_numpy(cache.copy())
        to, rc = TF.masked_multihead_attention(
            torch.from_numpy(x), tc, lens,
            src_mask=None if mask is None else torch.from_numpy(mask))
        assert rc is tc and tuple(to.shape) == (b, h * d)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(tc.numpy(), jc.numpy())
        np.testing.assert_array_equal(tc[:, 1].numpy(), cache[:, 1])
