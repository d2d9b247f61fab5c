"""The PyTorch port's paged-attention module held against the JAX
package on the CPU: the host work list (arrays and incremental builder)
must be identical, the cache ops must leave identical caches (drop
boundaries included), and the plain ragged attention must match the
JAX work-list reference in f32 at atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import paged_attention as jpa  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402

ATOL = 1e-5     # f32: same masked softmax, different summation order


def _assert_work_equal(got, ref):
    garr, gt_real, gt_total, gpack = got
    rarr, rt_real, rt_total, rpack = ref
    assert (gt_real, gt_total, gpack) == (rt_real, rt_total, rpack)
    assert len(garr) == len(rarr) == 9
    for a, b in zip(garr, rarr):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


class TestWorkList:
    @pytest.mark.parametrize("pack", [1, 2, 3, 8])
    @pytest.mark.parametrize("bucket", [False, True])
    def test_build_ragged_work_identical(self, pack, bucket):
        rng = np.random.default_rng(pack)
        b, max_nb, bs = 6, 5, 4
        tables = rng.integers(0, 40, (b, max_nb)).astype(np.int32)
        lens = np.array([0, 3, 20, 21, 7, 16], np.int32)   # 21: over cap
        qls = np.array([0, 3, 4, 1, 2, 16], np.int32)
        for q_lens in (None, qls):
            kw = dict(q_lens=q_lens)
            if bucket:
                kw["bucket_to"] = tpa.next_pow2
                ref = jpa.build_ragged_work(tables, lens, bs, pack,
                                            bucket_to=jpa.next_pow2,
                                            q_lens=q_lens)
            else:
                ref = jpa.build_ragged_work(tables, lens, bs, pack,
                                            q_lens=q_lens)
            _assert_work_equal(
                tpa.build_ragged_work(tables, lens, bs, pack, **kw), ref)

    def test_helpers_identical(self):
        for n in range(0, 70):
            assert tpa.next_pow2(n) == jpa.next_pow2(n)
        for b in range(1, 10):
            for g in (1, 2, 4, 8):
                assert tpa.default_pack(b, g) == jpa.default_pack(b, g)

    def test_builder_identical_under_seeded_churn(self):
        b, max_nb, bs = 5, 6, 4
        pack = 2
        jb = jpa.RaggedWorkBuilder(b, max_nb, bs, pack)
        tb = tpa.RaggedWorkBuilder(b, max_nb, bs, pack)
        rng = np.random.default_rng(7)
        tables = np.zeros((b, max_nb), np.int32)
        lens = np.zeros(b, np.int32)
        for step in range(60):
            # churn: admit/retire/grow rows, mark them dirty in both
            for s in range(b):
                ev = rng.random()
                if ev < 0.15:
                    tables[s] = rng.integers(1, 60, max_nb)
                    lens[s] = rng.integers(0, max_nb * bs)
                    jb.mark_dirty(s)
                    tb.mark_dirty(s)
                elif ev < 0.2:
                    tables[s] = 0
                    lens[s] = 0
                    jb.mark_dirty(s)
                    tb.mark_dirty(s)
            if step % 17 == 0:
                jb.mark_all_dirty()
                tb.mark_all_dirty()
            qls = np.where(rng.random(b) < 0.3, 0,
                           rng.integers(1, 5, b)).astype(np.int32)
            attn = np.minimum(lens + qls, max_nb * bs).astype(np.int32)
            got = tb.build(tables, attn, qls)
            ref = jb.build(tables, attn, qls)
            _assert_work_equal(got, ref)
            lens = np.where(qls > 0, attn, lens).astype(np.int32)
        for name in ("segments_reused", "segments_rebuilt",
                     "assemblies_full", "assemblies_incremental"):
            assert getattr(tb, name) == getattr(jb, name), name
        assert tb.assemblies_incremental > 0 and tb.assemblies_full > 0


def _caches(seed, kvh=2, nb=9, bs=4, d=8):
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, nb, bs, d)).astype(np.float32)
    return kc, vc


def _t(a):
    return torch.from_numpy(np.array(a))


class TestCacheOps:
    @pytest.mark.parametrize("lens", [[8, 3, 8], [7, 7, 7], [0, 4, 5]],
                             ids=["full_rows_dropped", "last_slot",
                                  "block_edges"])
    def test_update_decode_identical(self, lens):
        kc, vc = _caches(1)
        rng = np.random.default_rng(2)
        kn = rng.standard_normal((3, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((3, 2, 8)).astype(np.float32)
        tables = np.arange(6, dtype=np.int32).reshape(3, 2)
        lens = np.asarray(lens, np.int32)
        rk, rv = jpa.update_paged_kv_cache(
            jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(tables), jnp.asarray(lens))
        tk, tv = _t(kc), _t(vc)
        gk, gv = tpa.update_paged_kv_cache(tk, tv, _t(kn), _t(vn), tables,
                                           lens)
        assert gk is tk and gv is tv                 # in place
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))

    def test_full_row_write_changes_nothing_else(self):
        kc, vc = _caches(3)
        kn = np.ones((3, 2, 8), np.float32)
        tables = np.arange(6, dtype=np.int32).reshape(3, 2)
        tk = _t(kc)
        tpa.update_paged_kv_cache(tk, _t(vc), _t(kn), _t(kn), tables,
                                  np.array([8, 3, 8], np.int32))
        exp = kc.copy()
        exp[:, tables[1, 0], 3] = 1.0
        np.testing.assert_array_equal(tk.numpy(), exp)

    def test_chunk_update_identical_spans_and_drops(self):
        kc, vc = _caches(4)
        rng = np.random.default_rng(5)
        b, c = 3, 6
        kn = rng.standard_normal((b, c, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((b, c, 2, 8)).astype(np.float32)
        tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
        lens = np.array([2, 5, 7], np.int32)      # crosses blocks / cap
        counts = np.array([6, 2, 3], np.int32)
        rk, rv = jpa.update_paged_kv_cache_chunk(
            jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(tables), jnp.asarray(lens),
            jnp.asarray(counts))
        tk, tv = _t(kc), _t(vc)
        tpa.update_paged_kv_cache_chunk(tk, tv, _t(kn), _t(vn), tables,
                                        lens, counts)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))

    def test_truncate_identical(self):
        kc, vc = _caches(6)
        tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
        new = np.array([2, 5, 8], np.int32)
        old = np.array([6, 5, 9], np.int32)      # 9: past the capacity
        rk, rv = jpa.truncate_paged_kv_cache(
            jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables),
            jnp.asarray(new), jnp.asarray(old), 4)
        tk, tv = _t(kc), _t(vc)
        tpa.truncate_paged_kv_cache(tk, tv, tables, new, old, 4)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))

    @pytest.mark.parametrize("src,dst", [(2, 5), (99, 4), (3, 9), (4, 4)],
                             ids=["copy", "src_clamped", "dst_dropped",
                                  "self"])
    def test_copy_block_identical(self, src, dst):
        kc, vc = _caches(7)
        rk, rv = jpa.copy_paged_kv_block(jnp.asarray(kc), jnp.asarray(vc),
                                         src, dst)
        tk, tv = _t(kc), _t(vc)
        tpa.copy_paged_kv_block(tk, tv, src, dst)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def _attn_setup(h, kvh, lens, c=None, seed=0, d=16, bs=4, max_nb=5):
    rng = np.random.default_rng(seed)
    b = len(lens)
    nblk = b * max_nb + 3
    shape = (b, h, d) if c is None else (b, c, h, d)
    q = rng.standard_normal(shape).astype(np.float32)
    kc = rng.standard_normal((kvh, nblk, bs, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, nblk, bs, d)).astype(np.float32)
    tables = np.stack([rng.choice(nblk, max_nb, replace=False)
                       for _ in range(b)]).astype(np.int32)
    return q, kc, vc, tables, np.asarray(lens, np.int32)


GROUPS = [pytest.param(4, 4, id="G1"), pytest.param(8, 4, id="G2"),
          pytest.param(8, 2, id="G4")]


class TestRaggedAttention:
    @pytest.mark.parametrize("h,kvh", GROUPS)
    def test_decode_matches_jax_reference(self, h, kvh):
        q, kc, vc, tables, lens = _attn_setup(h, kvh, [0, 12, 1, 20, 23])
        ref = jpa.ragged_paged_attention_reference(q, kc, vc, tables, lens)
        got = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                               tables, lens)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)

    @pytest.mark.parametrize("h,kvh", GROUPS)
    def test_chunked_matches_jax_reference(self, h, kvh):
        # full chunks, partial chunks, a parked row (q_len 0) and a
        # zero-length row
        q, kc, vc, tables, lens = _attn_setup(h, kvh, [6, 0, 19, 9, 4],
                                              c=6, seed=1)
        qls = np.array([6, 0, 3, 1, 4], np.int32)
        ref = jpa.ragged_paged_attention_reference(q, kc, vc, tables, lens,
                                                   q_lens=qls)
        got = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                               tables, lens, q_lens=qls)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
        assert not got[1].any() and not got[0, :].isnan().any()

    def test_over_capacity_len_attends_over_table(self):
        q, kc, vc, tables, lens = _attn_setup(8, 4, [21, 3], seed=2)
        ref = jpa.ragged_paged_attention_reference(q, kc, vc, tables, lens)
        got = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                               tables, lens)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)

    def test_free_slot_ids_clamped(self):
        # -1 free-slot ids past the walked blocks never index out of the
        # pool; ids inside the walk are clamped like the kernel's DMA
        q, kc, vc, tables, lens = _attn_setup(8, 4, [5, 8], seed=3)
        tables[:, 2:] = -1
        got = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                               tables, lens)
        ref = jpa.ragged_paged_attention_reference(
            q, kc, vc, np.clip(tables, 0, kc.shape[1] - 1), lens)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)

    def test_wrapper_runs_plain_on_cpu_without_counting(self):
        q, kc, vc, tables, lens = _attn_setup(8, 4, [5, 0, 17], c=3, seed=4)
        qls = np.array([3, 0, 2], np.int32)
        before = tpa.ragged_paged_attention.launches
        got = tpa.ragged_paged_attention(_t(q), _t(kc), _t(vc), tables,
                                         lens, q_lens=qls)
        plain = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                                 tables, lens, q_lens=qls)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        assert tpa.ragged_paged_attention.launches == before

    def test_bf16_close_to_f32(self):
        q, kc, vc, tables, lens = _attn_setup(8, 4, [13, 20], seed=5)
        f32 = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                               tables, lens)
        b16 = tpa.ragged_paged_attention_plain(
            _t(q).bfloat16(), _t(kc).bfloat16(), _t(vc).bfloat16(), tables,
            lens)
        assert b16.dtype == torch.bfloat16
        torch.testing.assert_close(b16.float(), f32, rtol=5e-2, atol=5e-2)


# -- the split plan and the split-and-combine arithmetic ---------------------

SMS = 132       # an H100's SM count: the plan takes it as an argument here


def _plan(b, c, dtype=torch.bfloat16, h=16, kvh=8, max_nb=32, bs=16, d=64,
          sms=SMS):
    return tpa.ragged_plan(b, c, h, kvh, max_nb, bs, d, dtype, sms=sms)


class TestRaggedPlan:
    """``ragged_plan`` decides the kernel's grid from shapes alone."""

    @pytest.mark.parametrize("b,c,dtype,want", [
        # the smoke's decode, mixed C=64 and bucketed C=16 steps (serving
        # widths H=16, KVH=8, D=64, BS=16, 32 pages a table row)
        (8, 1, torch.bfloat16, ("decode", 8, 4, 1, 512, 8 * 64 * 2 * 66 * 4)),
        (8, 64, torch.bfloat16, ("mma", 4, 8, 2, 512,
                                 4 * 128 * 64 * 66 * 4)),
        (8, 16, torch.bfloat16, ("mma", 8, 4, 1, 512, 8 * 64 * 32 * 66 * 4)),
        (8, 64, torch.float32, ("decode", 4, 8, 2, 512,
                                4 * 128 * 64 * 66 * 4)),
        (8, 4, torch.float16, ("decode", 8, 4, 1, 512, 8 * 64 * 8 * 66 * 4)),
        (64, 1, torch.bfloat16, ("decode", 1, 32, 1, 512, 0)),
        (32, 1, torch.bfloat16, ("decode", 2, 16, 1, 512,
                                 2 * 256 * 2 * 66 * 4)),
        (1, 1, torch.bfloat16, ("decode", 32, 1, 1, 256, 32 * 8 * 2 * 66 * 4)),
    ])
    def test_pinned_at_the_smoke_shapes(self, b, c, dtype, want):
        got = _plan(b, c, dtype)
        assert tuple(got[k] for k in tpa.PLAN_KEYS) == want, got

    @pytest.mark.parametrize("b", [1, 3, 8, 17, 64, 300])
    @pytest.mark.parametrize("c,h,kvh", [(1, 16, 8), (64, 16, 8), (7, 12, 3),
                                         (1, 8, 8), (200, 4, 1)])
    @pytest.mark.parametrize("max_nb", [1, 5, 32, 100])
    @pytest.mark.parametrize("sms", [132, 7])
    def test_invariants(self, b, c, h, kvh, max_nb, sms):
        p = _plan(b, c, h=h, kvh=kvh, max_nb=max_nb, sms=sms)
        s, pps = p["splits"], p["pages_per_split"]
        span = c * (h // kvh)
        unsplit = b * kvh * -(-span // 64)
        assert p["tiles"] == -(-span // 64)
        assert s * pps >= max_nb and (s - 1) * pps < max_nb   # no idle split
        assert 1 <= s <= 32 and p["blocks"] == s * unsplit
        # one split when the unsplit grid already covers the SMs twice
        assert (s == 1) == (unsplit >= 2 * sms or max_nb == 1)
        # else the grid reaches two waves, unless the splits ran out
        assert p["blocks"] >= 2 * sms or s == 1 \
            or pps == max(1, -(-max_nb // 32))
        assert p["workspace_bytes"] == (
            s * unsplit * min(64, span) * (64 + 2) * 4 if s > 1 else 0)
        assert p["route"] == ("mma" if span >= 16 else "decode")
        assert _plan(b, c, torch.float32, h=h, kvh=kvh, max_nb=max_nb,
                     sms=sms)["route"] == "decode"


def _split_setup(lens, c=None, seed=7, h=8, kvh=2, d=16, bs=4, max_nb=10,
                 free_tail=()):
    rng = np.random.default_rng(seed)
    b = len(lens)
    nblk = b * max_nb + 3
    shape = (b, h, d) if c is None else (b, c, h, d)
    q = rng.standard_normal(shape).astype(np.float32)
    kc = rng.standard_normal((kvh, nblk, bs, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, nblk, bs, d)).astype(np.float32)
    tables = np.stack([rng.choice(nblk, max_nb, replace=False)
                       for _ in range(b)]).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i in free_tail:       # -1 free-slot ids past the row's used blocks
        tables[i, min(-(-int(lens[i]) // bs), max_nb):] = -1
    return q, kc, vc, tables, lens


# lengths 0, 1, a page's edge, a split's edge, past the table's capacity
# (10 pages of 4 = 40), with -1 ids after the used blocks of three rows
SPLIT_LENS = [0, 1, 4, 5, 23, 40, 47, 13]
SPLIT_QLENS = [0, 1, 4, 5, 6, 6, 0, 2]      # parked, full, partial, dead rows
SPLIT_PLANS = [(1, 10), (2, 5), (3, 4), (8, 2), (10, 1)]  # (S, P): S P >= 10


@pytest.fixture(scope="module")
def split_refs():
    """The JAX package's Pallas ragged kernel (interpret mode, as its own
    tests run it on the CPU) on the decode and the chunked case."""
    from paddle_tpu.ops.pallas import flash_attention as jfa
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        out = {}
        for c, qls in ((None, None), (6, np.asarray(SPLIT_QLENS, np.int32))):
            q, kc, vc, tables, lens = _split_setup(SPLIT_LENS, c=c,
                                                   free_tail=(1, 3, 4))
            clipped = np.clip(tables, 0, kc.shape[1] - 1)
            out[c] = np.asarray(jpa.ragged_paged_attention(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), clipped,
                lens, q_lens=qls))
        return out
    finally:
        jfa._INTERPRET = old


class TestSplitCombine:
    """``ragged_split_plain``: the kernel's partials per split, summed in
    split order, against the JAX kernel and the plain version (f32, atol
    1e-5: the same softmax in another summation order)."""

    @pytest.mark.parametrize("splits,pps", SPLIT_PLANS)
    @pytest.mark.parametrize("c", [None, 6])
    def test_matches_jax_kernel_and_plain(self, split_refs, splits, pps, c):
        qls = None if c is None else np.asarray(SPLIT_QLENS, np.int32)
        q, kc, vc, tables, lens = _split_setup(SPLIT_LENS, c=c,
                                               free_tail=(1, 3, 4))
        got = tpa.ragged_split_plain(_t(q), _t(kc), _t(vc), tables, lens,
                                     splits, pps, q_lens=qls)
        plain = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                                 tables, lens, q_lens=qls)
        np.testing.assert_allclose(got.numpy(), split_refs[c], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=ATOL)
        assert not got[0].any()                       # len 0
        if c is not None:
            assert not got[6].any() and not got[7, 2:].any()  # parked, dead

    @pytest.mark.parametrize("splits,pps", SPLIT_PLANS)
    def test_empty_splits_add_nothing(self, splits, pps):
        """A split past every page of a row leaves m = -1e30, l = 0, acc =
        0: the sum equals the one over the splits that hold pages, also
        for a zero-length row with queries (zeros)."""
        lens = [3, 0, 9, 1]
        qls = np.array([3, 2, 1, 1], np.int32)         # row 1: len 0, q 2
        q, kc, vc, tables, lens = _split_setup(lens, c=3, seed=8)
        got = tpa.ragged_split_plain(_t(q), _t(kc), _t(vc), tables, lens,
                                     splits, pps, q_lens=qls)
        wide = tpa.ragged_split_plain(_t(q), _t(kc), _t(vc), tables, lens,
                                      splits + 5, pps, q_lens=qls)
        plain = tpa.ragged_paged_attention_plain(_t(q), _t(kc), _t(vc),
                                                 tables, lens, q_lens=qls)
        torch.testing.assert_close(wide, got, rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=ATOL)
        assert not got[1].any() and bool(torch.isfinite(got).all())

    def test_wrapper_leaves_route_on_cpu(self):
        q, kc, vc, tables, lens = _split_setup([5, 9])
        route = tpa.ragged_paged_attention.route
        tpa.ragged_paged_attention(_t(q), _t(kc), _t(vc), tables, lens)
        assert tpa.ragged_paged_attention.route == route


def test_ragged_kernel_ab_refuses_without_a_card():
    """``tools/ragged_kernel_ab.py`` measures only on a card: without one it
    exits 2 and prints no result."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                     "ragged_kernel_ab.py")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr and r.stdout == ""
