"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the smoke run does not reach: every head dim and
dtype the attention kernels take (with and without rope), odd group
sizes and block sizes, GEMM rows and depths that are not tile multiples,
the blockwise cross entropy at token counts, vocabularies and hidden
widths off its tiles, with ignored rows, the legacy paged decode
kernel at ctx 0, past the table's capacity and with free-slot ids past
the last used block, and the fused tier's kernels A-D, A's backward and
C's forward on every route their plans name, and C's vocab-sharded form
at shard widths of 1, odd and past one block, with labels on the
shard's edges and every row ignored. The plan knobs the serving
autotuner sets: K3's and K7's ``split_waves`` at one split, at
``MAX_SPLITS`` and at one wave on a grid already past it, and K4's
``bn`` / ``waves`` at an odd count of 128-column tiles and at the
smallest K, each against its plain version and its plan the Python
form's. ``fused_moe``'s int8 experts on K4 at 1, 3 and 1000 rows an
expert, with the GLU on kernel B. The flash kernels at head dim 16
(the UNet's first level) and on cross-attention lengths, ``nn.
MultiHeadAttention`` launching them, and their launch counts from eight
threads at once.

These tests need a CUDA GPU (marker ``cuda``) and skip without one. On a
machine with the card:  python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")


def _tol(ref, dtype):
    """Two units in the last place of the output type at the largest
    reference magnitude: both sides sum in f32, then round once. For f32
    outputs the unit is 2**-16, room for sums of up to a few thousand
    terms taken in another order."""
    eps = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -11}[dtype]
    return 2.0 * eps * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,kvh,bs", [(8, 8, 8), (8, 2, 16), (12, 3, 32)])
def test_ragged_attention_kernel_matches_plain(dtype, d, h, kvh, bs):
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(d + h + bs)
    b, c, max_nb, nb = 5, 7, 6, 40
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    tables = np.stack([rng.choice(nb, max_nb, replace=False)
                       for _ in range(b)]).astype(np.int32)
    tables[0, -1] = -1                      # a free-slot id, clamped
    lens = np.array([0, 1, bs * max_nb + 3, 2 * bs, 9], np.int32)
    qls = np.array([0, 1, c, 5, 2], np.int32)
    for q_lens, cc in ((None, 1), (qls, c)):
        shape = (b, h, d) if q_lens is None else (b, cc, h, d)
        q = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
        before = pa.ragged_paged_attention.launches
        out = pa.ragged_paged_attention(q, kc, vc, tables, lens,
                                        q_lens=q_lens)
        ref = pa.ragged_paged_attention_plain(q, kc, vc, tables, lens,
                                              q_lens=q_lens)
        torch.cuda.synchronize()
        assert pa.ragged_paged_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        err = float((out.float() - ref.float()).abs().max())
        assert err <= _tol(ref, dtype), err


# the serving cache: H=16, KVH=8, D=64, 257 blocks of 16, 32 per table row
SERVE = dict(h=16, kvh=8, d=64, bs=16, nb=257, max_nb=32)
SERVE_LENS = [0, 1, 16, 17, 512, 600, 100, 255]   # 600: past capacity


def _serving_case(b, c, lens, qls, dtype, seed, free_tail=False):
    """Seeded caches, tables (ids 1..NB-1, repeats allowed; with
    ``free_tail`` -1 past each row's last used block) and queries at the
    serving widths; ``c`` None is a [B, H, D] decode query."""
    h, kvh, d, bs, nb, max_nb = (SERVE[k] for k in
                                 ("h", "kvh", "d", "bs", "nb", "max_nb"))
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    tables = rng.integers(1, nb, (b, max_nb)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    if free_tail:
        used = np.minimum(-(-lens.astype(np.int64) // bs), max_nb)
        for i in range(b):
            tables[i, used[i]:] = -1
    shape = (b, h, d) if c is None else (b, c, h, d)
    q = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    qls = None if qls is None else torch.as_tensor(
        np.asarray(qls, np.int32)).cuda()
    return (q, kc, vc, torch.as_tensor(tables).cuda(),
            torch.as_tensor(lens).cuda(), qls)


def _ragged_check(args, dtype):
    from paddle_tpu_torch.ops import paged_attention as pa
    q, kc, vc, tables, lens, qls = args
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(q, kc, vc, tables, lens, q_lens=qls)
    ref = pa.ragged_paged_attention_plain(q, kc, vc, tables, lens,
                                          q_lens=qls)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(ref, dtype), err
    return out, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("c", [None, 64])
def test_ragged_kernel_at_the_serving_shape(dtype, c):
    """Lengths 0, 1, 16, 17, 512 and past capacity, with -1 ids past the
    used blocks, at decode and at C=64 (full, partial, decode and parked
    rows); rows that see nothing are exact zeros."""
    qls = None if c is None else [0, 1, 16, 17, 64, 64, 5, 1]
    args = _serving_case(8, c, SERVE_LENS, qls, dtype, seed=31,
                         free_tail=True)
    out, _ = _ragged_check(args, dtype)
    assert not out[0].any()                 # len 0
    if c is not None:
        assert not out[1, 1:].any() and not out[6, 5:].any()  # dead rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,splits", [(64, None, 1), (32, None, 2),
                                        (8, None, 8), (1, None, 32),
                                        (8, 64, 4), (1, 64, 32)])
def test_ragged_kernel_plans_one_some_and_most_splits(dtype, b, c, splits):
    from paddle_tpu_torch.ops import paged_attention as pa
    plan = pa.ragged_plan(b, 1 if c is None else c, SERVE["h"],
                          SERVE["kvh"], SERVE["max_nb"], SERVE["bs"],
                          SERVE["d"], dtype)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert plan["splits"] == splits, plan
    rng = np.random.default_rng(b)
    lens = rng.integers(0, 600, b)
    lens[:3] = [512, 1, 0][:b]
    qls = None if c is None else np.minimum(rng.integers(0, c + 1, b), lens)
    _ragged_check(_serving_case(b, c, lens, qls, dtype, seed=32), dtype)


@pytest.mark.parametrize("c", [None, 64])
def test_ragged_kernel_is_deterministic(c):
    """The split partials are summed in split order: two calls are
    bit-equal."""
    from paddle_tpu_torch.ops import paged_attention as pa
    qls = None if c is None else [64, 2, 0, 64, 5, 1, 0, 30]
    q, kc, vc, tables, lens, qls = _serving_case(
        8, c, [64, 130, 0, 200, 5, 512, 77, 300], qls, torch.bfloat16, 33)
    a = pa.ragged_paged_attention(q, kc, vc, tables, lens, q_lens=qls)
    b = pa.ragged_paged_attention(q, kc, vc, tables, lens, q_lens=qls)
    assert torch.equal(a, b)


def test_ragged_kernel_counters_reset_between_shapes():
    """Back-to-back calls of different plans share the card's counters:
    each launch leaves them zero, so every call stays right."""
    from paddle_tpu_torch.ops import paged_attention as pa
    dec = _serving_case(8, None, SERVE_LENS, None, torch.bfloat16, 34)
    mix = _serving_case(2, 64, [300, 512], [64, 40], torch.bfloat16, 35)
    one = _serving_case(1, None, [511], None, torch.float16, 36)
    first = _ragged_check(dec, torch.bfloat16)[0]
    for _ in range(3):
        for args, dt in ((mix, torch.bfloat16), (one, torch.float16),
                         (dec, torch.bfloat16)):
            _ragged_check(args, dt)
    assert torch.equal(_ragged_check(dec, torch.bfloat16)[0], first)
    for buf in pa._COUNTERS.values():
        assert not buf.any()


@pytest.mark.parametrize("dtype,c,route", [
    (torch.bfloat16, None, "decode"), (torch.bfloat16, 64, "mma"),
    (torch.float16, 16, "mma"), (torch.float16, 4, "decode"),
    (torch.float32, 64, "decode")])
def test_ragged_kernel_names_its_route(dtype, c, route):
    from paddle_tpu_torch.ops import paged_attention as pa
    qls = None if c is None else [c] * 8
    _ragged_check(_serving_case(8, c, SERVE_LENS, qls, dtype, 37), dtype)
    assert pa.ragged_paged_attention.route == route


# the serving projections (E=1024, F=2816: qkv, lin, ffn1, ffn2) at every
# row count whose plan differs: decode (BM 16, K split), the BM boundary,
# a ragged last row tile, the mixed step and a long prefill
FLAGSHIP_GEMMS = [(m, k, n, 512) for m in (8, 16, 17, 128, 512, 1000)
                  for k, n in ((1024, 2048), (1024, 1024), (1024, 5632),
                               (2816, 1024))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n,bn", [(1, 64, 256, 256), (17, 100, 512, 256),
                                      (70, 33, 1024, 512),
                                      (16, 1024, 768, 256),
                                      (5, 64, 384, 384), (9, 96, 640, 128),
                                      *FLAGSHIP_GEMMS, (8, 256, 128, 128),
                                      (40, 1024, 128, 128)])
def test_int4_kernel_matches_plain(dtype, m, k, n, bn):
    from paddle_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(m + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    packed, sc = qm.pack_int4_blocked(w, bn)
    pk = torch.as_tensor(packed).cuda()
    sc = torch.as_tensor(sc).cuda()
    x = torch.as_tensor(rng.standard_normal((m, k)).astype(
        np.float32)).to(dtype).cuda()
    before = qm.weight_only_matmul.launches
    out = qm.weight_only_matmul(x, pk, sc, "int4", bn)
    ref = qm.weight_only_matmul_plain(x, pk, sc, "int4", bn)
    torch.cuda.synchronize()
    assert qm.weight_only_matmul.launches == before + 1
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(ref, dtype), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n,bn", [(1, 64, 256, 256), (17, 100, 512, 256),
                                      (70, 33, 1024, 512),
                                      (16, 1024, 768, 256),
                                      (5, 64, 384, 384), (9, 96, 640, 128),
                                      (0, 64, 256, 128), *FLAGSHIP_GEMMS,
                                      (8, 256, 128, 128),
                                      (40, 1024, 128, 128)])
def test_int8_kernel_matches_plain(dtype, m, k, n, bn):
    from paddle_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(m + k + n + 1)
    q = torch.as_tensor(rng.integers(-127, 128, (k, n)).astype(
        np.int8)).cuda()
    sc = torch.as_tensor(rng.uniform(1e-3, 1e-2, n).astype(
        np.float32)).cuda()
    x = torch.as_tensor(rng.standard_normal((m, k)).astype(
        np.float32)).to(dtype).cuda()
    before = qm.weight_only_matmul.int8_launches, qm.weight_only_matmul.launches
    out = qm.weight_only_matmul(x, q, sc, "int8", bn)
    ref = qm.weight_only_matmul_plain(x, q, sc, "int8", bn)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    launched = 0 if m == 0 else 1
    assert (qm.weight_only_matmul.int8_launches,
            qm.weight_only_matmul.launches) == (before[0] + launched,
                                                before[1])
    if m:
        err = float((out.float() - ref.float()).abs().max())
        assert err <= _tol(ref, dtype), err


def _gemm_inputs(quant, m, k, n, bn, dtype, seed):
    from paddle_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    if quant == "int4":
        packed, sc = qm.pack_int4_blocked(w, bn)
    else:
        sc = (np.abs(w).max(0) / 127.0).astype(np.float32)
        packed = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    x = torch.as_tensor(rng.standard_normal((m, k)).astype(
        np.float32)).to(dtype).cuda()
    return x, torch.as_tensor(packed).cuda(), torch.as_tensor(sc).cuda()


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", [(8, 2816, 1024), (128, 1024, 2048)])
def test_split_k_gemm_is_deterministic(quant, dtype, m, k, n):
    """A plan that splits K sums its f32 partials in split order in the
    tile's last block: two calls give bit-equal outputs, one launch each."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    assert qm.plan(m, k, n, dtype)["splits"] > 1
    x, w, sc = _gemm_inputs(quant, m, k, n, 512, dtype, m + k)
    counter = "launches" if quant == "int4" else "int8_launches"
    before = getattr(qm.weight_only_matmul, counter)
    a = qm.weight_only_matmul(x, w, sc, quant, 512)
    b = qm.weight_only_matmul(x, w, sc, quant, 512)
    torch.cuda.synchronize()
    assert getattr(qm.weight_only_matmul, counter) == before + 2
    assert torch.equal(a, b)
    ref = qm.weight_only_matmul_plain(x, w, sc, quant, 512)
    assert float((a.float() - ref.float()).abs().max()) <= _tol(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gemm_plan_splits_k_at_decode_and_not_at_prefill(dtype):
    """At M = 8 every flagship projection splits K and its grid fills the
    card as far as slices of at least 128 rows allow; at M = 512 the
    ffn1 projection (N = 5632) has enough tiles and does not split. f32
    keeps the CUDA-core grid (128 columns, no split). Both modes share
    the plan."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, n in ((1024, 2048), (1024, 1024), (1024, 5632), (2816, 1024)):
        p = qm.plan(8, k, n, dtype)
        tiles = n // p["bn"]
        assert p["bm"] == 16 and p["splits"] > 1, p
        assert p["blocks"] == tiles * p["splits"]
        assert p["blocks"] >= min(sms, tiles * (k // 128)), p
        assert p["workspace_bytes"] >= p["splits"] * 8 * n * 4
    p = qm.plan(512, 1024, 5632, dtype)
    assert (p["bm"], p["splits"], p["workspace_bytes"]) == (64, 1, 0), p
    p = qm.plan(8, 1024, 1024, torch.float32)
    assert (p["bn"], p["splits"], p["blocks"]) == (128, 1, 8), p


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import quant_matmul as qm
    q = torch.zeros(2, 4, 48, device="cuda")            # head dim 48
    kc = torch.zeros(2, 4, 8, 48, device="cuda")
    with pytest.raises(ValueError):
        pa.ragged_paged_attention(q, kc, kc, np.zeros((2, 1), np.int32),
                                  np.ones(2, np.int32))
    with pytest.raises(ValueError):
        pa.paged_attention(q, kc, kc, np.zeros((2, 1), np.int32),
                           np.ones(2, np.int32))
    q = torch.zeros(2, 4, 64, device="cuda")
    big = torch.zeros(2, 4, 256, 64, device="cuda")     # block size 256
    with pytest.raises(ValueError, match="block size"):
        pa.paged_attention(q, big, big, np.zeros((2, 1), np.int32),
                           np.ones(2, np.int32))
    kc = torch.zeros(2, 4, 16, 64, device="cuda")
    with pytest.raises(ValueError):                     # not contiguous
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kc, kc, np.zeros((2, 1), np.int32),
                           np.ones(2, np.int32))
    x = torch.zeros(4, 64, device="cuda")
    pk = torch.zeros(64, 128, dtype=torch.int8, device="cuda")
    sc = torch.ones(256, device="cuda")
    with pytest.raises(ValueError):                     # scales [256], N 128
        qm.weight_only_matmul(x, pk, sc, "int8", 128)
    with pytest.raises(ValueError):                     # not contiguous
        qm.weight_only_matmul(x.t().contiguous().t(), pk, sc, "int4", 256)
    w8 = torch.zeros(64, 256, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):                     # not contiguous
        qm.weight_only_matmul(x, w8.t().contiguous().t(), sc, "int8", 256)
    flat = torch.zeros(64 * 256 + 1, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        qm.weight_only_matmul(x, flat[1:].view(64, 256), sc, "int8", 256)
    flat16 = torch.zeros(64 * 256 + 8, dtype=torch.int8, device="cuda")
    for quant, cols in (("int8", 256), ("int4", 128)):  # 8 bytes off 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            qm.weight_only_matmul(x, flat16[8:8 + 64 * cols].view(64, cols),
                                  sc, quant, 256)
    with pytest.raises(ValueError):                     # block not /128
        qm.weight_only_matmul(x, w8, sc, "int8", 64)
    with pytest.raises(ValueError):                     # dtype mismatch
        qm.weight_only_matmul(x, w8, sc, "int8", 256,
                              out_dtype=torch.bfloat16)


def _decode_case(b, h, kvh, d, bs, nb, max_nb, lens, dtype, seed):
    """q, caches and tables on the card; entries past each row's last used
    block are -1, as a real allocator may leave them."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(kvh, nb, bs, d, device="cuda", generator=gen).to(dtype)
    q = torch.randn(b, h, d, device="cuda", generator=gen).to(dtype)
    tables = np.stack([rng.choice(nb, max_nb, replace=False)
                       for _ in range(b)]).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    used = np.minimum(-(-lens // bs), max_nb)
    for i in range(b):
        tables[i, used[i]:] = -1
    return q, kc, vc, tables, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_paged_decode_kernel_matches_plain(dtype, d, g, bs):
    """ctx 0 (exact zeros), 1, a block boundary, the table's capacity and
    past it, with -1 table entries past each row's last used block; pages
    of 16 to 128 keys (one to several chunks a page), row groups of 1, 2,
    4 (with an idle row at G = 3) and several groups a kv head."""
    from paddle_tpu_torch.ops import paged_attention as pa
    kvh, max_nb = 4, 5
    cap = max_nb * bs
    lens = [0, 1, bs, cap, cap + 7, 2 * bs + 5]
    q, kc, vc, tables, lens = _decode_case(len(lens), kvh * g, kvh, d, bs,
                                           40, max_nb, lens, dtype,
                                           d + g + bs)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kc, vc, tables, lens)
    ref = pa.paged_attention_plain(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert float(out[0].float().abs().max()) == 0.0
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(ref, dtype), err


def _forced_plan(monkeypatch, pa, splits):
    """Route ``paged_attention`` through a plan of ``splits`` splits
    ("maxnb": one page a split) in place of ``decode_plan``'s; returns
    the pages per split as a function of the table width."""
    def pps(max_nb):
        s = max_nb if splits == "maxnb" else splits
        return -(-max_nb // s)

    def forced(b, h, kvh, max_nb, bs, d, dtype=None, sms=None, waves=None):
        p = pps(max_nb)
        s = -(-max_nb // p)
        return {"splits": s, "pages_per_split": p, "blocks": s * b * kvh,
                "workspace_bytes": s * b * h * (d + 2) * 4 if s > 1 else 0}

    monkeypatch.setattr(pa, "decode_plan", forced)
    return pps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, "maxnb"])
@pytest.mark.parametrize("g,bs", [(2, 16), (1, 128), (16, 64), (5, 32)])
def test_paged_decode_kernel_forced_plans_match_split_plain(
        monkeypatch, dtype, splits, g, bs):
    """One split (the direct write), two, and one page a split (the most
    partials), each against the split arithmetic at the same S and P."""
    from paddle_tpu_torch.ops import paged_attention as pa
    kvh, max_nb = 2, 6
    cap = max_nb * bs
    lens = [0, 1, bs, cap, cap + 9, 3 * bs + 5, 2 * bs - 1]
    q, kc, vc, tables, lens = _decode_case(len(lens), kvh * g, kvh, 64, bs,
                                           50, max_nb, lens, dtype, g + bs)
    pps = _forced_plan(monkeypatch, pa, splits)(max_nb)
    out = pa.paged_attention(q, kc, vc, tables, lens)
    ref = pa.paged_attention_split_plain(q, kc, vc, tables, lens,
                                         -(-max_nb // pps), pps)
    torch.cuda.synchronize()
    assert float(out[0].float().abs().max()) == 0.0
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(ref, dtype), err


@pytest.mark.parametrize("h,kvh,bs", [(16, 8, 16), (16, 1, 16),
                                      (16, 8, 128)])
def test_paged_decode_kernel_is_deterministic(h, kvh, bs):
    """The split partials are summed in split order: two calls are
    bit-equal."""
    from paddle_tpu_torch.ops import paged_attention as pa
    lens = [64, 130, 0, 200, 5, 512, 77, 300]
    q, kc, vc, tables, lens = _decode_case(8, h, kvh, 64, bs, 8 * 512 // bs
                                           + 1, 512 // bs, lens,
                                           torch.bfloat16, 41)
    assert pa.decode_plan(8, h, kvh, 512 // bs, bs, 64)["splits"] > 1
    a = pa.paged_attention(q, kc, vc, tables, lens)
    b = pa.paged_attention(q, kc, vc, tables, lens)
    assert torch.equal(a, b)


def test_paged_decode_kernel_on_a_side_stream_leaves_its_counters_zero():
    """A split launch on a non-default stream takes that stream's
    counters and leaves them zeroed; its output matches the plain
    version."""
    from paddle_tpu_torch.ops import paged_attention as pa
    lens = [300, 1, 0, 512, 17, 64, 200, 511]
    q, kc, vc, tables, lens = _decode_case(8, 16, 8, 64, 16, 257, 32, lens,
                                           torch.bfloat16, 42)
    ref = pa.paged_attention_plain(q, kc, vc, tables, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [pa.paged_attention(q, kc, vc, tables, lens)
                for _ in range(3)]
    side.synchronize()
    buf = pa._COUNTERS[(q.device.index, side.cuda_stream)]
    assert not buf.any()
    for out in outs:
        assert torch.equal(out, outs[0])
    err = float((outs[0].float() - ref.float()).abs().max())
    assert err <= _tol(ref, torch.bfloat16), err


def test_paged_decode_wrapper_refuses_an_unaligned_cache():
    from paddle_tpu_torch.ops import paged_attention as pa
    flat = torch.zeros(2 * 4 * 16 * 64 + 4, dtype=torch.bfloat16,
                       device="cuda")
    kc = flat[4:].view(2, 4, 16, 64)                    # 8 bytes off 16
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        pa.paged_attention(q, kc, kc, np.zeros((2, 1), np.int32),
                           np.ones(2, np.int32))


def test_block_multihead_attention_kernel_route_matches_plain_route():
    """The fused op on the card: the kernel route's output and caches
    against the same op with the plain attention, a row at capacity (its
    write dropped), GQA 8/2."""
    from paddle_tpu_torch.incubate.nn import functional as TF
    from paddle_tpu_torch.ops import paged_attention as pa
    b, h, kvh, d, bs, max_nb = 4, 8, 2, 64, 16, 4
    lens = np.array([0, 17, max_nb * bs, 40], np.int32)
    _, kc, vc, tables, _ = _decode_case(b, h, kvh, d, bs, 30, max_nb,
                                        [max_nb * bs] * b, torch.bfloat16, 5)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    qkv = torch.randn(b, 3, h, d, device="cuda", generator=gen).bfloat16()
    kp, vp = kc.clone(), vc.clone()
    out, k2, v2 = TF.block_multihead_attention(qkv, kc, vc, tables, lens)
    saved = pa.paged_attention
    pa.paged_attention = pa.paged_attention_plain
    try:
        ref, _, _ = TF.block_multihead_attention(qkv, kp, vp, tables, lens)
    finally:
        pa.paged_attention = saved
    torch.cuda.synchronize()
    assert k2 is kc and torch.equal(kc, kp) and torch.equal(vc, vp)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(ref, torch.bfloat16), err


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_engine_serves_widths_off_128_through_dequant(quant):
    """``LlamaConfig.tiny``'s widths on the card: lin and ffn2 (64) fit no
    kernel block, so every projection takes the dequant route and no GEMM
    kernel launches; greedy tokens equal the same engine's on the CPU
    (f32)."""
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    from paddle_tpu_torch.ops import quant_matmul as qm
    rng = np.random.default_rng(0)
    v, e, h, g, d, f, layers = 128, 64, 4, 2, 16, 128, 2

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    w = dict(ln_scales=[np.ones(e, np.float32)] * layers,
             qkv_weights=[mk(h + 2 * g, d, e) for _ in range(layers)],
             linear_weights=[mk(h * d, e) for _ in range(layers)],
             ffn_ln_scales=[np.ones(e, np.float32)] * layers,
             ffn1_weights=[mk(e, 2 * f) for _ in range(layers)],
             ffn2_weights=[mk(f, e) for _ in range(layers)],
             embedding=mk(v, e), lm_head=mk(e, v))
    kw = dict(num_heads=h, head_dim=d, max_seq_len=32, dtype="float32",
              norm_type="rmsnorm", activation="swiglu", gqa_group_size=g,
              weight_quant=quant)
    engs = [FusedMultiTransformerEngine(
        engine_weights_from_numpy(w, dev, "float32"), device=dev, **kw)
        for dev in ("cuda", "cpu")]
    assert engs[0].quant_routes == engs[1].quant_routes == dict.fromkeys(
        ("qkv", "lin", "f1", "f2"), "dequant")
    calls = []
    inner = engs[0]._kw["_mm"]

    def mm(z2d, wt, kind, li):
        calls.append(kind)
        return inner(z2d, wt, kind, li)

    mm.qkv_out = inner.qkv_out
    engs[0]._kw["_mm"] = mm
    counter = "launches" if quant == "int4" else "int8_launches"
    before = getattr(qm.weight_only_matmul, counter)
    ids = rng.integers(0, v, (2, 6)).astype(np.int32)
    got = engs[0].generate(ids, max_new_tokens=6)
    torch.cuda.synchronize()
    launched = getattr(qm.weight_only_matmul, counter) - before
    assert calls.count("lin") == calls.count("f2") == calls.count("qkv") > 0
    assert launched == 0
    np.testing.assert_array_equal(got, engs[1].generate(ids,
                                                         max_new_tokens=6))


def _flash_inputs(bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def mk(s):
        return torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)

    return mk(sq), mk(sk), mk(sk), mk(sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (130, 130, False),
                                          (64, 64, True), (37, 200, False),
                                          (200, 77, True), (197, 197, False),
                                          (1024, 77, False)])
def test_flash_kernels_match_plain(dtype, d, sq, sk, causal):
    """Forward (o, lse) and backward (dq, dk, dv from the same o / lse /
    do) at lengths on and off the 64-row tile, q and k lengths apart,
    causal (top-left) and full: ViT's 197 rows, a cross-attention's 1024
    queries against 77 keys."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(3, sq, sk, d, dtype, sq + sk + d)
    scale = d ** -0.5
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert float((o.float() - ro.float()).abs().max()) <= _tol(ro, dtype)
    assert float((lse - rlse).abs().max()) <= 1e-4
    grads = fa.flash_bwd(q, k, v, ro, rlse, do, scale, causal)
    refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)


def _flash_check(dtype, d, sq, sk, causal, seed, rope=False):
    """One forward and one backward launch against the plain versions
    (within ``_tol``; lse within 1e-4), optionally with rope tables longer
    than both lengths."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(3, sq, sk, d, dtype, seed)
    tables = _rope_tables(max(sq, sk) + 3, d) if rope else (None, None)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal, *tables)
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal, *tables)
    grads = fa.flash_bwd(q, k, v, ro, rlse, do, scale, causal, *tables)
    refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal, *tables)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    err = float((o.float() - ro.float()).abs().max())
    assert err <= _tol(ro, dtype), ("o", err)
    assert float((lse - rlse).abs().max()) <= 1e-4
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 15, 127, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_lengths_match_plain(dtype, d, s, causal):
    """The bf16 / fp16 tensor-core bodies at lengths inside one tile and
    across several, ending off the 64-key and the query tiles."""
    _flash_check(dtype, d, s, s, causal, s + d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(300, 100), (100, 300), (1000, 130),
                                   (65, 1000)])
def test_flash_tensor_core_causal_lengths_apart(dtype, d, sq, sk):
    """Causal (top-left, row >= col) with more queries than keys and
    fewer: rows past the last key see every key, tiles wholly above the
    diagonal are skipped."""
    _flash_check(dtype, d, sq, sk, True, sq * 3 + sk + d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 128])
@pytest.mark.parametrize("sq,sk,causal", [(15, 15, True), (127, 127, True),
                                          (1000, 1000, True),
                                          (300, 100, True), (100, 300, False)])
def test_flash_tensor_core_rope_lengths(dtype, d, sq, sk, causal):
    """Rope inside the tensor-core bodies at the narrowest and widest head
    dims: q rotated once per tile, each k tile after it lands, dq and dk
    counter-rotated in the accumulator layout (at head dim 16 the neox
    partner of a column sits in the other warp of a pair, and the two
    trade their values through shared memory)."""
    _flash_check(dtype, d, sq, sk, causal, sq + sk + d + 1, rope=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_dk_dv_are_deterministic(dtype, d):
    """dk and dv are summed in registers in a fixed order: two calls on the
    same inputs give the same bits. Only dq, added with atomics, may
    differ in its last bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(4, 700, 700, d, dtype, d + 11)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    first = fa.flash_bwd(q, k, v, o, lse, do, scale, True)
    second = fa.flash_bwd(q, k, v, o, lse, do, scale, True)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    assert float((first[0].float() - second[0].float()).abs().max()) \
        <= _tol(first[0], dtype)


@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_matches_plain_autograd(h, kvh, causal):
    """The autograd function (kernel forward and backward, kv heads
    repeated and their grads summed) against autograd through plain f32
    attention, grouped-query groups of 1, 2 and 4."""
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(h + kvh)
    b, s, d = 2, 150, 64
    q = torch.randn(b, s, h, d, device="cuda", generator=gen)
    k = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    v = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    g = torch.randn(b, s, h, d, device="cuda", generator=gen)
    outs = []
    for fn in (lambda *a: fa.flash_attention_bshd(*a, causal=causal),
               lambda *a: _sdpa_ref(*a, causal=causal)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        outs.append([out.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        assert got.shape == want.shape, name
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk,causal", [
    (1, 1, True), (1, 1, False), (17, 17, True), (17, 17, False),
    (4096, 77, False), (77, 4096, False), (1000, 1000, True),
    (300, 100, True)])
def test_flash_head_dim_16_matches_plain(dtype, sq, sk, causal):
    """Head dim 16 (the UNet's first level: 64 channels over 4 heads):
    one k-step of q k^T and two 8-column tiles of p v on the tensor
    cores, 2 copies a row in the loaders, the f32 route on CUDA cores; at
    one row, off the tile (17; ViT's 197 is ``test_flash_kernels_match_
    plain``'s), the cross-attention's 4096 queries against 77 keys (and
    the reverse), and causal at 1000."""
    _flash_check(dtype, 16, sq, sk, causal, sq + 2 * sk + 16)


@pytest.mark.parametrize("kdim", [None, 48])
def test_multi_head_attention_at_head_dim_16_launches_the_kernels(kdim):
    """``nn.MultiHeadAttention`` at 64 channels over 4 heads sends its
    attention to K1 / K2 (one launch each), never to the plain version,
    and agrees with the plain route (``_sdpa_ref`` under a zero mask)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    mha = nn.MultiHeadAttention(64, 4, kdim=kdim, vdim=kdim, device="cuda",
                                generator=gen)
    x = torch.randn(2, 300, 64, device="cuda", generator=gen)
    ctx = x if kdim is None else torch.randn(2, 77, kdim, device="cuda",
                                             generator=gen)
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    out = mha(x, ctx, ctx)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    zero = torch.zeros(1, 1, 1, ctx.shape[1], device="cuda")
    want = mha(x, ctx, ctx, attn_mask=zero)
    assert fa.flash_fwd.launches == f0 + 1
    err = float((out - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_flash_launch_counts_from_threads_add_up():
    """Eight threads each launch K1 and K2 ``N`` times on their own
    tensors: ``flash_fwd.launches`` and ``flash_bwd.launches`` grow by
    exactly 8 N each (the count is taken where the kernel launches,
    possibly from threads: router replicas, thread ranks)."""
    import sys
    import threading
    from paddle_tpu_torch.ops import flash_attention as fa
    n, threads = 200, 8
    inputs = [_flash_inputs(2, 64, 64, 32, torch.bfloat16, 40 + i)
              for i in range(threads)]
    o, lse = fa.flash_fwd_plain(*inputs[0][:3], 32 ** -0.5, True)
    fa.flash_fwd(*inputs[0][:3], 32 ** -0.5, True)     # built and loaded
    torch.cuda.synchronize()
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    barrier = threading.Barrier(threads)
    errors = []

    def work(i):
        try:
            q, k, v, do = inputs[i]
            barrier.wait()
            for _ in range(n):
                fa.flash_fwd(q, k, v, 32 ** -0.5, True)
                fa.flash_bwd(q, k, v, o, lse, do, 32 ** -0.5, True)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # hand the interpreter over often
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors
    assert (fa.flash_fwd.launches - f0, fa.flash_bwd.launches - b0) == (
        threads * n, threads * n)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(2, 16, 48, device="cuda")           # head dim 48
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, 1.0, True)
    q = torch.zeros(2, 16, 64, device="cuda")
    with pytest.raises(ValueError):                     # not contiguous
        fa.flash_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                     1.0, True)
    with pytest.raises(ValueError):                     # mixed dtypes
        fa.flash_fwd(q, q.half(), q.half(), 1.0, True)


def _rope_tables(s, d, base=10000.0):
    inv = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                      device="cuda") / d)
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device="cuda"),
                      inv)
    return torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s,causal", [(100, True), (64, False), (200, True)])
def test_flash_kernels_with_rope_match_plain(dtype, d, s, causal):
    """The rope operands: q and k rotated in the input dtype inside both
    kernels, dq and dk counter-rotated in f32; tables longer than S."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(3, s, s, d, dtype, s + d + 7)
    cos, sin = _rope_tables(s + 5, d)
    scale = d ** -0.5
    r0 = fa.flash_fwd.rope_launches, fa.flash_bwd.rope_launches
    o, lse = fa.flash_fwd(q, k, v, scale, causal, cos, sin)
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal, cos, sin)
    grads = fa.flash_bwd(q, k, v, ro, rlse, do, scale, causal, cos, sin)
    refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal, cos, sin)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.rope_launches, fa.flash_bwd.rope_launches) == (
        r0[0] + 1, r0[1] + 1)
    assert float((o.float() - ro.float()).abs().max()) <= _tol(ro, dtype)
    assert float((lse - rlse).abs().max()) <= 1e-4
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)


@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (8, 2)])
def test_flash_autograd_with_rope_matches_plain_autograd(h, kvh):
    """Rope inside the kernels with grouped-query groups of 1, 2 and 4
    against autograd through rotating first and plain f32 attention."""
    from paddle_tpu_torch.nn.functional import apply_rotary_pos_emb
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(h * kvh)
    b, s, d = 2, 150, 64
    q = torch.randn(b, s, h, d, device="cuda", generator=gen)
    k = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    v = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    g = torch.randn(b, s, h, d, device="cuda", generator=gen)
    cos, sin = _rope_tables(s, d)

    def ref(q_, k_, v_):
        return _sdpa_ref(apply_rotary_pos_emb(q_, cos, sin),
                         apply_rotary_pos_emb(k_, cos, sin), v_, causal=True)

    outs = []
    for fn in (lambda *a: fa.flash_attention_bshd(*a, causal=True,
                                                  rope_cos=cos, rope_sin=sin),
               ref):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        outs.append([out.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), (name, err)


def _ce_inputs(t, hid, vocab, dtype, seed, ignored):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    h = torch.randn(t, hid, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(hid, vocab, device="cuda", generator=gen)
         * hid ** -0.5).to(dtype)
    lab = torch.randint(0, vocab, (t,), device="cuda", generator=gen)
    lab[ignored] = -100
    g = torch.rand(t, device="cuda", generator=gen) + 0.5
    return h, w, lab, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hid", [64, 1024, 4096,
                                 1000, 1536,  # off the 128-wide bf16 slices
                                 8192])       # the widest cluster plan
@pytest.mark.parametrize("t,vocab,ignored", [
    (100, 300, [3, 50]),          # T and V off the tiles
    (128, 256, []),               # on the tiles
    (1000, 32001, [0, 999]),      # the forward splits the vocabulary
    (300, 100, [5]),              # one vocab tile: one split
    (70, 130, slice(None)),       # every row ignored
    (1, 1, []),                   # one token, one column
])
def test_blockwise_ce_kernels_match_plain(dtype, hid, t, vocab, ignored):
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h, w, lab, g = _ce_inputs(t, hid, vocab, dtype, t + hid + vocab, ignored)
    n0 = (bc.ce_fwd.launches, bc.ce_bwd_dh.launches, bc.ce_bwd_dw.launches)
    loss, lse = bc.ce_fwd(h, w, lab, -100)
    rloss, rlse = bc.ce_fwd_plain(h, w, lab, -100)
    dh = bc.ce_bwd_dh(h, w, lab, g, rlse, -100)
    rdh = bc.ce_bwd_dh_plain(h, w, lab, g, rlse, -100)
    dw = bc.ce_bwd_dw(h, w, lab, g, rlse, -100)
    rdw = bc.ce_bwd_dw_plain(h, w, lab, g, rlse, -100)
    torch.cuda.synchronize()
    assert (bc.ce_fwd.launches, bc.ce_bwd_dh.launches,
            bc.ce_bwd_dw.launches) == tuple(n + 1 for n in n0)
    assert dh.dtype == dw.dtype == dtype and loss.dtype == torch.float32
    ign = lab == -100
    assert not bool(loss[ign].any()) and not bool(dh[ign].any())
    for name, x, r in (("loss", loss, rloss), ("lse", lse, rlse)):
        err = float((x - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (name, err)
    for name, x, r in (("dh", dh, rdh), ("dw", dw, rdw)):
        err = float((x.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_thread_block_clusters_read_every_peers_shared_memory(c):
    """The cluster launch the bf16 CE backward rests on: clusters of c
    blocks through cudaLaunchKernelEx, each block reading every peer's
    shared memory (map_shared_rank) between two cluster barriers."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    n = 7
    out = torch.full((n * c * c,), -1, dtype=torch.int32, device="cuda")
    rc = bc._launcher("cluster_check")(
        c, n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = torch.tensor([[1000 * (b // c) + q for q in range(c)]
                         for b in range(n * c)], dtype=torch.int32)
    assert torch.equal(out.cpu().view(n * c, c), want)


@pytest.mark.parametrize("dtype,hid,route", [
    (torch.bfloat16, 64, "cluster"), (torch.bfloat16, 1000, "cluster"),
    (torch.bfloat16, 1024, "cluster"), (torch.bfloat16, 1536, "cluster"),
    (torch.bfloat16, 4096, "cluster"), (torch.bfloat16, 8192, "cluster"),
    (torch.bfloat16, 8200, "workspace"),     # wider than the plan holds
    (torch.float32, 1024, "workspace"), (torch.float16, 1024, "workspace"),
])
def test_blockwise_ce_backward_route_is_pinned_by_dtype_and_width(
        dtype, hid, route):
    """bf16 up to H = 8192 runs the cluster kernel; wider bf16, f32 and
    f16 run the workspace bodies. The route is chosen before launch, the
    plan comes from the kernels' source, and either route matches plain."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    t, vocab = 70, 300
    h, w, lab, g = _ce_inputs(t, hid, vocab, dtype, hid, [2])
    _, lse = bc.ce_fwd_plain(h, w, lab, -100)
    dh = bc.ce_bwd_dh(h, w, lab, g, lse, -100)
    dw = bc.ce_bwd_dw(h, w, lab, g, lse, -100)
    rdh = bc.ce_bwd_dh_plain(h, w, lab, g, lse, -100)
    rdw = bc.ce_bwd_dw_plain(h, w, lab, g, lse, -100)
    torch.cuda.synchronize()
    assert bc.ce_bwd_dh.route == bc.ce_bwd_dw.route == route
    plan = bc.bwd_plan(t, hid, vocab)
    assert plan["route"] == (hid <= 8192)
    if plan["route"]:
        assert plan["cluster"] == min(8, 1 << (-(-hid // 128) - 1).bit_length())
        assert plan["slice"] * plan["cluster"] >= hid
        assert plan["dh_max_active_clusters"] > 0
        assert plan["dw_max_active_clusters"] > 0
    for x, r in ((dh, rdh), (dw, rdw)):
        assert float((x.float() - r.float()).abs().max()) <= _tol(r, dtype)


def test_blockwise_ce_bf16_backward_allocates_no_workspace():
    """The bf16 dh and dw allocate their output and nothing else (the
    workspace bodies would take 16 MB and 131 MB here)."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h, w, lab, g = _ce_inputs(2048, 1024, 32000, torch.bfloat16, 11, [9])
    _, lse = bc.ce_fwd_plain(h, w, lab, -100)
    for fn, like in ((bc.ce_bwd_dh, h), (bc.ce_bwd_dw, w)):
        fn(h, w, lab, g, lse, -100)               # build, plan, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(h, w, lab, g, lse, -100)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert fn.route == "cluster"
        assert out.shape == like.shape and out.dtype == torch.bfloat16
        assert extra <= out.numel() * out.element_size() + 2 ** 20, extra


def test_blockwise_ce_autograd_takes_a_transposed_head():
    """The op on the card: a tied head's [H, V] view of the [V, H] table,
    gradients against the plain versions."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h, w, lab, g = _ce_inputs(300, 256, 1000, torch.float32, 1, [7])
    table = w.t().contiguous().requires_grad_(True)
    hl = h.clone().requires_grad_(True)
    loss = bc.blockwise_lm_head_ce(hl, table.t(), lab)
    (loss * g).sum().backward()
    rloss, rlse = bc.ce_fwd_plain(h, w, lab, -100)
    rdh = bc.ce_bwd_dh_plain(h, w, lab, g, rlse, -100)
    rdw = bc.ce_bwd_dw_plain(h, w, lab, g, rlse, -100)
    torch.cuda.synchronize()
    assert float((loss.detach() - rloss).abs().max()) <= 1e-4
    assert float((hl.grad - rdh).abs().max()) <= _tol(rdh, torch.float32)
    assert float((table.grad - rdw.t()).abs().max()) <= _tol(rdw,
                                                             torch.float32)


def test_blockwise_ce_wrappers_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h = torch.zeros(8, 64, device="cuda")
    w = torch.zeros(64, 100, device="cuda")
    lab = torch.zeros(8, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):                     # mixed dtypes
        bc.ce_fwd(h, w.bfloat16(), lab, -100)
    with pytest.raises(ValueError):                     # int32 labels
        bc.ce_fwd(h, w, lab.int(), -100)
    with pytest.raises(ValueError):                     # not contiguous
        bc.ce_fwd(h, w.t().contiguous().t(), lab, -100)
    with pytest.raises(ValueError):                     # float64
        bc.ce_bwd_dw(h.double(), w.double(), lab, torch.zeros(8, device="cuda"),
                     torch.zeros(8, device="cuda"), -100)


def _flashmask_bounds(kind, b, mh, s, seed):
    """[B, MH, S] int32 (sr, er) of one mask kind: ``document`` (causal
    packed documents: column j masks the rows past its document),
    ``random`` (a seeded 2-column interval per column), ``dead`` (columns
    below 64 masked for every row, so the first rows see nothing) and
    ``live`` (empty intervals: plain causal attention)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        sr = rng.integers(0, s + 1, (b, mh, s))
        er = sr + rng.integers(0, s // 2 + 1, (b, mh, s))
    elif kind == "document":
        sr = np.empty((b, mh, s), np.int64)
        for i in range(b):
            ends = np.cumsum(rng.integers(8, max(9, s // 3), s))
            ends = np.minimum(ends[: np.searchsorted(ends, s) + 1], s)
            sr[i] = ends[np.searchsorted(ends, np.arange(s), side="right")]
        er = np.full_like(sr, s)
    elif kind == "dead":
        sr = np.where(np.arange(s) < 64, 0, s)[None, None].repeat(b, 0) \
            .repeat(mh, 1)
        er = np.full_like(sr, s)
    else:
        sr = np.full((b, mh, s), s)
        er = sr.copy()
    return (torch.as_tensor(sr.astype(np.int32)).cuda(),
            torch.as_tensor(np.minimum(er, 2 ** 31 - 1).astype(np.int32))
            .cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [64, 200, 1024])
@pytest.mark.parametrize("kind,mh,causal", [("document", 1, True),
                                            ("random", 3, False),
                                            ("dead", 1, True),
                                            ("live", 3, True)])
def test_flashmask_kernels_match_plain(dtype, d, s, kind, mh, causal):
    """Forward (o, lse) and backward (dq, dk, dv from the plain o / lse /
    do) of the FlashMask kernels against the plain versions, 3 heads over
    1 or 3 mask heads. Rows that see nothing: o, dq exactly 0, lse -1e30,
    and the columns no row sees get exactly zero dk / dv. Empty intervals
    give plain causal flash attention."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    q, k, v, do = _flash_inputs(3, s, s, d, dtype, s + d + mh)
    sr, er = _flashmask_bounds(kind, 1, mh, s, s + d)
    scale = d ** -0.5
    n0 = (fm.flashmask_fwd.launches, fm.flashmask_bwd.dq_launches,
          fm.flashmask_bwd.dkv_launches)
    o, lse = fm.flashmask_fwd(q, k, v, sr, er, scale, causal)
    ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
    grads = fm.flashmask_bwd(q, k, v, ro, rlse, do, sr, er, scale, causal)
    refs = fm.flashmask_bwd_plain(q, k, v, ro, rlse, do, sr, er, scale,
                                  causal)
    torch.cuda.synchronize()
    assert (fm.flashmask_fwd.launches, fm.flashmask_bwd.dq_launches,
            fm.flashmask_bwd.dkv_launches) == tuple(n + 1 for n in n0)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert float((o.float() - ro.float()).abs().max()) <= _tol(ro, dtype)
    assert float((lse - rlse).abs().max()) <= 1e-4
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)
    if kind == "dead":
        assert not bool(o[:, :64].any()) and not bool(grads[0][:, :64].any())
        assert not bool(grads[1][:, :64].any())
        assert not bool(grads[2][:, :64].any())
        assert bool((lse[:, :64] == -1e30).all())
    if kind == "live":
        fo, flse = fa.flash_fwd_plain(q.float(), k.float(), v.float(), scale,
                                      True)
        assert float((ro.float() - fo).abs().max()) <= _tol(fo, dtype)


def _dense_flashmask(q, k, v, sr, er, causal):
    """Autograd reference in f32 over [B, S, H, D] with [B, MH, S] bounds,
    kv heads and mask heads repeated up to H."""
    b, s, h, d = q.shape
    k = torch.repeat_interleave(k, h // k.shape[2], dim=2)
    v = torch.repeat_interleave(v, h // v.shape[2], dim=2)
    sr = torch.repeat_interleave(sr, h // sr.shape[1], dim=1)
    er = torch.repeat_interleave(er, h // er.shape[1], dim=1)
    rows = torch.arange(s, device=q.device)[:, None]
    vis = ~((rows >= sr[:, :, None, :]) & (rows < er[:, :, None, :]))
    if causal:
        vis &= rows >= torch.arange(s, device=q.device)[None, :]
    logits = torch.einsum("bshd,bthd->bhst", q, k) * d ** -0.5
    p = torch.softmax(logits.masked_fill(~vis, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v)


@pytest.mark.parametrize("h,kvh,mh", [(8, 8, 1), (8, 4, 4), (8, 2, 8),
                                      (8, 2, 1)])
@pytest.mark.parametrize("two_col", [False, True])
def test_flashmask_autograd_matches_plain_autograd(h, kvh, mh, two_col):
    """The [B, S, H, D] entry (kernel forward and backward, kv heads
    repeated and their grads summed, mask heads read in the kernel, int64
    indices cast) against autograd through a dense f32 mask."""
    from paddle_tpu_torch.ops import flashmask as fm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(h + kvh + mh)
    b, s, d = 2, 150, 64
    q = torch.randn(b, s, h, d, device="cuda", generator=gen)
    k = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    v = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
    g = torch.randn(b, s, h, d, device="cuda", generator=gen)
    sr, er = _flashmask_bounds("document", b, mh, s, mh)
    if two_col:                  # the document's rows reopen 40 rows later
        er = torch.minimum(sr + 40, torch.full_like(sr, s))
    idx = (torch.stack([sr, er], -1) if two_col else sr[..., None]).long()
    outs = []
    for fn in (lambda *a: fm.flashmask_attention_bshd(*a, idx, causal=True),
               lambda *a: _dense_flashmask(*a, sr, er, True)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        outs.append([out.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        assert got.shape == want.shape, name
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (130, 130, False),
                                          (37, 200, False), (200, 77, True)])
def test_flash_bwd_twopass_matches_plain(dtype, d, sq, sk, causal):
    """The two-pass backward (the no-interval instantiation of the
    FlashMask backward kernels) against ``flash_bwd_plain``, its plain
    version, from the same o / lse / do."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(3, sq, sk, d, dtype, sq + sk + d + 1)
    scale = d ** -0.5
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal)
    n0 = fa.flash_bwd_twopass.dq_launches, fa.flash_bwd_twopass.dkv_launches
    grads = fa.flash_bwd_twopass(q, k, v, ro, rlse, do, scale, causal)
    refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_twopass.dq_launches,
            fa.flash_bwd_twopass.dkv_launches) == (n0[0] + 1, n0[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)


def test_flashmask_wrappers_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    q = torch.zeros(4, 16, 64, device="cuda")
    sr = torch.zeros(2, 1, 16, dtype=torch.int32, device="cuda")
    fm.flashmask_fwd(q, q, q, sr, sr, 1.0, True)
    with pytest.raises(ValueError):                     # int64 bounds
        fm.flashmask_fwd(q, q, q, sr.long(), sr.long(), 1.0, True)
    with pytest.raises(ValueError):                     # [B, MH, Sk + 1]
        bad = torch.zeros(2, 1, 17, dtype=torch.int32, device="cuda")
        fm.flashmask_fwd(q, q, q, bad, bad, 1.0, True)
    with pytest.raises(ValueError):                     # H = 2, MH = 3
        bad = torch.zeros(2, 3, 16, dtype=torch.int32, device="cuda")
        fm.flashmask_fwd(q, q, q, bad, bad, 1.0, True)
    with pytest.raises(ValueError):                     # bounds on the CPU
        fm.flashmask_fwd(q, q, q, sr.cpu(), sr.cpu(), 1.0, True)
    q48 = torch.zeros(4, 16, 48, device="cuda")         # head dim 48
    with pytest.raises(ValueError):
        fm.flashmask_fwd(q48, q48, q48, sr, sr, 1.0, True)
    o, lse = fm.flashmask_fwd(q, q, q, sr, sr, 1.0, True)
    with pytest.raises(ValueError):                     # lse of another shape
        fm.flashmask_bwd(q, q, q, o, lse[:, :8], o, sr, sr, 1.0, True)
    with pytest.raises(ValueError):                     # mixed dtypes
        fm.flashmask_bwd(q, q, q, o.half(), lse, o, sr, sr, 1.0, True)
    x = torch.zeros(2, 16, 2, 64, device="cuda")
    with pytest.raises(ValueError):                     # a float index
        fm.flashmask_attention_bshd(x, x, x, torch.zeros(2, 1, 16, 1,
                                                         device="cuda"))
    with pytest.raises(ValueError):                     # 3 columns
        fm.flashmask_attention_bshd(x, x, x, torch.zeros(
            2, 1, 16, 3, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):                     # mixed dtypes
        fa.flash_bwd_twopass(q, q, q, o.half(), lse, o, 1.0, True)


def _fm_grads(mode, q, k, v, do, sr, er, causal):
    """(grads, refs) of one backward call of ``mode`` ("flashmask" or
    "twopass") from the plain forward's o / lse, beside the plain
    backward."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask as fm
    scale = q.shape[-1] ** -0.5
    if mode == "flashmask":
        ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
        grads = fm.flashmask_bwd(q, k, v, ro, rlse, do, sr, er, scale,
                                 causal)
        refs = fm.flashmask_bwd_plain(q, k, v, ro, rlse, do, sr, er, scale,
                                      causal)
    else:
        ro, rlse = fa.flash_fwd_plain(q, k, v, scale, causal)
        grads = fa.flash_bwd_twopass(q, k, v, ro, rlse, do, scale, causal)
        refs = fa.flash_bwd_plain(q, k, v, ro, rlse, do, scale, causal)
    torch.cuda.synchronize()
    return grads, refs


def _fm_check(grads, refs, dtype, gate=False):
    """Each gradient within ``_tol`` of its plain version; ``gate`` also
    holds bf16 FlashMask gradients to the smoke's per-element gate
    (``FLASH_GRAD_ATOL`` plus two bf16 ulps of |ref|)."""
    import chip_smoke as cs
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), (name, err)
        if gate:
            err, ratio = cs.bf16_agreement(g, r, cs.FLASH_GRAD_ATOL)
            assert ratio <= 1.0, (name, err, ratio)


@pytest.mark.parametrize("mode", ["flashmask", "twopass"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flashmask_backward_is_bitwise_reproducible(mode, dtype, d):
    """dq (no atomics) and dk / dv (the two query halves summed in a fixed
    order) give the same bits over two calls, in both modes."""
    q, k, v, do = _flash_inputs(4, 700, 700, d, dtype, d + 13)
    sr, er = _flashmask_bounds("document", 2, 1, 700, d)
    first, _ = _fm_grads(mode, q, k, v, do, sr, er, True)
    second, _ = _fm_grads(mode, q, k, v, do, sr, er, True)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [65, 127, 129, 2000])
@pytest.mark.parametrize("kind,mh,causal", [("document", 1, True),
                                            ("random", 3, False)])
def test_flashmask_backward_at_the_tile_edges(dtype, s, kind, mh, causal):
    """The tensor-core backward at lengths one past, one short of and just
    over the 64-row tiles, and at S=2000: rows and keys past S are
    zero-filled and masked."""
    q, k, v, do = _flash_inputs(3, s, s, 64, dtype, s + mh)
    sr, er = _flashmask_bounds(kind, 1, mh, s, s)
    grads, refs = _fm_grads("flashmask", q, k, v, do, sr, er, causal)
    _fm_check(grads, refs, dtype, gate=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq,sk", [(65, 129), (129, 65), (2000, 127),
                                   (127, 2000)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_twopass_at_the_tile_edges(dtype, sq, sk, causal):
    """The two-pass backward (one rounded part of p and ds) with query and
    key lengths apart, off the 64-row tiles."""
    q, k, v, do = _flash_inputs(3, sq, sk, 64, dtype, sq + 2 * sk)
    grads, refs = _fm_grads("twopass", q, k, v, do, None, None, causal)
    _fm_check(grads, refs, dtype)


def test_flashmask_backward_bf16_d128_over_half_the_mask_heads():
    """bf16 at D=128 (one block of 8 warps an SM) with MH = H / 2: heads
    2 i and 2 i + 1 read mask head i."""
    q, k, v, do = _flash_inputs(2 * 8, 300, 300, 128, torch.bfloat16, 128)
    sr, er = _flashmask_bounds("document", 2, 4, 300, 4)
    grads, refs = _fm_grads("flashmask", q, k, v, do, sr, er, True)
    _fm_check(grads, refs, torch.bfloat16, gate=True)


def test_flashmask_backward_band_with_every_tile_live():
    """A band of masked rows [j + a, j + a + w) with a < 64: every causal
    (q tile, k tile) pair is live, so nothing is skipped and each tile
    takes the per-element interval test."""
    import chip_smoke as cs
    s, h = 1024, 4
    rng = np.random.default_rng(5)
    j = np.arange(s)
    sr_np = (j + rng.integers(1, 64, (1, h, s))).astype(np.int32)
    er_np = (sr_np + rng.integers(0, 200, (1, h, s))).astype(np.int32)
    _, live, tri, _ = cs.flashmask_work(sr_np, er_np, h, s, True, 64)
    assert live == tri
    sr, er = (torch.as_tensor(x).cuda() for x in (sr_np, er_np))
    q, k, v, do = _flash_inputs(h, s, s, 64, torch.bfloat16, 7)
    grads, refs = _fm_grads("flashmask", q, k, v, do, sr, er, True)
    _fm_check(grads, refs, torch.bfloat16, gate=True)


@pytest.mark.parametrize("do_scale", [1.0 / 64, 64.0])
def test_flashmask_backward_fp16_small_and_large_ds(do_scale):
    """fp16 parts of ds lose bits below 2**-14 (subnormal) and would
    overflow past 65504: an upstream gradient 64 times smaller (|ds| far
    below 2**-14) and 64 times larger (|ds| up to the hundreds) both hold
    the plain version's tolerance."""
    s = 500
    q, k, v, do = _flash_inputs(3, s, s, 64, torch.float16, 17)
    do = (do.float() * do_scale).half()
    sr, er = _flashmask_bounds("random", 1, 1, s, 3)
    grads, refs = _fm_grads("flashmask", q, k, v, do, sr, er, False)
    _fm_check(grads, refs, torch.float16)


@pytest.mark.parametrize("mode,dtype,route", [
    (0, torch.float32, ("cuda-core", 0)), (1, torch.float32, ("cuda-core", 0)),
    (0, torch.bfloat16, ("tensor-core", 2)),
    (1, torch.bfloat16, ("tensor-core", 1)),
    (0, torch.float16, ("tensor-core", 2)),
    (1, torch.float16, ("tensor-core", 1))])
def test_flashmask_backward_names_its_route(mode, dtype, route):
    """The library reports the body each mode and dtype launch: f32 on the
    CUDA cores, 16-bit on the tensor cores with two parts of p and ds
    (FlashMask) or one rounded part (two-pass)."""
    from paddle_tpu_torch.ops import flashmask as fm
    assert fm.bwd_route(mode, dtype) == route


def _fm_fwd_check(q, k, v, sr, er, causal, gate):
    """The forward kernel's (o, lse) against the plain version: o within
    ``_tol``, lse within 1e-4, and with ``gate`` (bf16) each element of o
    within the smoke's gate (``FM_O_ATOL`` plus two bf16 ulps of |ref|).
    Returns (o, lse)."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flashmask as fm
    scale = q.shape[-1] ** -0.5
    n0 = fm.flashmask_fwd.launches
    o, lse = fm.flashmask_fwd(q, k, v, sr, er, scale, causal)
    ro, rlse = fm.flashmask_fwd_plain(q, k, v, sr, er, scale, causal)
    torch.cuda.synchronize()
    assert fm.flashmask_fwd.launches == n0 + 1
    assert o.dtype == q.dtype and bool(torch.isfinite(o).all())
    assert float((o.float() - ro.float()).abs().max()) <= _tol(ro, q.dtype)
    assert float((lse - rlse).abs().max()) <= 1e-4
    if gate:
        err, ratio = cs.bf16_agreement(o, ro, cs.FM_O_ATOL)
        assert ratio <= 1.0, (err, ratio)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 129, 2000])
@pytest.mark.parametrize("kind,mh,causal", [("document", 1, True),
                                            ("random", 3, False)])
def test_flashmask_forward_tensor_cores_at_the_tile_edges(dtype, d, s, kind,
                                                          mh, causal):
    """The tensor-core forward (p in FM_FWD_PARTS exact parts) at every
    head dim, at lengths off the 64-row tiles, causal documents and
    non-causal intervals."""
    q, k, v, _ = _flash_inputs(3, s, s, d, dtype, s + d + mh)
    sr, er = _flashmask_bounds(kind, 1, mh, s, s + d)
    _fm_fwd_check(q, k, v, sr, er, causal, gate=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,mh", [(8, 2), (8, 4), (6, 1)])
def test_flashmask_forward_gqa_mask_heads(dtype, d, h, mh):
    """Heads h read mask head h // (H / MH) in the forward: two batch rows
    of H heads over MH mask heads, each mask head its own documents."""
    q, k, v, _ = _flash_inputs(2 * h, 300, 300, d, dtype, h + mh + d)
    sr, er = _flashmask_bounds("document", 2, mh, 300, mh + d)
    _fm_fwd_check(q, k, v, sr, er, True, gate=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [100, 1024])
def test_flashmask_forward_rows_that_see_nothing(dtype, d, s):
    """Columns below 64 masked for every row: rows 0-63 see nothing (their
    only causal tile is dead), o is exactly 0 and lse exactly -1e30."""
    q, k, v, _ = _flash_inputs(3, s, s, d, dtype, s + d)
    sr, er = _flashmask_bounds("dead", 1, 1, s, 0)
    o, lse = _fm_fwd_check(q, k, v, sr, er, True,
                           gate=dtype == torch.bfloat16)
    assert not bool(o[:, :64].any())
    assert bool((lse[:, :64] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flashmask_forward_band_with_every_tile_live(dtype):
    """Bands [j + a, j + a + w) with a < 64 leave every causal tile live,
    each with the per-element interval test, and a non-causal interval
    mask beside it."""
    import chip_smoke as cs
    s, h = 1024, 4
    rng = np.random.default_rng(9)
    j = np.arange(s)
    sr_np = (j + rng.integers(1, 64, (1, h, s))).astype(np.int32)
    er_np = (sr_np + rng.integers(0, 200, (1, h, s))).astype(np.int32)
    _, live, tri, _ = cs.flashmask_work(sr_np, er_np, h, s, True, 64)
    assert live == tri
    sr, er = (torch.as_tensor(x).cuda() for x in (sr_np, er_np))
    q, k, v, _ = _flash_inputs(h, s, s, 64, dtype, 11)
    for causal in (True, False):
        _fm_fwd_check(q, k, v, sr, er, causal, gate=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype,route", [
    (torch.float32, ("cuda-core", 0)), (torch.bfloat16, ("tensor-core", 2)),
    (torch.float16, ("tensor-core", 2))])
def test_flashmask_forward_names_its_route(dtype, route):
    """The library reports the forward body each dtype launches: f32 on
    the CUDA cores, 16-bit on the tensor cores with p in two exact parts."""
    from paddle_tpu_torch.ops import flashmask as fm
    assert fm.fwd_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,hid,vocab,route", [
    (128, 1024, 256, "wgmma"),              # on the tiles
    (130, 1024, 32000, "wgmma"),            # T off the 128-token tile
    (1000, 1000, 32001, "wgmma-pitched"),   # V odd, H % 64 != 0
    (257, 96, 200, "wgmma"),                # V below one 256-column tile
    (70, 100, 300, "wgmma-pitched"),        # H % 8 != 0: h copied
    (33, 36, 77, "wgmma-pitched"),          # both copied, one stage of H
    (1, 8, 1, "wgmma-pitched"),             # one token, one column
])
def test_blockwise_ce_forward_wgmma_routes_and_edges(dtype, t, hid, vocab,
                                                      route):
    """The 16-bit forward on wgmma: the route is chosen from the shapes
    before launch (rows of h and w that do not start on 16 bytes read a
    padded copy), and loss / lse match plain, with labels outside [0, V)
    that are not ignored (no gold logit: loss = lse) and ignored rows."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h, w, lab, _ = _ce_inputs(t, hid, vocab, dtype, t + hid + vocab, [0])
    if t > 2:
        lab[1] = vocab + 5                  # past V, not ignored
        lab[2] = -3
    plan = bc.fwd_plan(t, hid, vocab, dtype)
    assert plan["route"] == route
    assert plan["tile_tokens"] == 128 and plan["tile_vocab"] == 256
    loss, lse = bc.ce_fwd(h, w, lab, -100)
    rloss, rlse = bc.ce_fwd_plain(h, w, lab, -100)
    torch.cuda.synchronize()
    assert bc.ce_fwd.route == route
    err = max(float((loss - rloss).abs().max()),
              float((lse - rlse).abs().max()))
    assert err <= cs.CE_LOSS_ATOL, err
    assert float(loss[0]) == 0.0
    if t > 2:
        assert float((loss[1:3] - lse[1:3]).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_blockwise_ce_forward_every_row_ignored(dtype):
    """Every row ignored: loss is exactly 0 and lse is still each row's."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    h, w, lab, _ = _ce_inputs(300, 1024, 5000, dtype, 3, slice(None))
    loss, lse = bc.ce_fwd(h, w, lab, -100)
    _, rlse = bc.ce_fwd_plain(h, w, lab, -100)
    torch.cuda.synchronize()
    assert not bool(loss.any())
    assert float((lse - rlse).abs().max()) <= 1e-4


def test_blockwise_ce_forward_takes_a_misaligned_view():
    """A w that starts 2 bytes past a 16-byte boundary (a view into a
    larger buffer) is copied onto one before TMA reads it."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    t, hid, vocab = 200, 256, 1024
    h, w, lab, _ = _ce_inputs(t, hid, vocab, torch.bfloat16, 5, [])
    buf = torch.empty(hid * vocab + 1, dtype=torch.bfloat16, device="cuda")
    wv = buf[1:].view(hid, vocab)
    wv.copy_(w)
    assert wv.data_ptr() % 16 != 0
    loss, lse = bc.ce_fwd(h, wv, lab, -100)
    rloss, rlse = bc.ce_fwd_plain(h, w, lab, -100)
    torch.cuda.synchronize()
    assert float((loss - rloss).abs().max()) <= 1e-4
    assert float((lse - rlse).abs().max()) <= 1e-4


@pytest.mark.parametrize("t,vocab", [(16384, 32000), (1000, 32001),
                                     (2048, 32000), (64, 50257)])
def test_blockwise_ce_forward_plan_fills_whole_waves(t, vocab):
    """The wgmma forward's split count: blocks of (128-token tile, split)
    whose longest queue (vocab tiles plus a quarter tile a block) is the
    shortest any split count gives on this card, with no split left
    without a tile."""
    from paddle_tpu_torch.ops import blockwise_ce as bc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bc.fwd_plan(t, 1024, vocab)
    tt, nv = -(-t // 128), -(-vocab // 256)

    def queue(s):
        tps = -(-nv // s)
        used = -(-nv // tps)
        return -(-tt * used // sms) * (4 * tps + 1)

    assert plan["tiles_per_split"] == -(-nv // plan["splits"])
    assert queue(plan["splits"]) == min(queue(s) for s in range(1, nv + 1))
    assert plan["blocks"] == tt * -(-nv // plan["tiles_per_split"])
    assert plan["stages"] == 4


# -- the training step's fused tier (kernels A-D) ---------------------------

def _ulp(t):
    """One unit in the last place of |t| in t's dtype, per element."""
    mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}[
        t.dtype]
    return (t.float().abs().clamp_min(2.0 ** -126).log2().floor()
            - mant).exp2()


def _two_ulps(out, ref, atol=0.0):
    """Largest |out - ref| over atol (a number or a tensor) + 2 units in
    the last place of |ref| in out's dtype (both sides round the same f32
    value once)."""
    err = (out.float() - ref.float()).abs()
    return float((err / (atol + 2 * _ulp(ref.to(out.dtype)))).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("r,h", [(1, 8), (7, 1000), (33, 8200), (130, 64),
                                 (3000, 13)])
@pytest.mark.parametrize("bias,res,f32_out", [
    (False, False, False), (True, True, False), (False, True, True)])
def test_fused_norm_kernel_matches_plain(dtype, r, h, bias, res, f32_out):
    """Kernel A forward and backward at row counts and widths off the
    block and off 8, with and without bias / residual, and the f32 output
    of fused_rms_norm's rule; two calls bit-equal."""
    from paddle_tpu_torch.ops import fused_norm as fn
    gen = torch.Generator(device="cuda").manual_seed(r + h)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    od = torch.float32 if f32_out and dtype != torch.float32 else dtype
    x, w = rnd(r, h), 1 + 0.1 * rnd(h, dt=torch.float32)
    b = rnd(h) if bias else None
    rr = rnd(r, h) if res else None
    out, hh, inv = fn.rms_norm_fwd(x, w, 1e-6, b, rr, od)
    again = fn.rms_norm_fwd(x, w, 1e-6, b, rr, od)
    ref = fn.rms_norm_fwd_plain(x, w, 1e-6, b, rr, od)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip((out, hh, inv), again))
    assert out.dtype == od
    # with an f32 output, round(h * inv) flipping one unit of the
    # activation's dtype (inv's last bit) shows as that unit times |w|
    n = (ref[1].float() * ref[2][:, None]).to(dtype)
    extra = _ulp(n) * w.abs() if od != dtype else 0.0
    assert _two_ulps(out, ref[0], 1e-6 + extra) <= 1
    assert torch.equal(hh, ref[1])
    assert _two_ulps(inv, ref[2], 1e-6) <= 1
    dout, dres = rnd(r, h, dt=od), rnd(r, h) if b is not None or res \
        else None
    dh, dw = fn.rms_norm_bwd(dout, dres, hh, w, inv, od)
    dh2, dw2 = fn.rms_norm_bwd(dout, dres, hh, w, inv, od)
    rdh, rdw = fn.rms_norm_bwd_plain(dout, dres, hh, w, inv, od)
    torch.cuda.synchronize()
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    # dh + dres rounds twice on both sides: where the sum cancels, the
    # norm's part may differ by its own ulp
    extra = 0.0 if dres is None else 2 * _ulp(
        fn.rms_norm_bwd_plain(dout, None, hh, w, inv, od)[0])
    assert _two_ulps(dh, rdh, 1e-6 + extra) <= 1
    assert _two_ulps(dw, rdw, 1e-5 * float(rdw.abs().max())) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("r,im", [(1, 1), (5, 7), (9, 8), (300, 1000),
                                  (64, 2816)])
@pytest.mark.parametrize("form", ["fused", "two", "strided"])
def test_swiglu_kernel_matches_plain(dtype, r, im, form):
    """Kernel B forward and backward: the fused halves read in place, two
    tensors, and row strides wider than the rows."""
    from paddle_tpu_torch.ops import swiglu as sw
    gen = torch.Generator(device="cuda").manual_seed(r * im)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    if form == "fused":
        gu = rnd(r, 2 * im)
        g, u = gu[:, :im], gu[:, im:]
    elif form == "two":
        g, u = rnd(r, im), rnd(r, im)
    else:
        g, u = rnd(r, im + 5)[:, 3:3 + im], rnd(r, im + 8)[:, :im]
    out = sw.swiglu_fwd(g, u)
    ref = sw.swiglu_fwd_plain(g, u)
    dout = rnd(r, im)
    grads = []
    for fn in (sw.swiglu_bwd, sw.swiglu_bwd, sw.swiglu_bwd_plain):
        dgu = torch.zeros(r, 2 * im + 3, dtype=dtype, device="cuda")
        fn(dout, g, u, dgu[:, :im], dgu[:, im + 3:])
        grads.append(dgu)
    torch.cuda.synchronize()
    assert _two_ulps(out, ref, 1e-6) <= 1
    assert torch.equal(grads[0], grads[1])
    assert _two_ulps(grads[0], grads[2], 1e-6) <= 1
    assert (grads[0][:, im:im + 3] == 0).all()        # the gap untouched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,v", [(1, 1), (5, 7), (64, 32001), (3, 8),
                                 (1030, 4096)])
@pytest.mark.parametrize("smooth", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_token_ce_kernel_matches_plain(dtype, n, v, smooth, reduction):
    """Kernel C forward (rows, stats, totals) and backward for each
    reduction, with ignored rows and a label outside [0, V) (NaN loss, no
    one-hot), at vocabularies off 8 and rows off any block."""
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator(device="cuda").manual_seed(n + v)
    x = (3 * torch.randn(n, v, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(0, v, (n,), generator=gen, device="cuda")
    lab[::3] = -100
    if n > 1:
        lab[1] = v + 2
    loss, stats, totals = tc.token_ce_fwd(x, lab, -100, smooth)
    again = tc.token_ce_fwd(x, lab, -100, smooth)
    rl, rs, rt = tc.token_ce_fwd_plain(x, lab, -100, smooth)
    torch.cuda.synchronize()
    assert all(torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
               for a, b in zip((loss, stats, totals), again))
    assert torch.equal(loss.isnan(), rl.isnan())
    keep = ~rl.isnan()
    assert _two_ulps(loss[keep], rl[keep], 1e-5) <= 1
    assert torch.equal(stats[:, 0], rs[:, 0])
    assert _two_ulps(stats[:, 1], rs[:, 1], 1e-3) <= 1
    g = torch.randn(n, generator=gen, device="cuda") \
        if reduction == "none" else torch.tensor(0.7, device="cuda")
    dx = tc.token_ce_bwd(x, lab, rs, g, rt, -100, smooth, reduction)
    rdx = tc.token_ce_bwd_plain(x, lab, rs, g, rt, -100, smooth, reduction)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _two_ulps(dx, rdx, 2.0 ** -22 * float(rdx.abs().max())) <= 1
    assert (dx[::3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("v", [1, 7, 1001, 16000, 16001, 50257])
@pytest.mark.parametrize("ignored", ["some", "all"])
def test_token_ce_sharded_form_matches_plain(dtype, v, ignored):
    """Kernel C's vocab-sharded form on a shard of V_r = v columns at
    start = 3 v: the forward's row partials (on the route its plan names)
    and the backward with the shard's offset against their plain
    versions, with labels at start - 1, start, start + V_r - 1 and start
    + V_r, labels elsewhere in the vocabulary, and some or all rows
    ignored."""
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator(device="cuda").manual_seed(v + 11)
    n, start = 37, 3 * v
    x = (2 * torch.randn(n, v, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(0, 8 * v, (n,), generator=gen, device="cuda")
    lab[:4] = torch.tensor([start - 1, start, start + v - 1, start + v])
    if ignored == "all":
        lab[:] = -100
    else:
        lab[5::3] = -100
    part = tc.token_ce_fwd_partial(x, lab, start)
    again = tc.token_ce_fwd_partial(x, lab, start)
    ref = tc.token_ce_fwd_partial_plain(x, lab, start)
    torch.cuda.synchronize()
    assert tc.token_ce_fwd_partial.route == tc.fwd_plan(n, v, dtype)["route"]
    assert torch.equal(part, again)
    assert torch.equal(part[:, 0], ref[:, 0])              # the max
    assert torch.equal(part[:, 2], ref[:, 2])              # the gold logit
    assert _two_ulps(part[:, 1], ref[:, 1], 1e-2) <= 1     # the exp-sum
    inr = (lab >= start) & (lab < start + v)
    assert bool((part[~inr, 2] == 0).all())
    stats = ref[:, :2].contiguous()
    g = torch.randn(n, generator=gen, device="cuda")
    dx = tc.token_ce_bwd(x, lab, stats, g, None, -100, 0.0, "none", start)
    rdx = tc.token_ce_bwd_plain(x, lab, stats, g, None, -100, 0.0, "none",
                                start)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _two_ulps(dx, rdx, 2.0 ** -22 * max(float(rdx.abs().max()),
                                               1e-30)) <= 1
    assert bool((dx[lab == -100] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [8, 1000, 1001, 1024, 4096])
@pytest.mark.parametrize("r", [1, 7, 16383])
@pytest.mark.parametrize("affine", [True, False])
def test_fused_norm_backward_routes_at_the_edges(dtype, h, r, affine):
    """Kernel A's backward on the route its plan names ("warp" to 1024
    16-bit / 512 f32 columns, "warps" past that for 16-bit rows: Llama-7B's
    4096, "block" for f32 past 512 and for rows without 16-byte accesses:
    1001), with the residual gradient, with and without a scale: the
    wrapper reports the plan's route, two calls bit-equal, dh and dw
    within phase 18's gates."""
    from paddle_tpu_torch.ops import fused_norm as fn
    gen = torch.Generator(device="cuda").manual_seed(r * h)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    w = 1 + 0.1 * rnd(h, dt=torch.float32) if affine else None
    _, hh, inv = fn.rms_norm_fwd_plain(rnd(r, h), w, 1e-6, None, rnd(r, h),
                                       dtype)
    dout, dres = rnd(r, h), rnd(r, h)
    dh, dw = fn.rms_norm_bwd(dout, dres, hh, w, inv, dtype)
    dh2, dw2 = fn.rms_norm_bwd(dout, dres, hh, w, inv, dtype)
    rdh, rdw = fn.rms_norm_bwd_plain(dout, dres, hh, w, inv, dtype)
    torch.cuda.synchronize()
    plan = fn.bwd_plan(r, h, dtype, torch.cuda.get_device_properties(
        0).multi_processor_count, h % 8 == 0)
    assert fn.rms_norm_bwd.route == plan["route"]
    assert (plan["route"] == "block") == (
        (dtype == torch.float32 and h > 512) or h % 8 != 0)
    assert torch.equal(dh, dh2)
    extra = 2 * _ulp(fn.rms_norm_bwd_plain(dout, None, hh, w, inv,
                                           dtype)[0])
    assert _two_ulps(dh, rdh, 1e-6 + extra) <= 1
    if affine:
        assert torch.equal(dw, dw2)
        assert _two_ulps(dw, rdw, 1e-5 * float(rdw.abs().max())) <= 1
    else:
        assert dw is None and rdw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("v", [1, 7, 32000, 32001, 50257, 128256])
def test_token_ce_forward_routes_at_the_edges(dtype, v):
    """Kernel C's forward on the route its plan names ("rows" up to 64 KB a
    row, "cluster" of 2-8 blocks past that: f32 32000, GPT-2's 50257,
    Llama-3's 128256; rows off 16 bytes at 1, 7, 32001 and 50257 take
    their head and tail one element at a time), with ignored rows,
    smoothing and labels outside [0, V): the wrapper reports the plan's
    route, two calls bit-equal, NaN where the plain version has it, the
    rest within phase 18's gates."""
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator(device="cuda").manual_seed(v)
    n = 37
    x = (2 * torch.randn(n, v, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(0, v, (n,), generator=gen, device="cuda")
    lab[::4] = -100
    lab[1], lab[3] = v + 2, -1
    for smooth in (0.0, 0.1):
        loss, stats, totals = tc.token_ce_fwd(x, lab, -100, smooth)
        again = tc.token_ce_fwd(x, lab, -100, smooth)
        rl, rs, rt = tc.token_ce_fwd_plain(x, lab, -100, smooth)
        torch.cuda.synchronize()
        assert tc.token_ce_fwd.route == tc.fwd_plan(n, v, dtype)["route"]
        assert all(torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
                   for a, b in zip((loss, stats, totals), again))
        assert torch.equal(loss.isnan(), rl.isnan())
        assert bool(loss[[1, 3]].isnan().all())
        keep = ~rl.isnan()
        assert _two_ulps(loss[keep], rl[keep], 1e-5) <= 1
        assert torch.equal(stats[:, 0], rs[:, 0])
        assert _two_ulps(stats[:, 1], rs[:, 1], 1e-2) <= 1
        assert float(totals[1]) == float(rt[1])


@pytest.mark.parametrize("count", [1, 300])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (1e-3, 0.1)])
def test_adamw_kernel_matches_plain(count, gdtype, clip, wd):
    """Kernel D against the foreach passes: sizes 0, 1, odd, one past a
    chunk, a tensor that starts 4 bytes off a 16-byte boundary (the scalar
    route), more tensors than one launch takes (300 > 256), bf16 grads,
    the clip on / off / dominant, decay on the ndim >= 2 tensors only."""
    from paddle_tpu_torch.ops import adamw as ad
    gen = torch.Generator(device="cuda").manual_seed(count)
    sizes = [(0,), (1,), (7, 3), (65537,), (33, 65)] * (count // 5 + 1)
    sizes = sizes[:max(count, 5)]

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    p0 = [rnd(s, 0.02) for s in sizes]
    p0[2] = torch.empty(22, device="cuda")[1:].view(7, 3).copy_(p0[2])
    g0 = [rnd(s, 1e-2).to(gdtype) for s in sizes]
    m0 = [rnd(s, 1e-3) for s in sizes]
    v0 = [rnd(s, 1e-3) ** 2 for s in sizes]
    decay = [len(s) >= 2 for s in sizes]
    outs = []
    for fn in (ad.adamw_step, ad.adamw_step, ad.adamw_step_plain):
        ps = [t.clone() if i != 2 else torch.empty(22, device="cuda")[1:]
              .view(7, 3).copy_(t) for i, t in enumerate(p0)]
        ms, vs = [t.clone() for t in m0], [t.clone() for t in v0]
        gn = fn(ps, g0, ms, vs, decay, 1e-3, 0.9, 0.95, 1e-8, wd, clip, 2)
        outs.append((ps, ms, vs, gn))
    torch.cuda.synchronize()
    (k1, k2, ref) = outs
    assert torch.equal(k1[3], k2[3]) and _two_ulps(k1[3], ref[3]) <= 1
    for a, b, c in zip(k1[:3], k2[:3], ref[:3]):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)
            if x.numel():
                assert _two_ulps(x, z) <= 1


def test_pretrain_adamw_takes_kernel_d_and_matches_its_plain_route():
    """``pretrain._adamw`` on the card launches kernel D (two launches a
    step) and gives within 2 ulps what ``pretrain._adamw_plain`` (the
    foreach passes) gives on the same dicts, three steps in a row."""
    from paddle_tpu_torch.models import pretrain
    from paddle_tpu_torch.ops import adamw as ad
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {"w": (64, 48), "e": (100, 64), "n": (64,)}
    init = {k: 0.02 * torch.randn(s, generator=gen, device="cuda")
            for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen, device="cuda")
             for k, s in shapes.items()}
    outs = []
    for fn in (pretrain._adamw, pretrain._adamw_plain):
        params = {k: t.clone() for k, t in init.items()}
        state = {"m": {k: torch.zeros_like(t) for k, t in init.items()},
                 "v": {k: torch.zeros_like(t) for k, t in init.items()},
                 "count": 0}
        before = ad.adamw_step.launches
        for _ in range(3):
            params, state, gnorm = fn(params, grads, state, 1e-3, 0.9, 0.95,
                                      1e-8, 0.1, 1.0)
        outs.append((params, state, gnorm, ad.adamw_step.launches - before))
    (kp, ks, kg, kn), (pp, ps, pg, pn) = outs
    assert (kn, pn) == (6, 0) and ks["count"] == ps["count"] == 3
    assert _two_ulps(kg.reshape(1), pg.reshape(1)) <= 1
    for k in shapes:
        for a, b in ((kp[k], pp[k]), (ks["m"][k], ps["m"][k]),
                     (ks["v"][k], ps["v"][k])):
            assert _two_ulps(a, b) <= 1


@pytest.mark.parametrize("case", ["one_tensor", "two_launches",
                                  "nan_and_inf", "bf16_grads"])
def test_adamw_telemetry_matches_plain_and_leaves_the_update_alone(case):
    """Kernel D with the telemetry (the group sums and the packed vector in
    the same two launches) against ``pack_telemetry_plain``: one tensor;
    257 tensors (two launches of each kernel) with tensors of 0 and 1
    elements and 5 groups; NaN and Inf grads in two tensors (the counts
    exact, NaN where the plain version has NaN); bf16 grads. p, m, v and
    gnorm are bit-equal to the run without the telemetry. Tolerance rtol
    1e-5: f64 sums in another order, each rounded to f32 once."""
    from paddle_tpu_torch.ops import adamw as ad
    gen = torch.Generator(device="cuda").manual_seed(17)
    if case == "one_tensor":
        sizes, ng = [(33, 65)], 1
    elif case == "two_launches":
        sizes, ng = ([(1,), (0,), (7, 3), (65537,), (33, 65)] * 52)[:257], 5
    else:
        sizes, ng = [(64, 48), (65537,), (1,), (100, 64)], 3
    groups = [i % ng for i in range(len(sizes))]

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    p0 = [rnd(s, 0.02) for s in sizes]
    g0 = [rnd(s, 1e-2) for s in sizes]
    if case == "nan_and_inf":
        g0[1][5] = float("nan")
        g0[1][70000 % 65537] = float("inf")
        g0[3][2, 3] = float("-inf")
    if case == "bf16_grads":
        g0 = [g.to(torch.bfloat16) for g in g0]
    m0 = [rnd(s, 1e-3) for s in sizes]
    v0 = [rnd(s, 1e-3) ** 2 for s in sizes]
    decay = [len(s) >= 2 for s in sizes]
    loss = torch.tensor(4.5, device="cuda")
    hp = (1e-3, 0.9, 0.95, 1e-8, 0.1, 1.0, 2)
    runs = []
    for tel in (False, True):
        ps, ms, vs = ([t.clone() for t in x] for x in (p0, m0, v0))
        before = (ad.adamw_step.launches, ad.adamw_step.telemetry_launches)
        kw = dict(groups=groups, loss=loss) if tel else {}
        out = ad.adamw_step(ps, g0, ms, vs, decay, *hp, **kw)
        after = (ad.adamw_step.launches, ad.adamw_step.telemetry_launches)
        runs.append((ps, ms, vs, out, (after[0] - before[0],
                                      after[1] - before[1])))
    torch.cuda.synchronize()
    (p1, m1, v1, gn_off, n_off), (p2, m2, v2, (gn_on, vec), n_on) = runs
    launches = 2 * -(-len(sizes) // 256)
    assert n_off == (launches, 0) and n_on == (launches, launches)
    assert torch.equal(gn_off, gn_on) or (gn_off.isnan() and gn_on.isnan())
    for a, b in zip(p1 + m1 + v1, p2 + m2 + v2):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())
    ref = ad.pack_telemetry_plain(loss, gn_on, g0, p0, p2, groups)
    assert vec.shape == (2 + 4 * ng,)
    torch.testing.assert_close(vec, ref, rtol=1e-5, atol=0, equal_nan=True)
    nf = vec[2:].reshape(ng, 4)[:, 3]
    assert torch.equal(nf, ref[2:].reshape(ng, 4)[:, 3])
    if case == "nan_and_inf":
        assert nf.tolist() == [1.0, 2.0, 0.0] and bool(gn_on.isnan())


def test_fused_tier_wrappers_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import adamw as ad
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import swiglu as sw
    from paddle_tpu_torch.ops import token_ce as tc
    x = torch.randn(4, 8, device="cuda")
    with pytest.raises(ValueError):
        fn.rms_norm_fwd(x.t(), None, 1e-6, None, None, torch.float32)
    with pytest.raises(ValueError):
        sw.swiglu_fwd(x[:, ::2], x[:, 1::2])
    with pytest.raises(ValueError):
        tc.token_ce_fwd(x, torch.zeros(4, dtype=torch.int32,
                                       device="cuda"), -100, 0.0)
    with pytest.raises(ValueError):
        ad.adamw_step([x.double()], [x], [x.clone()], [x.clone()], [True],
                      1e-3, 0.9, 0.95, 1e-8, 0.1, 1.0, 1)


EAGER_CASES = {
    # sizes, parameter dtype, master kept, grad dtype
    "edge_f32": ([(0,), (1,), (7, 3), (65537,), (33, 65)], torch.float32,
                 False, torch.float32),
    "two_launches": ([(0,), (1,), (5, 2), (300,)] * 65, torch.float32,
                     False, torch.bfloat16),
    "bf16_master": ([(1,), (7, 3), (65537,), (64, 48)], torch.bfloat16,
                    True, torch.bfloat16),
    "bf16_in_place": ([(1,), (7, 3), (65537,), (64, 48)], torch.bfloat16,
                      False, torch.bfloat16),
}


@pytest.mark.parametrize("clip", [None, 1e-2, 1e4])
@pytest.mark.parametrize("mode", ["adamw", "adam"])
@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_adamw_eager_kernel_matches_plain(case, mode, clip):
    """Kernel D's eager form against ``adamw_eager_plain``: 0- and
    1-element tensors, one past a chunk, a tensor one element off the
    vector alignment (the elementwise route), 260 tensors (two launches of
    each kernel), bf16 parameters with an f32 master and the bf16 copy
    written, bf16 parameters updated in place; the clip off, active and
    idle, one tensor left out of it (need_clip), per-tensor rates and
    decays. Two runs bit-equal; every output within 2 ulps of its dtype
    (the norm's f64 sums run in another order)."""
    from paddle_tpu_torch.ops import adamw as ad
    sizes, pdt, master, gdt = EAGER_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(len(sizes))
    t = len(sizes)

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    p0 = [rnd(s, 0.02) for s in sizes]
    g0 = [rnd(s, 1e-2).to(gdt) for s in sizes]
    m0 = [rnd(s, 1e-3) for s in sizes]
    v0 = [rnd(s, 1e-3) ** 2 for s in sizes]
    lrs = [1e-3 * (1 + i % 3) for i in range(t)]
    decay = [len(s) >= 2 for s in sizes]
    wds = [0.1 * (i % 2) for i in range(t)]
    flags = [i != 1 for i in range(t)]
    def off(x):
        """x in a tensor that starts one element past its storage's start
        (the elementwise route: 4 or 2 bytes off the vector alignment)."""
        return torch.empty(x.numel() + 1, dtype=x.dtype,
                           device="cuda")[1:].view(x.shape).copy_(x)
    outs = []
    for fn in (ad.adamw_eager, ad.adamw_eager, ad.adamw_eager_plain):
        ps = [x.clone() if master else x.to(pdt) for x in p0]
        ps[2] = off(ps[2])
        out = [x.to(pdt) for x in p0] if master else None
        ms, vs = [x.clone() for x in m0], [x.clone() for x in v0]
        before = ad.adamw_eager.launches
        gn = fn(ps, g0, ms, vs, lrs, decay, 0.9, 0.95, 1e-8, wds, 3,
                mode=mode, clip=clip, clip_flags=flags, outs=out)
        outs.append((ps + (out or []), ms, vs, gn,
                     ad.adamw_eager.launches - before))
    torch.cuda.synchronize()
    (k1, k2, ref) = outs
    want = 2 * -(-t // 256)
    assert (k1[4], k2[4], ref[4]) == (want, want, 0)
    assert torch.equal(k1[3], k2[3]) and _two_ulps(k1[3].reshape(1),
                                                  ref[3].reshape(1)) <= 1
    for a, b, c in zip(k1[:3], k2[:3], ref[:3]):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)
            if x.numel():
                assert _two_ulps(x, z) <= 1
    if master:
        for o, p in zip(k1[0][t:], k1[0][:t]):
            assert torch.equal(o, p.to(pdt))


def test_adamw_eager_mesh_form_matches_plain():
    """The mesh form: half the tensors owned, ``reduce`` doubling the
    [1] f64 sum in place (two ranks holding the same parts), the clip
    active, against the plain version's mesh form."""
    from paddle_tpu_torch.ops import adamw as ad
    gen = torch.Generator(device="cuda").manual_seed(9)
    sizes = [(3,), (64, 48), (65537,), (7, 3)]
    p0 = [0.02 * torch.randn(s, generator=gen, device="cuda") for s in sizes]
    g0 = [torch.randn(s, generator=gen, device="cuda") for s in sizes]
    owned = [True, False, True, False]
    outs = []
    for fn in (ad.adamw_eager, ad.adamw_eager_plain):
        ps = [x.clone() for x in p0]
        ms = [torch.zeros_like(x) for x in p0]
        vs = [torch.zeros_like(x) for x in p0]
        gn = fn(ps, g0, ms, vs, [1e-3] * 4, [True] * 4, 0.9, 0.95, 1e-8,
                0.1, 1, clip=1.0, owned=owned,
                reduce=lambda x: x.mul_(2.0))
        outs.append((ps, ms, vs, gn))
    torch.cuda.synchronize()
    (k, ref) = outs
    want = float(torch.stack([g.double().square().sum() for g, o in
                              zip(g0, owned) if o]).sum().mul(2).sqrt())
    assert abs(float(k[3]) - want) <= 2e-7 * want
    assert _two_ulps(k[3].reshape(1), ref[3].reshape(1)) <= 1
    for a, c in zip(k[:3], ref[:3]):
        for x, z in zip(a, c):
            assert _two_ulps(x, z) <= 1


def test_adamw_optimizer_steps_on_kernel_d():
    """``optimizer.AdamW`` with a global-norm clip on CUDA parameters:
    two launches of the eager form a step and no plain route; the result
    within 2 ulps of the same step on the CPU (the plain version)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.ops import adamw as ad
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(s, generator=gen) for s in ((64, 48), (48,))]
    grads = [torch.randn(s, generator=gen) for s in ((64, 48), (48,))]
    res = []
    for dev in ("cuda", "cpu"):
        ps = [torch.nn.Parameter(x.to(dev)) for x in init]
        opt = topt.AdamW(learning_rate=1e-3, parameters=ps,
                         grad_clip=tnn.ClipGradByGlobalNorm(1.0))
        before = ad.adamw_eager.launches
        for _ in range(3):
            for p, g in zip(ps, grads):
                p.grad = g.to(dev)
            opt.step()
        res.append(([p.detach().cpu() for p in ps],
                    ad.adamw_eager.launches - before))
    (kp, kn), (cp, cn) = res
    assert (kn, cn) == (6, 0)
    for a, b in zip(kp, cp):
        assert _two_ulps(a, b) <= 1


# -- the plan knobs of the serving autotuner ----------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,waves,splits", [
    (64, None, 1, 1),           # a grid already past one wave: no split
    (64, None, 4, None),        # ... which four waves split
    (1, None, 4, "max"),        # one sequence: MAX_SPLITS
    (1, 64, 1, None), (8, 64, 4, None)])
def test_ragged_kernel_at_each_split_knob(dtype, b, c, waves, splits):
    """``split_waves`` overrides K3's rule: the plan the knob gives, one
    launch, the plain version's output; one split writes directly, the
    most splits (one page each at MAX_SPLITS) combine the most
    partials."""
    from paddle_tpu_torch.ops import paged_attention as pa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.ragged_plan(b, 1 if c is None else c, SERVE["h"], SERVE["kvh"],
                          SERVE["max_nb"], SERVE["bs"], SERVE["d"], dtype,
                          sms, waves)
    unsplit = plan["blocks"] // plan["splits"]
    if splits == 1:
        assert unsplit >= waves * sms and plan["splits"] == 1, plan
    elif splits == "max":
        assert plan["splits"] == min(pa.MAX_SPLITS, SERVE["max_nb"]), plan
    elif sms == 132:                        # H100 SXM
        assert plan["splits"] > 1, plan
    rng = np.random.default_rng(b + waves)
    lens = rng.integers(0, 600, b)
    lens[:3] = [512, 1, 0][:b]
    qls = None if c is None else np.minimum(rng.integers(0, c + 1, b), lens)
    q, kc, vc, tables, lens_d, qls_d = _serving_case(b, c, lens, qls, dtype,
                                                     seed=34)
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(q, kc, vc, tables, lens_d, q_lens=qls_d,
                                    split_waves=waves)
    ref = pa.ragged_paged_attention_plain(q, kc, vc, tables, lens_d,
                                          q_lens=qls_d)
    split_ref = pa.ragged_split_plain(q, kc, vc, tables, lens_d,
                                      plan["splits"],
                                      plan["pages_per_split"], q_lens=qls_d)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    for r in (ref, split_ref):
        err = float((out.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,kvh,waves", [(64, 8, 1), (1, 1, 4), (8, 8, 4),
                                         (8, 2, 1)])
def test_paged_decode_kernel_at_each_split_knob(dtype, b, kvh, waves):
    """``split_waves`` overrides K7's rule (the ragged kernel's): one
    split at B x KVH = 512 blocks and one wave, MAX_SPLITS for one
    sequence of one kv head, and between; against the plain version and
    the split arithmetic at the knob's plan."""
    from paddle_tpu_torch.ops import paged_attention as pa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, d, bs, max_nb = 2 * kvh, 64, 16, 32
    plan = pa.decode_plan(b, h, kvh, max_nb, bs, d, dtype, sms, waves)
    if b * kvh >= waves * sms:
        assert plan["splits"] == 1, plan
    if (b, kvh) == (1, 1):
        assert plan["splits"] == pa.MAX_SPLITS, plan
    cap = max_nb * bs
    lens = ([cap + 7, 0, 1, bs, cap, 2 * bs + 5] * b)[:b]
    q, kc, vc, tables, lens = _decode_case(b, h, kvh, d, bs, b * max_nb + 8,
                                           max_nb, lens, dtype, b + waves)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kc, vc, tables, lens, split_waves=waves)
    ref = pa.paged_attention_plain(q, kc, vc, tables, lens)
    split_ref = pa.paged_attention_split_plain(
        q, kc, vc, tables, lens, plan["splits"], plan["pages_per_split"])
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    for r in (ref, split_ref):
        err = float((out.float() - r.float()).abs().max())
        assert err <= _tol(r, dtype), err


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n,bn,waves", [
    (8, 1024, 1152, 64, 0),     # 9 tiles of 128 columns: bn 64 gives 18
    (128, 1024, 1152, 64, 2),
    (8, 128, 1024, 0, 4),       # the smallest K: one 128-row slice
    (8, 256, 2048, 128, 4),     # two slices, four waves asked
    (512, 2816, 1024, 64, 1)])
def test_gemm_at_each_plan_knob(quant, dtype, m, k, n, bn, waves):
    """``bn`` / ``waves`` override K4's rule (0: the rule): the C plan is
    ``make_plan``'s, one launch, the plain version's output, and two calls
    bit-equal."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = qm.plan(m, k, n, dtype, bn=bn or None, waves=waves or None)
    assert plan == qm.make_plan(m, k, n, dtype, sms, bn or None,
                                waves or None)
    if bn:
        assert plan["bn"] == bn
    if k == 128:
        assert plan["splits"] == 1, plan
    block_n = 384 if n == 1152 else 512
    x, w, sc = _gemm_inputs(quant, m, k, n, block_n, dtype, m + k + n)
    counter = "launches" if quant == "int4" else "int8_launches"
    before = getattr(qm.weight_only_matmul, counter)
    a = qm.weight_only_matmul(x, w, sc, quant, block_n, bn=bn or None,
                              waves=waves or None)
    again = qm.weight_only_matmul(x, w, sc, quant, block_n, bn=bn or None,
                                  waves=waves or None)
    ref = qm.weight_only_matmul_plain(x, w, sc, quant, block_n)
    torch.cuda.synchronize()
    assert getattr(qm.weight_only_matmul, counter) == before + 2
    assert torch.equal(a, again)
    assert float((a.float() - ref.float()).abs().max()) <= _tol(ref, dtype)
    with pytest.raises(ValueError, match="bn"):
        qm.weight_only_matmul(x, w, sc, quant, block_n, bn=96)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [100, 500, 512])
def test_flash_ring_blocks_match_plain(dtype, d, s):
    """The blocks of ring attention: a full (non-causal) block with as
    many keys as queries, on and off the 64-row tile, and its causal
    diagonal twin."""
    _flash_check(dtype, d, s, s, False, s + d)
    _flash_check(dtype, d, s, s, True, s + d + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [96, 500])
def test_flash_bwd_takes_a_combined_lse_and_sums_dq(dtype, s):
    """The ring's backward: K2 on each of two key blocks with the o and
    lse of attention over both (o and lse from the plain version over the
    concatenated keys, the causal mask of the second block's queries),
    dq summed across the two launches in one f32 ``dq_acc``; dq and each
    block's dk / dv against the plain backward over the whole keys."""
    from paddle_tpu_torch.ops import flash_attention as fa
    d = 64
    q, _, _, do = _flash_inputs(3, s, s, d, dtype, 7 * s)
    _, k, v, _ = _flash_inputs(3, 2 * s, 2 * s, d, dtype, 7 * s + 1)
    scale = d ** -0.5
    # queries of the second block: full on block 0, causal on block 1 ==
    # the top-left causal mask of [s, 2 s] shifted by s; built whole
    rows = torch.arange(s, device="cuda")[:, None] + s
    cols = torch.arange(2 * s, device="cuda")[None, :]
    sc = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    sc = sc.masked_fill(rows < cols, fa.NEG_INF)
    lse = torch.logsumexp(sc, -1).contiguous()
    p = torch.exp(sc - lse[..., None])
    o = torch.matmul(p.to(dtype).float(), v.float()).to(dtype).contiguous()
    acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    got = []
    for j, causal in ((0, False), (1, True)):
        kj = k[:, j * s:(j + 1) * s].contiguous()
        vj = v[:, j * s:(j + 1) * s].contiguous()
        acc, dk, dv = fa.flash_bwd(q, kj, vj, o, lse, do, scale, causal,
                                   dq_acc=acc)
        ref = fa.flash_bwd_plain(q, kj, vj, o, lse, do, scale, causal)
        for name, g, r in (("dk", dk, ref[1]), ("dv", dv, ref[2])):
            err = float((g.float() - r.float()).abs().max())
            assert err <= _tol(r, dtype), (j, name, err)
        got.append(ref[0].float())
    torch.cuda.synchronize()
    assert acc.dtype == torch.float32
    want = got[0] + got[1]
    err = float((acc - want).abs().max())
    assert err <= _tol(want, dtype), ("dq", err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("glu", [True, False])
def test_fused_moe_int8_experts_at_ragged_rows(dtype, glu):
    """``fused_moe``'s int8 experts on K4 at 1, 3 and 1000 rows an expert
    (top-1 over 3-D logits; the other experts get none and launch
    nothing) against the same call on CPU copies (K4's and kernel B's
    plain versions)."""
    from paddle_tpu_torch.incubate.nn import functional as F
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops import swiglu as sw
    rng = np.random.default_rng(11)
    e, d, f = 6, 256, 128
    rows = {0: 1, 1: 3, 2: 1000}
    t = sum(rows.values())
    pick = np.concatenate([np.full(n, ex) for ex, n in rows.items()])
    rng.shuffle(pick)
    logits = np.full((t, e), -30.0, np.float32)
    logits[np.arange(t), pick] = 5.0
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    w1 = rng.standard_normal((e, d, 2 * f if glu else f)) * 0.05
    w2 = rng.standard_normal((e, f, d)) * 0.05
    qs = []
    for w in (w1, w2):
        sc = (np.abs(w).max(axis=1) / 127.0 + 1e-6).astype(np.float32)
        qs.append((np.clip(np.round(w / sc[:, None, :]), -127, 127)
                   .astype(np.int8), sc))
    args = [x, logits.reshape(1, t, e), qs[0][0], qs[1][0]]
    kw = dict(ffn1_scale=qs[0][1], ffn2_scale=qs[1][1])

    def run(dev):
        a = [torch.tensor(v, device=dev) for v in args]
        a[0] = a[0].to(dtype)
        k = {n: torch.tensor(v, device=dev) for n, v in kw.items()}
        return F.fused_moe(*a, quant_method="weight_only_int8", moe_topk=1,
                           **k)

    ref = run("cpu")
    n8, nb = qm.weight_only_matmul.int8_launches, sw.swiglu_fwd.launches
    got = run("cuda")
    torch.cuda.synchronize()
    assert F.fused_moe.last_experts == 3
    assert qm.weight_only_matmul.int8_launches - n8 == 2 * 3
    assert sw.swiglu_fwd.launches - nb == (3 if glu else 0)
    err = (got.cpu().float() - ref.float()).abs().max()
    assert float(err) <= 2 * _tol(ref, dtype), float(err)


# -- the vision path (phase 35's shapes) --------------------------------------

@pytest.mark.parametrize("b", [64, 3])
def test_token_ce_at_the_vision_shape(b):
    """Kernel C under ``nn.CrossEntropyLoss`` at ResNet's head: [B, 1000]
    f32 logits against [B, 1] int64 labels, loss and dlogits against the
    port's CPU result (the kernel's plain version), 1 + 1 launches."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import token_ce as tc
    gen = torch.Generator().manual_seed(b)
    x = 4 * torch.randn(b, 1000, generator=gen)
    y = torch.randint(0, 1000, (b, 1), generator=gen)
    xc = x.clone().requires_grad_(True)
    ref = nn.CrossEntropyLoss()(xc, y)
    ref.backward()
    xg = x.cuda().requires_grad_(True)
    before = (tc.token_ce_fwd.launches, tc.token_ce_bwd.launches)
    got = nn.CrossEntropyLoss()(xg, y.cuda())
    got.backward()
    torch.cuda.synchronize()
    assert (tc.token_ce_fwd.launches, tc.token_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert abs(float(got.detach()) - float(ref.detach())) <= \
        _tol(ref, torch.float32)
    err = float((xg.grad.cpu() - xc.grad).abs().max())
    assert err <= _tol(xc.grad, torch.float32), err


@pytest.mark.parametrize("fn,args,kw", [
    ("max_pool2d", (3, 2, 1), dict(ceil_mode=True)),
    ("max_pool2d", (2, 2, 1), dict(ceil_mode=True, return_mask=True)),
    ("avg_pool2d", (3, 2, 1), dict(ceil_mode=True)),
    ("avg_pool2d", (3, 2, 1), dict(ceil_mode=True, exclusive=False)),
    ("avg_pool2d", (2, 2, 1), dict()),
    ("avg_pool1d", (2, 2, 1), dict(ceil_mode=True)),
    ("adaptive_avg_pool2d", ((3, 5),), dict()),
    ("adaptive_max_pool2d", ((3, 5),), dict(return_mask=True))])
def test_pools_on_the_card_match_the_cpu(fn, args, kw):
    """The pools' own padding (ceil mode, exclusive counts) and masks on
    the card against the port's CPU result, f32 and bf16."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator().manual_seed(3)
    shape = (2, 3, 11) if fn.endswith("1d") else (2, 3, 13, 14)
    x = torch.randn(*shape, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        ref = getattr(F, fn)(xd, *args, **kw)
        got = getattr(F, fn)(xd.cuda(), *args, **kw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for r, g in zip(ref, got):
            assert g.shape == r.shape and g.dtype == r.dtype
            if r.dtype == torch.int32:
                assert torch.equal(g.cpu(), r)
                continue
            tol = _tol(r[torch.isfinite(r)], dtype)
            same = torch.isfinite(r) == torch.isfinite(g.cpu())
            assert bool(same.all())
            fin = torch.isfinite(r)
            err = float((g.cpu().float()[fin] - r.float()[fin]).abs().max())
            assert err <= tol, (fn, dtype, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_and_transposed_convolutions_on_the_card(dtype):
    """A depthwise 3 x 3 / 2 (MobileNet's) and a transposed convolution
    with output padding and groups, forward and input / weight gradients
    on the card against the port's CPU result (TF32 off)."""
    from paddle_tpu_torch.nn import functional as F
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    cases = (
        (F.conv2d, torch.randn(4, 32, 17, 17, generator=gen),
         0.3 * torch.randn(32, 1, 3, 3, generator=gen),
         dict(stride=2, padding=1, groups=32)),
        (F.conv2d_transpose, torch.randn(2, 8, 9, 7, generator=gen),
         0.3 * torch.randn(8, 3, 3, 3, generator=gen),
         dict(stride=2, padding=1, output_padding=1, groups=2)),
        (F.conv2d_transpose, torch.randn(2, 4, 5, 6, generator=gen),
         0.3 * torch.randn(4, 6, 3, 3, generator=gen),
         dict(stride=2, padding=[1, 0, 0, 1], output_size=(10, 12))))
    for fn, x, w, kw in cases:
        outs = []
        for dev in ("cpu", "cuda"):
            xd = x.to(dev, dtype, copy=True).requires_grad_(True)
            wd = w.to(dev, dtype, copy=True).requires_grad_(True)
            out = fn(xd, wd, **kw)
            g = torch.ones_like(out)
            out.backward(g)
            outs.append([t.detach().cpu().float()
                         for t in (out, xd.grad, wd.grad)])
        for name, r, c in zip(("out", "dx", "dw"), *outs):
            assert c.shape == r.shape
            # bf16 rounds each product's sum once on each side
            tol = 4 * _tol(r, dtype) * (1 if dtype == torch.float32 else 4)
            assert float((c - r).abs().max()) <= tol, (fn.__name__, name)
