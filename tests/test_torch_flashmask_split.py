"""The exact split of FlashMask's f32 p and ds into 16-bit parts, which the
tensor-core backward of ``csrc/flashmask.cu`` feeds to one product per
part, checked on the CPU.

``split_parts`` (``paddle_tpu_torch/ops/flashmask.py``) is the CPU mirror
of the kernel's ``split_frag``: hypothesis holds three bf16 parts to an
exact rebuild of f32 values and two parts to 2**-16 |x| (fp16: 2**-22),
over p in [0, 1], ds over a wide range, zeros and subnormals. Then dq, dk
and dv are emulated with the kernel's part count (``FM_PARTS``): p and ds
computed in f32 as the kernel computes them, split, each part's product
taken in f32 and the parts summed in f32, the result rounded to bf16. The
emulation is held against the JAX Pallas FlashMask backward (``_fm_bwd``
in interpret mode, as ``tests/test_torch_flashmask.py`` runs it) on the
same bf16 inputs, o and lse, with the smoke's gate: ``FLASH_GRAD_ATOL``
(1e-4) plus two bf16 ulps of |ref| per element
(``chip_smoke.bf16_agreement``). One part (p and ds rounded to bf16)
misses that gate on the same inputs, so two is the fewest that holds it.

The forward is emulated the same way with its own part count
(``FM_FWD_PARTS``): the online softmax over the kernel's 64-column k
tiles, p in f32 relative to the running max, split, one f32 product of
each part with v, the parts summed in f32, o = acc / l rounded to bf16
once. It is held against the Pallas forward (``_fm_fwd``) under the
smoke's o gate, ``FM_O_ATOL`` (1e-5) plus two bf16 ulps; one part fewer
misses it.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu.ops.pallas import flash_attention as FA  # noqa: E402
from paddle_tpu.ops.pallas import flashmask as FM  # noqa: E402
from paddle_tpu_torch.ops import flashmask as tfm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_MAX_SPLIT = 2.0 ** 127      # below bf16's largest finite value
EXACT_FROM = 2.0 ** -110        # three bf16 parts are exact above this


@pytest.fixture(autouse=True)
def _interpret():
    old = FA._INTERPRET
    FA._INTERPRET = True
    yield
    FA._INTERPRET = old


def _f32(values):
    return torch.tensor(values, dtype=torch.float32)


def _f32s(lo, hi):
    """Lists of f32 values in [lo, hi], zeros and subnormals included."""
    return st.lists(st.floats(lo, hi, width=32, allow_nan=False,
                              allow_infinity=False, allow_subnormal=True),
                    min_size=1, max_size=64)


WIDE = _f32s(-F32_MAX_SPLIT, F32_MAX_SPLIT)


def test_the_part_count_is_the_kernels():
    """The module's ``FM_PARTS`` is the constant the kernel is built with."""
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "flashmask.cu")).read()
    found = re.search(r"constexpr int FM_PARTS = (\d+);", src)
    assert found and int(found.group(1)) == tfm.FM_PARTS == 2


def test_the_forward_part_count_is_the_kernels():
    """The module's ``FM_FWD_PARTS`` is the constant the forward kernel is
    built with."""
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "flashmask.cu")).read()
    found = re.search(r"constexpr int FM_FWD_PARTS = (\d+);", src)
    assert found and int(found.group(1)) == tfm.FM_FWD_PARTS == 2


@settings(max_examples=200, deadline=None)
@given(WIDE)
def test_three_bf16_parts_rebuild_every_f32(values):
    """hi + mid + lo == x exactly for |x| >= 2**-110 (zero included);
    below, where the last part would fall under bf16's subnormal step of
    2**-133, within half that step. The parts are bf16 values."""
    x = _f32(values)
    parts = tfm.split_parts(x, 3)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    rebuilt = sum(p.double() for p in parts)
    exact = x.double().abs() >= EXACT_FROM
    assert torch.equal(rebuilt[exact], x.double()[exact])
    assert bool(((rebuilt - x.double()).abs()[~exact] <= 2.0 ** -134).all())
    assert torch.equal(tfm.split_parts(torch.zeros(3), 3)[0],
                       torch.zeros(3, dtype=torch.bfloat16))


@settings(max_examples=200, deadline=None)
@given(_f32s(0.0, 1.0), WIDE)
def test_two_bf16_parts_hold_sixteen_bits(p_values, ds_values):
    """hi + lo is within 2**-16 |x| of x (plus half of bf16's subnormal
    step): p in [0, 1] and ds of any size, as the kernel splits them."""
    for x in (_f32(p_values), _f32(ds_values)):
        hi, lo = tfm.split_parts(x, 2)
        err = (hi.double() + lo.double() - x.double()).abs()
        assert bool((err <= 2.0 ** -16 * x.double().abs() + 2.0 ** -134)
                    .all())
        assert torch.equal(hi, x.to(torch.bfloat16))


@settings(max_examples=200, deadline=None)
@given(_f32s(-60000.0, 60000.0))
def test_two_fp16_parts_hold_twenty_two_bits(values):
    """fp16 parts (the fp16 kernel's): within 2**-22 |x| of x plus 2**-25,
    half of fp16's subnormal step, where small values lose bits."""
    x = _f32(values)
    hi, lo = tfm.split_parts(x, 2, torch.float16)
    assert hi.dtype == lo.dtype == torch.float16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs() + 2.0 ** -25).all())


def _bounds(kind, b, mh, s, seed):
    """(sr, er) [B, MH, S] int32: packed documents (1 column), a band of
    masked rows per column, or random intervals (2 columns)."""
    rng = np.random.default_rng(seed)
    j = np.broadcast_to(np.arange(s), (b, mh, s))
    if kind == "document":
        sr = np.empty((b, mh, s), np.int64)
        for i in range(b):
            for h in range(mh):
                ends = np.minimum(np.cumsum(rng.integers(5, 40, s)), s)
                sr[i, h] = ends[np.searchsorted(ends, np.arange(s),
                                                side="right")]
        er = np.full_like(sr, s)
    elif kind == "band":
        sr = j + rng.integers(1, 20, (b, mh, s))
        er = sr + rng.integers(0, 40, (b, mh, s))
    else:
        sr = rng.integers(0, s + 1, (b, mh, s))
        er = sr + rng.integers(0, s // 2 + 1, (b, mh, s))
    return sr.astype(np.int32), np.minimum(er, s).astype(np.int32)


def _case(s, d, h, kvh, mh, kind, seed):
    """bf16 q, k, v, do [H, S, D] (kv heads repeated up to H, as
    ``flashmask_attention_bshd`` repeats them) and [1, MH, S] bounds."""
    rng = np.random.default_rng(seed)

    def bf16(n):
        x = rng.standard_normal((n, s, d)).astype(np.float32)
        return torch.as_tensor(x).bfloat16()

    q, do = bf16(h), bf16(h)
    k = bf16(kvh).repeat_interleave(h // kvh, dim=0)
    v = bf16(kvh).repeat_interleave(h // kvh, dim=0)
    sr, er = _bounds(kind, 1, mh, s, seed)
    return q, k, v, do, sr, er


def _pallas(q, k, v, do, sr, er, scale, causal, block):
    """o, lse and (dq, dk, dv) of the Pallas FlashMask kernels on the same
    bf16 values, in interpret mode."""
    bh = q.shape[0]
    rep = bh // sr.shape[0] // sr.shape[1]

    def lanes(x):                   # the TPU's [BH, 8, S] int32 tiles
        x = np.repeat(x, rep, axis=1).reshape(bh, 1, -1)
        return jnp.asarray(np.broadcast_to(x, (bh, 8, x.shape[-1])))

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    o, lse = FM._fm_fwd(jq, jk, jv, lanes(sr), lanes(er), scale, causal,
                        block, block)
    grads = FM._fm_bwd(jq, jk, jv, o, lse, jdo, lanes(sr), lanes(er), scale,
                       causal, block, block)

    def back(x):
        return torch.as_tensor(np.array(x.astype(jnp.float32)))

    return (back(o).bfloat16(), back(lse[:, 0]),
            [back(g).bfloat16() for g in grads])


def _emulate(q, k, v, o, lse, do, sr, er, scale, causal, parts):
    """dq, dk, dv as the tensor-core backward computes them: p and ds in
    f32 from exact products of the bf16 inputs, split into ``parts`` bf16
    parts, one f32 product per part, the parts summed in f32, rounded to
    bf16 once."""
    bh, sq, _ = q.shape
    srx = tfm._mask_rows(torch.as_tensor(sr), bh)
    erx = tfm._mask_rows(torch.as_tensor(er), bh)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(1, 2))
    vis = tfm._visible(srx, erx, sq, causal)
    p = torch.where(vis, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    dp = torch.matmul(dof, vf.transpose(1, 2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale

    def product(x, y, transpose):
        acc = torch.zeros(x.shape[0], x.shape[2 if transpose else 1],
                          y.shape[2])
        for part in tfm.split_parts(x, parts):
            a = part.float()
            acc = acc + torch.matmul(a.transpose(1, 2) if transpose else a,
                                     y)
        return acc.bfloat16()

    return product(ds, kf, False), product(ds, qf, True), \
        product(p, dof, True)


def _worst(got, want):
    """The largest error over its allowance (the smoke's gate) of dq, dk
    and dv; at most 1 passes."""
    return max(cs.bf16_agreement(g, w, cs.FLASH_GRAD_ATOL)[1]
               for g, w in zip(got, want))


@pytest.mark.parametrize("s,d,h,kvh,mh,kind,causal,block", [
    (40, 32, 2, 2, 1, "document", True, 8),
    (96, 64, 4, 2, 2, "band", True, 16),
    (112, 32, 4, 1, 1, "random", False, 16),
    (160, 64, 4, 2, 1, "document", True, 32),
    (200, 64, 2, 1, 2, "random", True, 40),
])
def test_split_emulation_meets_the_smoke_gate(s, d, h, kvh, mh, kind, causal,
                                              block):
    """FM_PARTS parts of p and ds hold the smoke's FlashMask gradient gate
    against the Pallas backward; one part (rounding p and ds to bf16, as
    the two-pass backward does) does not, on these inputs."""
    q, k, v, do, sr, er = _case(s, d, h, kvh, mh, kind, s + d + mh)
    scale = d ** -0.5
    o, lse, want = _pallas(q, k, v, do, sr, er, scale, causal, block)
    got = _emulate(q, k, v, o, lse, do, sr, er, scale, causal, tfm.FM_PARTS)
    assert _worst(got, want) <= 1.0
    rounded = _emulate(q, k, v, o, lse, do, sr, er, scale, causal, 1)
    assert _worst(rounded, want) > 1.0


FWD_TILE = 64       # the kernel's k tile: one online-softmax step


def _emulate_fwd(q, k, v, sr, er, scale, causal, parts):
    """o as the tensor-core forward computes it: per 64-column k tile, s =
    q k^T from exact products of the bf16 inputs, the running max m and
    sum l in f32, p = exp(s scale - m) in f32 split into ``parts`` bf16
    parts, one f32 product of each part with v, the accumulator rescaled
    by the max's correction; o = acc / l rounded to bf16 once."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    srx = tfm._mask_rows(torch.as_tensor(sr), bh)
    erx = tfm._mask_rows(torch.as_tensor(er), bh)
    vis = tfm._visible(srx, erx, sq, causal)
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    for c0 in range(0, sk, FWD_TILE):
        c1 = min(sk, c0 + FWD_TILE)
        s = torch.matmul(qf, kf[:, c0:c1].transpose(1, 2)) * scale
        live = vis[..., c0:c1]
        mx = s.masked_fill(~live, -1e30).amax(-1, keepdim=True)
        m_new = torch.maximum(m, mx)
        p = torch.where(live, torch.exp(s - m_new), torch.zeros(()))
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = acc * corr
        for part in tfm.split_parts(p, parts):
            acc = acc + torch.matmul(part.float(), vf[:, c0:c1])
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).bfloat16()


def _pallas_fwd(q, k, v, sr, er, scale, causal, block):
    """o of the Pallas FlashMask forward on the same bf16 values, in
    interpret mode."""
    bh = q.shape[0]
    rep = bh // sr.shape[0] // sr.shape[1]

    def lanes(x):
        x = np.repeat(x, rep, axis=1).reshape(bh, 1, -1)
        return jnp.asarray(np.broadcast_to(x, (bh, 8, x.shape[-1])))

    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    o, _ = FM._fm_fwd(jq, jk, jv, lanes(sr), lanes(er), scale, causal,
                      block, block)
    return torch.as_tensor(np.array(o.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("s,d,h,kvh,mh,kind,causal,block", [
    (40, 32, 2, 2, 1, "document", True, 8),
    (96, 64, 4, 2, 2, "band", True, 16),
    (112, 32, 4, 1, 1, "random", False, 16),
    (160, 64, 4, 2, 1, "document", True, 32),
    (200, 64, 2, 1, 2, "random", True, 40),
])
def test_forward_split_emulation_meets_the_smoke_gate(s, d, h, kvh, mh, kind,
                                                      causal, block):
    """FM_FWD_PARTS parts of p hold the smoke's FlashMask o gate against
    the Pallas forward; one part fewer (p rounded to bf16, as the flash
    forward rounds it) does not, on these inputs."""
    q, k, v, _, sr, er = _case(s, d, h, kvh, mh, kind, s + d + mh + 1)
    scale = d ** -0.5
    want = _pallas_fwd(q, k, v, sr, er, scale, causal, block)
    got = _emulate_fwd(q, k, v, sr, er, scale, causal, tfm.FM_FWD_PARTS)
    assert cs.bf16_agreement(got, want, cs.FM_O_ATOL)[1] <= 1.0
    fewer = _emulate_fwd(q, k, v, sr, er, scale, causal,
                         tfm.FM_FWD_PARTS - 1)
    assert cs.bf16_agreement(fewer, want, cs.FM_O_ATOL)[1] > 1.0
