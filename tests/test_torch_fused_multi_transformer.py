"""The PyTorch port's ``fused_multi_transformer`` held against the JAX
package on the CPU in f32: dense prefill, dense decode (shared time step
and per-sequence seq_lens) and the paged branch (decode and chunked
prefill) must give the JAX hidden states within atol 1e-4 and the same
caches within atol 1e-5 (same f32 products, different BLAS summation
order). The JAX paged branch runs its ragged Pallas kernel in interpret
mode, as the JAX package's tests do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.incubate.nn import functional as JF  # noqa: E402
from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TF  # noqa: E402

H_ATOL = 1e-4
C_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    with jax.default_matmul_precision("float32"):
        yield
    fa._INTERPRET = old


def _weights(rng, L, E, H, D, F, G=0, biases=False, glu=False):
    def mk(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    qkv = (lambda: mk(H + 2 * G, D, E)) if G else (lambda: mk(3, H, D, E))
    w = dict(
        ln_scales=[mk(E, scale=1.0) for _ in range(L)],
        qkv_weights=[qkv() for _ in range(L)],
        linear_weights=[mk(H * D, E) for _ in range(L)],
        ffn_ln_scales=[mk(E, scale=1.0) for _ in range(L)],
        ffn1_weights=[mk(E, 2 * F if glu else F) for _ in range(L)],
        ffn2_weights=[mk(F, E) for _ in range(L)],
        ln_biases=[], qkv_biases=[], linear_biases=[], ffn_ln_biases=[],
        ffn1_biases=[], ffn2_biases=[])
    if biases:
        w.update(
            ln_biases=[mk(E) for _ in range(L)],
            qkv_biases=[mk(*w["qkv_weights"][0].shape[:-1])
                        for _ in range(L)],
            linear_biases=[mk(E) for _ in range(L)],
            ffn_ln_biases=[mk(E) for _ in range(L)],
            ffn1_biases=[mk(w["ffn1_weights"][0].shape[1])
                         for _ in range(L)],
            ffn2_biases=[mk(E) for _ in range(L)])
    return w


def _jax_args(w):
    T = paddle.to_tensor
    return {k: [T(a) for a in v] for k, v in w.items()}


def _torch_args(w):
    return {k: [torch.from_numpy(a) for a in v] for k, v in w.items()}


def _rope(rng, b, s_rope, d):
    ang = rng.uniform(0, 3, (b, 1, s_rope, d)).astype(np.float32)
    return np.stack([np.cos(ang), np.sin(ang)])        # [2, B, 1, S, D]


class _Pair:
    """Run one call on both packages: x and caches from numpy, kwargs
    translated (numpy arrays -> paddle Tensors / torch tensors)."""

    def __init__(self, w):
        self.jw = _jax_args(w)
        self.tw = _torch_args(w)

    def run(self, x, caches, **kw):
        T = paddle.to_tensor
        jc = [T(c.copy()) for c in caches]
        tc = [torch.from_numpy(c.copy()) for c in caches]
        jkw, tkw = {}, {}
        for k, v in kw.items():
            if isinstance(v, np.ndarray):
                jkw[k] = T(v)
                tkw[k] = v if k in ("block_tables", "seq_lens",
                                    "chunk_lens") else torch.from_numpy(v)
            else:
                jkw[k] = tkw[k] = v
        jo = JF.fused_multi_transformer(T(x), cache_kvs=jc or None,
                                        **self.jw, **jkw)
        to = TF.fused_multi_transformer(torch.from_numpy(x),
                                        cache_kvs=tc or None, **self.tw,
                                        **tkw)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=0,
                                   atol=H_ATOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=C_ATOL)
        return [c.numpy() for c in tc]


class TestDense:
    def test_prefill_mha_layernorm_biases_gelu(self):
        rng = np.random.default_rng(0)
        B, S, E, H, D, F, SMAX, L = 2, 5, 32, 4, 8, 64, 16, 2
        p = _Pair(_weights(rng, L, E, H, D, F, biases=True))
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        caches = [np.zeros((2, B, H, SMAX, D), np.float32)
                  for _ in range(L)]
        out = p.run(x, caches, activation="gelu")
        assert np.abs(out[0][:, :, :, :S]).sum() > 0

    def test_prefill_no_cache_post_norm(self):
        rng = np.random.default_rng(1)
        B, S, E, H, D, F, L = 2, 4, 32, 4, 8, 64, 1
        p = _Pair(_weights(rng, L, E, H, D, F, biases=True))
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        p.run(x, [], pre_layer_norm=False, activation="relu")

    @pytest.mark.parametrize("neox", [False, True])
    def test_gqa_prefill_then_decode_with_rope(self, neox):
        rng = np.random.default_rng(2)
        B, S, E, H, G, D, F, SMAX, L = 2, 6, 32, 4, 2, 8, 48, 16, 2
        p = _Pair(_weights(rng, L, E, H, D, F, G=G, glu=True))
        kw = dict(norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  rotary_embs=_rope(rng, B, SMAX, D),
                  use_neox_rotary_style=neox)
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        caches = [np.zeros((2, B, G, SMAX, D), np.float32)
                  for _ in range(L)]
        caches = p.run(x, caches, **kw)
        xt = rng.standard_normal((B, 1, E)).astype(np.float32)
        p.run(xt, caches, time_step=S, **kw)

    def test_ragged_prefill_and_decode_with_seq_lens(self):
        rng = np.random.default_rng(3)
        B, S, E, H, G, D, F, SMAX, L = 3, 7, 32, 4, 2, 8, 48, 16, 2
        p = _Pair(_weights(rng, L, E, H, D, F, G=G, glu=True))
        kw = dict(norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  rotary_embs=_rope(rng, B, SMAX, D))
        lens = np.array([3, 7, 5], np.int32)
        x = rng.standard_normal((B, S, E)).astype(np.float32)
        caches = [np.zeros((2, B, G, SMAX, D), np.float32)
                  for _ in range(L)]
        caches = p.run(x, caches, seq_lens=lens, **kw)
        xt = rng.standard_normal((B, 1, E)).astype(np.float32)
        p.run(xt, caches, time_step=np.array(0, np.int32), seq_lens=lens,
              **kw)


def _paged_setup(rng, B, KVH, NB, BS, D, L, max_nb):
    caches = [(rng.standard_normal((2, KVH, NB, BS, D)) * 0.5).astype(
        np.float32) for _ in range(L)]
    tables = np.stack([rng.choice(np.arange(1, NB), max_nb, replace=False)
                       for _ in range(B)]).astype(np.int32)
    return caches, tables


class TestPaged:
    def test_paged_decode(self):
        rng = np.random.default_rng(4)
        B, E, H, G, D, F, L, BS, NB, MAXNB = 3, 32, 4, 2, 8, 48, 2, 4, 16, 4
        p = _Pair(_weights(rng, L, E, H, D, F, G=G, glu=True))
        caches, tables = _paged_setup(rng, B, G, NB, BS, D, L, MAXNB)
        lens = np.array([0, 7, 16], np.int32)     # 16: at capacity, dropped
        x = rng.standard_normal((B, 1, E)).astype(np.float32)
        p.run(x, caches, norm_type="rmsnorm", activation="swiglu",
              gqa_group_size=G, time_step=np.array(0, np.int32),
              seq_lens=lens, block_tables=tables)

    @pytest.mark.parametrize("with_rope", [False, True])
    def test_paged_chunked(self, with_rope):
        rng = np.random.default_rng(5)
        B, C, E, H, G, D, F, L, BS, NB, MAXNB = \
            4, 4, 32, 4, 2, 8, 48, 2, 4, 20, 4
        p = _Pair(_weights(rng, L, E, H, D, F, G=G, glu=True))
        caches, tables = _paged_setup(rng, B, G, NB, BS, D, L, MAXNB)
        lens = np.array([0, 5, 9, 3], np.int32)
        qls = np.array([4, 1, 3, 0], np.int32)    # prefill, decode, parked
        x = rng.standard_normal((B, C, E)).astype(np.float32)
        kw = dict(norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  time_step=np.array(0, np.int32), seq_lens=lens,
                  chunk_lens=qls, block_tables=tables)
        if with_rope:
            kw["rotary_embs"] = _rope(rng, B, MAXNB * BS, D)
        p.run(x, caches, **kw)


class TestHelpersAndLimits:
    def test_rms_and_rope_match_jax(self):
        rng = np.random.default_rng(6)
        h = rng.standard_normal((2, 3, 16)).astype(np.float32)
        sc = rng.standard_normal(16).astype(np.float32)
        np.testing.assert_allclose(
            TF._rms(torch.from_numpy(h), 1e-5, torch.from_numpy(sc)).numpy(),
            np.asarray(JF._rms(jnp.asarray(h), 1e-5, jnp.asarray(sc))),
            rtol=0, atol=1e-6)
        q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
        k = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
        cos = rng.standard_normal((2, 3, 1, 8)).astype(np.float32)
        sin = rng.standard_normal((2, 3, 1, 8)).astype(np.float32)
        for neox in (False, True):
            got = TF._apply_rope_pair(*map(torch.from_numpy,
                                           (q, k, cos, sin)), neox)
            ref = JF._apply_rope_pair(*map(jnp.asarray, (q, k, cos, sin)),
                                      neox)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0, atol=1e-6)
        w = [np.zeros((12, 8, 16), np.float32)]
        assert TF._ragged_group_q(w, 4, True) == \
            JF._ragged_group_q(w, 4, True) == 1
        assert TF._ragged_group_q([np.zeros((3, 4, 8, 16))], -1, True) == 1

    @pytest.mark.parametrize("kw,msg", [
        (dict(pre_caches=[1], time_step=0), "pre_caches apply to"),
        (dict(attn_mask=1, time_step=0, seq_lens=np.zeros(1, np.int32),
              block_tables=np.zeros((1, 1), np.int32),
              cache_kvs=[torch.zeros((2, 2, 2, 4, 8))]),
         "attn_mask unsupported on the paged"),
        (dict(beam_offset=1), "beam_offset unsupported"),
        (dict(_tp_reduce=abs), "later slice")],
        ids=["pre_caches", "attn_mask", "beam_offset", "tp"])
    def test_later_slice_options_raise(self, kw, msg):
        """What the port still refuses: where the JAX package refuses
        (pre_caches at decode time, attn_mask on the paged path,
        beam_offset; its messages) and the tensor-parallel hook."""
        rng = np.random.default_rng(7)
        w = _torch_args(_weights(rng, 1, 16, 2, 8, 32))
        x = torch.zeros((1, 1, 16))
        with pytest.raises(NotImplementedError, match=msg):
            TF.fused_multi_transformer(x, **w, **kw)

    def test_paged_argument_checks(self):
        rng = np.random.default_rng(8)
        w = _torch_args(_weights(rng, 1, 16, 2, 8, 32))
        x = torch.zeros((2, 3, 16))
        with pytest.raises(ValueError):        # chunk_lens needs tables
            TF.fused_multi_transformer(x, **w, chunk_lens=np.ones(2))
        with pytest.raises(ValueError):        # multi-token slab, no chunks
            TF.fused_multi_transformer(
                x, **w, cache_kvs=[torch.zeros((2, 2, 4, 4, 8))],
                time_step=0, seq_lens=np.zeros(2, np.int32),
                block_tables=np.zeros((2, 2), np.int32))
