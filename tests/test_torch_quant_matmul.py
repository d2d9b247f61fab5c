"""The PyTorch port's weight-only matmul held against the JAX package on
the CPU: the packing helpers must be byte-identical, the plain int4 and
int8 ``weight_only_matmul`` must match the Pallas kernels in interpret
mode (int4 atol 1e-4; int8 f32 atol 2e-5 and bf16 one bf16 ulp of the
largest output), the quantized serving engines must decode the reference
tokens, and ``fused_multi_transformer_int8`` / ``_int4`` must match the
JAX ops (atol 1e-4, the fused stack's own tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.ops.pallas.quant_matmul as QM  # noqa: E402
from paddle_tpu.incubate.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import quant_matmul as tqm  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret():
    old = QM._INTERPRET
    QM._INTERPRET = True
    yield
    QM._INTERPRET = old


class TestPacking:
    def test_pick_block_n_identical(self):
        for n in (100, 256, 384, 512, 768, 1024, 2048, 2816, 5632, 4096):
            for quant in ("int8", "int4"):
                for prefer in (256, 512, 1024):
                    assert tqm.pick_block_n(n, quant, prefer) == \
                        QM.pick_block_n(n, quant, prefer)

    def test_kernel_block_n_is_the_cuda_kernels_rule(self):
        # a multiple of 128 that divides N, at most `prefer`; the TPU's
        # int4 rule (multiples of 256) would refuse 384 and 640
        ns = (128, 384, 640, 1024, 2816, 5632, 96, 200)
        assert [tqm.kernel_block_n(n) for n in ns] == \
            [128, 384, 128, 512, 256, 512, None, None]
        assert tqm.kernel_block_n(1024, prefer=256) == 256
        assert QM.pick_block_n(384, "int4") is None

    @pytest.mark.parametrize("k,n,bn", [(64, 512, 256), (32, 1024, 512),
                                        (16, 768, 256), (8, 256, 256)])
    def test_pack_int4_blocked_byte_identical(self, k, n, bn):
        rng = np.random.default_rng(k + n)
        w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
        w[:, 3] = 0.0                           # an all-zero column
        gp, gs = tqm.pack_int4_blocked(w, block_n=bn)
        rp, rs = QM.pack_int4_blocked(w, block_n=bn)
        assert gp.dtype == rp.dtype == np.int8
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gs, rs)

    def test_unpack_blocked_inverts_pack(self):
        rng = np.random.default_rng(1)
        w = (rng.standard_normal((16, 512)) * 0.1).astype(np.float32)
        packed, sc = tqm.pack_int4_blocked(w, block_n=256)
        q = np.clip(np.round(w / sc[None, :]), -8, 7).astype(np.int8)
        got = tqm.unpack_int4_blocked(torch.from_numpy(packed), 256)
        np.testing.assert_array_equal(got.numpy(), q)

    @pytest.mark.parametrize("shape,axis,group", [
        ((6, 8), -1, None), ((8, 6), 0, None), ((3, 4, 16), -1, None),
        ((16, 5), 0, 4), ((4, 6, 12), 1, None)])
    def test_quantize_int4_byte_identical(self, shape, axis, group):
        rng = np.random.default_rng(len(shape) + shape[0])
        w = rng.standard_normal(shape).astype(np.float32)
        gp, gs = TF.quantize_int4(w, axis=axis, group_size=group)
        rp, rs = JF.quantize_int4(w, axis=axis, group_size=group)
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gs, rs)
        # and back: the port's unpack equals the JAX unpack exactly
        got = TF._unpack_int4(torch.from_numpy(gp), axis=axis)
        ref = JF._unpack_int4(jnp.asarray(rp), axis=axis)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestPlainInt4Matmul:
    @pytest.mark.parametrize("m,k,n,bn", [(4, 64, 512, 256),
                                          (8, 128, 1024, 512),
                                          (3, 32, 768, 256)])
    def test_matches_pallas_interpret(self, m, k, n, bn):
        rng = np.random.default_rng(m * k)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
        packed, sc = QM.pack_int4_blocked(w, block_n=bn)
        ref = QM.weight_only_matmul(jnp.asarray(x), jnp.asarray(packed),
                                    jnp.asarray(sc), "int4", block_n=bn)
        got = tqm.weight_only_matmul(torch.from_numpy(x),
                                     torch.from_numpy(packed),
                                     torch.from_numpy(sc), "int4",
                                     block_n=bn)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)

    def test_cpu_wrapper_does_not_count_and_keeps_dtype(self):
        rng = np.random.default_rng(2)
        w = (rng.standard_normal((32, 256)) * 0.1).astype(np.float32)
        packed, sc = tqm.pack_int4_blocked(w, block_n=256)
        x = torch.from_numpy(rng.standard_normal((2, 32)).astype(
            np.float32)).bfloat16()
        before = tqm.weight_only_matmul.launches
        out = tqm.weight_only_matmul(x, torch.from_numpy(packed),
                                     torch.from_numpy(sc), "int4",
                                     block_n=256)
        assert out.dtype == torch.bfloat16 and out.shape == (2, 256)
        assert tqm.weight_only_matmul.launches == before


class TestPlainInt8Matmul:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("m,k,n,bn", [(8, 128, 512, 256),
                                          (3, 64, 768, 256),
                                          (5, 96, 768, 384)])
    def test_matches_pallas_interpret(self, m, k, n, bn, dtype):
        rng = np.random.default_rng(m + k + n)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        sc = (np.abs(w).max(0) / 127.0 + 1e-9).astype(np.float32)
        q = np.clip(np.round(w / sc[None, :]), -127, 127).astype(np.int8)
        jdt = getattr(jnp, dtype)
        ref = np.asarray(QM.weight_only_matmul(
            jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(sc), "int8",
            block_n=bn).astype(jnp.float32))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tqm.weight_only_matmul(tx, torch.from_numpy(q),
                                     torch.from_numpy(sc), "int8",
                                     block_n=bn)
        assert got.dtype == tx.dtype and got.shape == (m, n)
        # f32: the same products summed in another order; bf16: both sides
        # accumulate in f32 and round once to bf16 (one ulp of the largest
        # output)
        atol = 2e-5 if dtype == "float32" else \
            2.0 ** -8 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=atol)

    def test_cpu_wrapper_counts_no_int8_launch(self):
        x = torch.zeros(2, 32)
        w = torch.ones(32, 256, dtype=torch.int8)
        before = tqm.weight_only_matmul.int8_launches
        out = tqm.weight_only_matmul(x, w, torch.ones(256), "int8", 256)
        assert out.shape == (2, 256)
        assert tqm.weight_only_matmul.int8_launches == before


def _weights(V, E, H, G, D, L, F, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(ln_scales=[np.ones(E, np.float32) for _ in range(L)],
                qkv_weights=[mk(H + 2 * G, D, E) for _ in range(L)],
                linear_weights=[mk(H * D, E) for _ in range(L)],
                ffn_ln_scales=[np.ones(E, np.float32) for _ in range(L)],
                ffn1_weights=[mk(E, 2 * F) for _ in range(L)],
                ffn2_weights=[mk(F, E) for _ in range(L)],
                embedding=mk(V, E), lm_head=mk(E, V))


def _port_engine(w, **kw):
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    return FusedMultiTransformerEngine(
        engine_weights_from_numpy(w, "cpu", "float32"), device="cpu", **kw)


class TestQuantizedEngines:
    def test_int4_kernel_path_token_exact_vs_dequantized_float(self):
        """The int4 engine (the _mm hook over pack_int4_blocked bytes,
        plain version on the CPU) decodes the SAME tokens as a float
        engine built from the dequantized int4 weights."""
        V, E, H, G, D, L, F = 500, 256, 8, 4, 32, 2, 512
        w = _weights(V, E, H, G, D, L, F)

        def deq(kind, a):
            m = a.reshape(-1, a.shape[-1]).T if kind == "qkv" else a
            packed, sc = QM.pack_int4_blocked(
                m, block_n=QM.pick_block_n(m.shape[1], "int4"))
            q = np.clip(np.round(m / sc[None, :]), -8, 7)
            dq = (q * sc[None, :]).astype(np.float32)
            return dq.T.reshape(a.shape) if kind == "qkv" else dq

        wd = dict(w)
        for kind, key in (("qkv", "qkv_weights"), ("lin", "linear_weights"),
                          ("f1", "ffn1_weights"), ("f2", "ffn2_weights")):
            wd[key] = [deq(kind, a) for a in w[key]]
        kw = dict(num_heads=H, head_dim=D, max_seq_len=64, dtype="float32",
                  norm_type="rmsnorm", activation="swiglu", gqa_group_size=G)
        eng4 = _port_engine(w, weight_quant="int4", **kw)
        assert "_mm" in eng4._kw                # the kernel path
        assert eng4._w["ffn1_weights"][0].dtype == torch.int8
        ids = np.random.default_rng(0).integers(0, V, (2, 8)).astype(
            np.int32)
        ref = _port_engine(wd, **kw).generate(ids, max_new_tokens=8)
        got = eng4.generate(ids, max_new_tokens=8)
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("quant", ["int8", "int4"])
    def test_dequant_path_token_exact_vs_jax(self, quant):
        # lin / ffn1 / ffn2 widths (64, 192, 64) fit no kernel block: both
        # engines take the dequantize-per-use route for every projection
        # (quantize_int4 for int4)
        from paddle_tpu.inference import FusedMultiTransformerEngine as JE
        V, E, H, G, D, L, F = 128, 64, 4, 2, 16, 2, 96
        w = _weights(V, E, H, G, D, L, F, seed=1)
        kw = dict(num_heads=H, head_dim=D, max_seq_len=32, dtype="float32",
                  norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  weight_quant=quant)
        eng = _port_engine(w, **kw)
        assert eng.quant_routes == dict.fromkeys(("qkv", "lin", "f1", "f2"),
                                                 "dequant")
        ids = np.random.default_rng(1).integers(0, V, (2, 6)).astype(
            np.int32)
        ref = JE(w, **kw).generate(ids, max_new_tokens=6)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=6),
                                      ref)

    def test_int4_blocks_follow_the_kernel_and_route_the_rest_to_dequant(
            self):
        """The int4 engine picks each projection's block by the CUDA
        kernel's rule, from the shapes alone (no device enters). A width
        that fits no block sends every projection to the dequant route, as
        the JAX engine falls back: each weight packed by ``quantize_int4``
        in its stored layout, on every device."""
        from paddle_tpu_torch.inference import _quant_blocks
        V, H, G, D, L = 64, 4, 2, 32, 1
        w = _weights(V, 384, H, G, D, L, 192)   # widths 256, 384, 384, 384
        want = {"qkv": 256, "lin": 384, "f1": 384, "f2": 384}
        assert _quant_blocks(w, "int4") == want
        kw = dict(num_heads=H, head_dim=D, max_seq_len=16, dtype="float32",
                  norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  weight_quant="int4")
        eng = _port_engine(w, **kw)
        assert eng._kw["_mm"].blocks == want
        assert set(eng.quant_routes.values()) == {"kernel"}
        w = _weights(V, 96, H, G, D, L, 64)     # lin / ffn2 width 96
        assert _quant_blocks(w, "int4") == dict.fromkeys(
            ("qkv", "lin", "f1", "f2"))
        eng = _port_engine(w, **kw)
        assert set(eng.quant_routes.values()) == {"dequant"}
        for kind, key, axis in (("qkv", "qkv_weights", -1),
                                ("lin", "linear_weights", 0),
                                ("f1", "ffn1_weights", 0),
                                ("f2", "ffn2_weights", 0)):
            want_w, want_s = JF.quantize_int4(w[key][0], axis=axis)
            np.testing.assert_array_equal(eng._w[key][0].numpy(), want_w)
            np.testing.assert_array_equal(
                eng._kw["_mm"].scales[kind][0].numpy(), want_s)

    def test_int8_kernel_route_token_exact_vs_jax(self):
        """Widths every int8 block fits: the port's int8 engine takes the
        _mm hook (the plain weight-only matmul on the CPU) over the JAX
        engine's int8 values and scales, and decodes the JAX int8 engine's
        tokens exactly (f32)."""
        from paddle_tpu.inference import FusedMultiTransformerEngine as JE
        V, E, H, G, D, L, F = 500, 256, 8, 4, 32, 2, 512
        w = _weights(V, E, H, G, D, L, F, seed=2)
        kw = dict(num_heads=H, head_dim=D, max_seq_len=64, dtype="float32",
                  norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  weight_quant="int8")
        eng = _port_engine(w, **kw)
        mm = eng._kw["_mm"]
        assert "_dequant" not in eng._kw
        assert mm.blocks == {"qkv": 512, "lin": 256, "f1": 512, "f2": 256}
        # the JAX engine's values, repacked to [K, N] with [N] scales
        a = w["qkv_weights"][0]
        m = np.moveaxis(a, -1, -1)
        sc = np.abs(m).max(-1, keepdims=True) / 127.0 + 1e-9
        q = np.clip(np.round(m / sc), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(eng._w["qkv_weights"][0].numpy(),
                                      q.reshape(-1, E).T)
        np.testing.assert_array_equal(mm.scales["qkv"][0].numpy(),
                                      sc.reshape(-1))
        assert eng._w["ffn2_weights"][0].shape == (F, E)
        ids = np.random.default_rng(3).integers(0, V, (2, 8)).astype(
            np.int32)
        ref = JE(w, **kw).generate(ids, max_new_tokens=8)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=8),
                                      ref)

    def test_int8_blocks_follow_the_kernel_and_route_the_rest_to_dequant(
            self):
        """int8 blocks by ``pick_block_n(n, "int8")``, from the shapes
        alone. A width that fits no block sends every projection to the
        dequant route with the JAX engine's int8 values in their stored
        layout."""
        from paddle_tpu_torch.inference import _quant_blocks
        V, H, G, D, L = 64, 4, 2, 32, 1
        w = _weights(V, 640, H, G, D, L, 320)   # widths 256, 640, 640, 640
        want = {"qkv": 256, "lin": 128, "f1": 128, "f2": 128}
        assert _quant_blocks(w, "int8") == want
        w = _weights(V, 96, H, G, D, L, 64)     # lin / ffn2 width 96
        assert _quant_blocks(w, "int8") == dict.fromkeys(
            ("qkv", "lin", "f1", "f2"))
        eng = _port_engine(w, num_heads=H, head_dim=D, max_seq_len=16,
                           dtype="float32", norm_type="rmsnorm",
                           activation="swiglu", gqa_group_size=G,
                           weight_quant="int8")
        assert set(eng.quant_routes.values()) == {"dequant"}
        a = w["linear_weights"][0]
        sc = np.abs(a).max(0, keepdims=True) / 127.0 + 1e-9
        np.testing.assert_array_equal(
            eng._w["linear_weights"][0].numpy(),
            np.clip(np.round(a / sc), -127, 127).astype(np.int8))
        np.testing.assert_array_equal(eng._kw["_mm"].scales["lin"][0].numpy(),
                                      sc)

    @pytest.mark.parametrize("quant", ["int8", "int4"])
    def test_tiny_llama_widths_decode_the_jax_tokens(self, quant):
        """``LlamaConfig.tiny``'s widths (E=64, 4 heads, 2 kv heads, D=16,
        F=128): lin and ffn2 (64) fit no kernel block, so every projection
        takes the dequant route, as in the JAX engine; greedy tokens equal
        the JAX engine's in f32."""
        from paddle_tpu.inference import FusedMultiTransformerEngine as JE
        V, E, H, G, D, L, F = 128, 64, 4, 2, 16, 2, 128
        w = _weights(V, E, H, G, D, L, F, seed=4)
        kw = dict(num_heads=H, head_dim=D, max_seq_len=32, dtype="float32",
                  norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
                  weight_quant=quant)
        eng = _port_engine(w, **kw)
        assert set(eng.quant_routes.values()) == {"dequant"}
        ids = np.random.default_rng(4).integers(0, V, (3, 7)).astype(
            np.int32)
        ref = JE(w, **kw).generate(ids, max_new_tokens=8)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=8),
                                      ref)


class TestQuantizedFusedOps:
    """fused_multi_transformer_int8 / _int4 against the JAX ops, f32, MHA
    qkv [3, H, D, E], within the fused stack's tolerance (atol 1e-4)."""

    @staticmethod
    def _float(seed, L=2, E=32, H=4, D=8, F=48):
        rng = np.random.default_rng(seed)

        def mk(*shape):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)

        return rng, dict(
            ln_scales=[np.ones(E, np.float32)] * L,
            qkv_weights=[mk(3, H, D, E) for _ in range(L)],
            linear_weights=[mk(H * D, E) for _ in range(L)],
            ffn_ln_scales=[np.ones(E, np.float32)] * L,
            ffn1_weights=[mk(E, F) for _ in range(L)],
            ffn2_weights=[mk(F, E) for _ in range(L)])

    @staticmethod
    def _run(fn_j, fn_t, w, x, caches, **kw):
        import paddle_tpu as paddle
        T = paddle.to_tensor
        keys = ("ln_scales", "ln_biases", "qkv_weights", "qkv_scales",
                "qkv_biases", "linear_weights", "linear_scales",
                "linear_biases", "ffn_ln_scales", "ffn_ln_biases",
                "ffn1_weights", "ffn1_scales", "ffn1_biases", "ffn2_weights",
                "ffn2_scales", "ffn2_biases")
        jl = [[T(a) for a in w.get(k, [])] if "scales" not in k
              or k.endswith("ln_scales") else list(w[k]) for k in keys]
        tl = [[torch.from_numpy(a) for a in w.get(k, [])] for k in keys]
        jc = [T(c.copy()) for c in caches]
        tc = [torch.from_numpy(c.copy()) for c in caches]
        jo = fn_j(T(x), *jl, cache_kvs=jc, **kw)
        to = fn_t(torch.from_numpy(x), *tl, cache_kvs=tc, **kw)
        np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=0,
                                   atol=1e-4)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)

    def test_int8_matches_jax(self):
        rng, w = self._float(0)

        def q8(a, axis):
            m = np.moveaxis(a, axis, -1)
            sc = np.abs(m).max(-1) / 127.0 + 1e-9
            q = np.clip(np.round(m / sc[..., None]), -127, 127)
            return np.moveaxis(q.astype(np.int8), -1, axis), \
                sc.astype(np.float32)

        for kind, key, axis in (("qkv", "qkv_weights", -1),
                                ("linear", "linear_weights", 0),
                                ("ffn1", "ffn1_weights", 0),
                                ("ffn2", "ffn2_weights", 0)):
            pairs = [q8(a, axis) for a in w[key]]
            w[key] = [p for p, _ in pairs]
            w[f"{kind}_scales"] = [s for _, s in pairs]
        x = rng.standard_normal((2, 5, 32)).astype(np.float32)
        caches = [np.zeros((2, 2, 4, 8, 8), np.float32) for _ in range(2)]
        self._run(JF.fused_multi_transformer_int8,
                  TF.fused_multi_transformer_int8, w, x, caches)

    def test_int4_matches_jax(self):
        rng, w = self._float(1)
        for kind, key, axis in (("qkv", "qkv_weights", -1),
                                ("linear", "linear_weights", 0),
                                ("ffn1", "ffn1_weights", 0),
                                ("ffn2", "ffn2_weights", 0)):
            pairs = [JF.quantize_int4(a, axis=axis) for a in w[key]]
            w[key] = [p for p, _ in pairs]
            w[f"{kind}_scales"] = [s for _, s in pairs]
        x = rng.standard_normal((2, 4, 32)).astype(np.float32)
        caches = [np.zeros((2, 2, 4, 8, 8), np.float32) for _ in range(2)]
        self._run(JF.fused_multi_transformer_int4,
                  TF.fused_multi_transformer_int4, w, x, caches,
                  activation="relu")

    def test_bf16_activations_promote_as_in_jax(self):
        """bf16 activations against the float32 dequantized weights compute
        in float32 (jnp's promotion), so the output dtype is JAX's."""
        import paddle_tpu as paddle
        rng, w = self._float(2, L=1, E=16, H=2, D=8, F=32)
        scales = {}
        for kind, key, axis in (("qkv", "qkv_weights", -1),
                                ("linear", "linear_weights", 0),
                                ("ffn1", "ffn1_weights", 0),
                                ("ffn2", "ffn2_weights", 0)):
            pk, sc = JF.quantize_int4(w[key][0], axis=axis)
            w[key] = [pk]
            scales[kind] = [sc]
        x = rng.standard_normal((2, 3, 16)).astype(np.float32)
        T = paddle.to_tensor

        def args(conv):
            return ([conv(w["ln_scales"][0])], [], [conv(w["qkv_weights"][0])],
                    scales["qkv"], [], [conv(w["linear_weights"][0])],
                    scales["linear"], [], [conv(w["ffn_ln_scales"][0])], [],
                    [conv(w["ffn1_weights"][0])], scales["ffn1"], [],
                    [conv(w["ffn2_weights"][0])], scales["ffn2"], [])

        jo = JF.fused_multi_transformer_int4(T(x).astype("bfloat16"),
                                             *args(T))
        to = TF.fused_multi_transformer_int4(
            torch.from_numpy(x).bfloat16(), *args(torch.from_numpy))
        assert str(jo.dtype).endswith("float32")
        assert to.dtype == torch.float32 and tuple(to.shape) == (2, 3, 16)
        assert bool(torch.isfinite(to).all())


def _knob_tool():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "wo_gemm_knobs", os.path.join(root, "tools", "wo_gemm_knobs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


class TestKnobTool:
    """``tools/wo_gemm_knobs.py`` calls the tree's build with the GEMM's
    two plan knobs as launch arguments (and other builds, such as the
    parent's, at the rule), and measures only on a card."""

    def test_refuses_without_a_card(self):
        import os
        import subprocess
        import sys
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        tool = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "wo_gemm_knobs.py")
        r = subprocess.run([sys.executable, tool, "--set", "1,auto"],
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 2
        assert "CUDA is not available" in r.stderr and r.stdout == ""

    @pytest.mark.parametrize("waves,bn", [(1, "auto"), (3, "64"),
                                          (2, "128")])
    def test_rewrites_exactly_the_two_knob_lines(self, waves, bn):
        """The knobs no longer rewrite the source: ``--set WAVES,BN``
        becomes exactly the two launch arguments of the tree's build (0
        keeps a knob's rule), and the source's two rule lines stand as
        they are."""
        import os
        tool = _knob_tool()
        got = tool.settings_of([f"{waves},{bn}"], ["parent"])
        assert got == {"tree": ("tree", 0, 0),
                       f"w{waves}_bn{bn}": ("tree",
                                            0 if bn == "auto" else int(bn),
                                            waves),
                       "parent": ("parent", 0, 0)}
        assert not hasattr(tool, "variant_source")
        with open(os.path.join(tool.SRC, "weight_only_matmul.cu")) as f:
            tree = f.read()
        assert tree.count("constexpr int TC_WAVES = 2;") == 1
        assert tree.count("return cdiv(M, bm) * (N / 128) < sms ? 64 : 128;") \
            == 1
