"""The PyTorch port's serving slice held against the JAX package on the
CPU: dense ``generate()`` and ``ContinuousBatchingEngine`` in every
scheduler mode must give the JAX engine's tokens, step counts,
allocator high-water and host counters exactly (greedy decoding, f32).

The JAX engine runs its ragged Pallas kernel in interpret mode, as the
JAX package's own serving tests do; the port runs the plain PyTorch
version of its kernels (CPU tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    yield
    fa._INTERPRET = old


def _weights(seed, V, E, H, G, D, L, F, scale=0.05):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        qkv_weights=[mk(H + 2 * G, D, E) for _ in range(L)],
        linear_weights=[mk(H * D, E) for _ in range(L)],
        ffn_ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        ffn1_weights=[mk(E, 2 * F) for _ in range(L)],
        ffn2_weights=[mk(F, E) for _ in range(L)],
        embedding=mk(V, E), lm_head=mk(E, V))


_ENGINES = {}


def _engines(name):
    """(jax engine, port engine, V) for a named config, built once per
    process: the JAX engine's compiled step programs are instance-held,
    so sharing it keeps the interpret-mode compile bill to one per
    bucket for the whole file."""
    if name in _ENGINES:
        return _ENGINES[name]
    from paddle_tpu.inference import FusedMultiTransformerEngine as JaxEngine
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    if name == "bench_cpu":       # bench.py's CPU serving shape
        V, E, H, G, D, L, F, smax = 128, 64, 4, 2, 16, 2, 128, 32
    else:                         # the serving tests' tiny engine
        V, E, H, G, D, L, F, smax = 128, 64, 4, 2, 16, 2, 96, 32
    w = _weights(0, V, E, H, G, D, L, F)
    kw = dict(num_heads=H, head_dim=D, max_seq_len=smax, dtype="float32",
              norm_type="rmsnorm", activation="swiglu", gqa_group_size=G)
    je = JaxEngine(w, **kw)
    te = FusedMultiTransformerEngine(
        engine_weights_from_numpy(w, "cpu", "float32"), device="cpu", **kw)
    _ENGINES[name] = (je, te, V)
    return _ENGINES[name]


class TestGenerate:
    def test_greedy_tokens_exact_vs_jax(self):
        je, te, V = _engines("bench_cpu")
        ids = np.random.default_rng(0).integers(0, V, (2, 16)).astype(
            np.int32)
        ref = je.generate(ids, max_new_tokens=8)
        got = te.generate(ids, max_new_tokens=8)
        assert got.shape == (2, 8)
        np.testing.assert_array_equal(got, ref)

    def test_ragged_prompt_lens_exact_vs_jax(self):
        je, te, V = _engines("bench_cpu")
        ids = np.random.default_rng(1).integers(0, V, (3, 12)).astype(
            np.int32)
        lens = [5, 12, 9]
        ref = je.generate(ids, max_new_tokens=6, prompt_lens=lens)
        got = te.generate(ids, max_new_tokens=6, prompt_lens=lens)
        np.testing.assert_array_equal(got, ref)

    def test_sampled_deterministic_per_seed_and_valid(self):
        _, te, V = _engines("bench_cpu")
        ids = np.random.default_rng(2).integers(0, V, (2, 8)).astype(
            np.int32)
        a = te.generate(ids, 10, temperature=0.8, top_p=0.9, seed=7)
        b = te.generate(ids, 10, temperature=0.8, top_p=0.9, seed=7)
        c = te.generate(ids, 10, temperature=5.0, top_p=1.0, seed=8)
        np.testing.assert_array_equal(a, b)
        for out in (a, c):
            assert out.shape == (2, 10)
            assert out.min() >= 0 and out.max() < V
        greedy = te.generate(ids, 10)
        assert not np.array_equal(c, greedy)     # sampling really sampled

    def test_rejects_overlong_request(self):
        _, te, V = _engines("bench_cpu")
        with pytest.raises(ValueError):
            te.generate(np.zeros((1, 30), np.int32), max_new_tokens=8)


def _drive(pkg, eng, V, mode, script):
    """Run one scheduler script on the JAX (`pkg` == "jax") or the port's
    ContinuousBatchingEngine; returns everything the two must agree on."""
    if pkg == "jax":
        from paddle_tpu.incubate.nn import (ContinuousBatchingEngine,
                                            GenerationRequest)
    else:
        from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                                  GenerationRequest)
    kw = dict(num_blocks=9, block_size=8, max_batch=2)
    kw.update(mode)
    cb = ContinuousBatchingEngine(eng, **kw)
    free0 = cb.allocator.num_free
    script(cb, GenerationRequest, V)
    cb.run()
    hs = cb.host_stats()
    hs.pop("phases")
    return {
        "tokens": {k: list(v) for k, v in cb.finished.items()},
        "status": {k: (v.status, v.preemptions)
                   for k, v in cb.finished.items()},
        "steps": cb._step_count,
        "high_water": cb.allocator.high_water,
        "buckets": sorted(cb._seen_buckets),
        "host": hs,
        "cache": dict(cb.cache_stats),
        "leak_free": cb.allocator.num_free + cb.allocator.num_pooled
        == free0,
    }


def _ragged_script(cb, Req, V):
    rng = np.random.default_rng(3)
    for i, (p, n) in enumerate([(5, 4), (11, 3), (3, 6), (8, 2)]):
        cb.submit(Req(rng.integers(1, V, p).astype(np.int32), n,
                      request_id=f"r{i}"))


def _repeat_script(cb, Req, V):
    # self-repeating prompts: the prompt-lookup drafter hits constantly
    rng = np.random.default_rng(4)
    for i, n in enumerate((7, 9)):
        pat = rng.integers(1, V, 3).astype(np.int32)
        cb.submit(Req(np.tile(pat, 4)[:10], n, request_id=f"s{i}"))


def _preamble_script(cb, Req, V):
    # shared 16-token system preamble: later requests map its blocks
    rng = np.random.default_rng(5)
    pre = rng.integers(1, V, 16).astype(np.int32)
    for i, (p, n) in enumerate([(3, 4), (5, 3), (2, 5)]):
        cb.submit(Req(np.concatenate([pre, rng.integers(1, V, p).astype(
            np.int32)]), n, request_id=f"p{i}"))


def _preempt_cancel_script(cb, Req, V):
    # a low-priority hog mid-decode is preempted by a front-door request,
    # a queued request is cancelled, an active one cancelled mid-flight
    rng = np.random.default_rng(6)
    cb.submit(Req(rng.integers(1, V, 10).astype(np.int32), 12,
                  request_id="hog", priority=2))
    for _ in range(4):
        cb.step()
    cb.submit(Req(rng.integers(1, V, 10).astype(np.int32), 6,
                  request_id="vip", priority=0))
    cb.submit(Req(rng.integers(1, V, 4).astype(np.int32), 3,
                  request_id="gone", priority=1))
    assert cb.cancel("gone") is True
    cb.submit(Req(rng.integers(1, V, 6).astype(np.int32), 8,
                  request_id="late", priority=1))
    for _ in range(3):
        cb.step()
    cb.cancel("vip")


CB_MODES = [
    pytest.param(dict(), _ragged_script, id="default"),
    pytest.param(dict(prefill_chunk=4, token_budget=6), _ragged_script,
                 id="chunk4_budget6"),
    pytest.param(dict(prefill_chunk=1), _ragged_script, id="chunk1"),
    pytest.param(dict(spec_k=2), _repeat_script, id="spec2"),
    pytest.param(dict(prefix_cache=True, prefill_chunk=8), _preamble_script,
                 id="prefix"),
    pytest.param(dict(num_blocks=5), _preempt_cancel_script,
                 id="preempt_cancel"),
    pytest.param(dict(host_fastpath=False), _ragged_script,
                 id="legacy_host_path"),
    pytest.param(dict(overlap_fetch=True, spec_k=2), _repeat_script,
                 id="overlap_fetch"),
]


class TestContinuousBatching:
    @pytest.mark.parametrize("mode,script", CB_MODES)
    def test_matches_jax_scheduler(self, mode, script):
        je, te, V = _engines("tiny")
        ref = _drive("jax", je, V, mode, script)
        got = _drive("torch", te, V, mode, script)
        assert got == ref
        assert got["leak_free"]

    def test_token_exact_vs_dense_generate(self):
        _, te, V = _engines("tiny")
        got = _drive("torch", te, V, dict(prefill_chunk=4), _ragged_script)
        rng = np.random.default_rng(3)
        for i, (p, n) in enumerate([(5, 4), (11, 3), (3, 6), (8, 2)]):
            prompt = rng.integers(1, V, p).astype(np.int32)
            ref = te.generate(prompt[None, :], max_new_tokens=n)[0]
            assert got["tokens"][f"r{i}"] == ref.tolist()

    def test_paged_programs_update_caches_in_place(self):
        _, te, V = _engines("tiny")
        from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                                  GenerationRequest)
        cb = ContinuousBatchingEngine(te, num_blocks=9, block_size=8,
                                      max_batch=2)
        before = [c.data_ptr() for c in cb.caches]
        cb.submit(GenerationRequest(np.arange(1, 6), 3))
        cb.run()
        assert [c.data_ptr() for c in cb.caches] == before
        assert float(cb.caches[0].abs().sum()) > 0.0

    def test_accounting_and_dispatch_hooks(self):
        je, te, V = _engines("tiny")
        assert te.kv_device_block_bytes(8) == je.kv_device_block_bytes(8)
        assert te.tp_step_comm_bytes(2, 4) == je.tp_step_comm_bytes(2, 4)
        caches = te.new_paged_caches(5, 8)
        assert len(caches) == 2 and tuple(caches[0].shape) == (2, 2, 5, 8,
                                                                16)
        from paddle_tpu_torch.inference import set_dispatch_delay
        from paddle_tpu_torch.observability import tracing
        assert set_dispatch_delay("paged_copy", 0.001) is None
        try:
            tracing.get_tracer().clear()
            te._paged_copy(caches, 1, 2)
            names = [s["name"] for s in tracing.get_tracer().spans()]
            assert "paged_copy" in names
        finally:
            assert set_dispatch_delay("paged_copy", None) == 0.001

    def test_sampled_serving_deterministic_per_seed(self):
        _, te, V = _engines("tiny")
        from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                                  GenerationRequest)

        def run(seed):
            cb = ContinuousBatchingEngine(te, num_blocks=9, block_size=8,
                                          max_batch=2, temperature=0.9,
                                          top_p=0.95, seed=seed)
            rng = np.random.default_rng(8)
            for i in range(3):
                cb.submit(GenerationRequest(rng.integers(1, V, 6), 5,
                                            request_id=i))
            return {k: list(v) for k, v in cb.run().items()}

        a, b = run(11), run(11)
        assert a == b
        assert all(0 <= t < V for v in a.values() for t in v)
