"""The port's serving autotuner (``paddle_tpu_torch.ops.autotune``) held
against the JAX package's (``paddle_tpu/ops/pallas/autotune.py``) on the
CPU, mirroring the classes of ``tests/test_autotune.py``:

* the shape-class and bucket keys and the pack / prefill_chunk candidate
  family are JAX's;
* the model-ranked sweep over the committed tiny workload gives JAX's
  pack / prefill_chunk winners (and intensities and trial counts), twice
  bit for bit, and round-trips through a byte-stable file;
* a JAX-schema, foreign, broken or other-card cache loads as None and the
  engines keep their defaults;
* the generic harness times, caches, persists and skips a failing
  candidate;
* the engines pick the winners up at construction only (the cache
  counters move there and nowhere else), the scheduler clamping pack;
* every split the knob gives K3's and K7's plans computes the unsplit
  attention (the plain split arithmetic against the plain version, f32);
* K4's plan knobs: the Python form of the C rule at 0, each override the
  plan the C source makes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.ops.pallas import autotune as jat  # noqa: E402
from paddle_tpu_torch.observability import instrument  # noqa: E402
from paddle_tpu_torch.ops import autotune as at  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import quant_matmul as qm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_ATOL = 1e-5     # f32: the same softmax summed in split order
H100_SMS = 132

# tools/serve_bench.py's committed tiny workload: (prompt, new tokens)
WORKLOAD = [(5, 3), (11, 4), (3, 5), (8, 2)]
LENS = [p + n for p, n in WORKLOAD]


def _sweep(mod, cache=None):
    for chunk in (None, 8):
        cache = mod.sweep_ragged_serve(2, 2, 16, 8, LENS, chunk=chunk,
                                       measure=False, cache=cache)
    return cache


def _knobs(d):
    return {k: d[k] for k in ("pack", "prefill_chunk")}


class TestCacheKeys:
    @pytest.mark.parametrize("args", [(2, 2, 8, 16, "float32"),
                                      (8, 1, 16, 128, "bfloat16"),
                                      (4, 4, 32, 64, "float16")])
    def test_shape_class_equals_jax(self, args):
        assert at.serve_shape_class(*args) == jat.serve_shape_class(*args)
        # a torch dtype spells as its name
        tdt = getattr(torch, args[-1])
        assert at.serve_shape_class(*args[:-1], tdt) == \
            jat.serve_shape_class(*args)

    @pytest.mark.parametrize("t,c", [(8, 1), (16, 8), (64, 64)])
    def test_bucket_key_equals_jax(self, t, c):
        assert at.serve_bucket_key(t, c) == jat.serve_bucket_key(t, c)

    @pytest.mark.parametrize("batch,chunk", [(4, None), (4, 8), (8, 64),
                                             (3, 300)])
    def test_candidate_family_equals_jax(self, batch, chunk):
        got = at.ragged_candidates(batch, 2, chunk=chunk)
        ref = jat.ragged_candidates(batch, 2, chunk=chunk)
        # the split waves stand in buffer_depth's place, three of each
        assert [_knobs(c) for c in got] == [_knobs(c) for c in ref]
        assert [c["split_waves"] for c in got] == \
            [c["buffer_depth"] for c in ref]


class TestSweep:
    def test_winners_equal_jax_and_the_committed_file(self):
        got, ref = _sweep(at), _sweep(jat)
        sec = got["shapes"]["kvh2_g2_bs8_d16_float32"]
        rsec = ref["shapes"]["kvh2_g2_bs8_d16_float32"]
        assert _knobs(sec["winner"]) == _knobs(rsec["winner"])
        fields = ("pack", "prefill_chunk", "intensity", "trials",
                  "measured", "suspect")
        assert {b: {f: v[f] for f in fields}
                for b, v in sec["buckets"].items()} == \
            {b: {f: v[f] for f in fields} for b, v in rsec["buckets"].items()}
        with open(os.path.join(REPO, "tools", "serve_autotune.json")) as f:
            committed = json.load(f)["shapes"]["kvh2_g2_bs8_d16_float32"]
        assert _knobs(sec["winner"]) == _knobs(committed["winner"])

    def test_cpu_sweep_is_deterministic(self):
        assert _sweep(at) == _sweep(at)

    def test_persistence_roundtrip(self, tmp_path):
        cache = _sweep(at)
        p = tmp_path / "serve.json"
        at.save_serve_cache(cache, str(p))
        loaded = at.load_serve_cache(str(p))
        assert loaded == cache and loaded["schema"] == at.SERVE_SCHEMA
        for b in loaded["shapes"]["kvh2_g2_bs8_d16_float32"][
                "buckets"].values():
            assert b["trials"] > 0 and not b["suspect"] and \
                b["card"] is None and b["skipped"] == 0

    def test_save_is_byte_stable(self, tmp_path):
        p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
        at.save_serve_cache(_sweep(at), str(p1))
        at.save_serve_cache(_sweep(at), str(p2))
        assert p1.read_bytes() == p2.read_bytes()

    def test_decode_bucket_never_votes_prefill_chunk_down(self):
        win = _sweep(at)["shapes"]["kvh2_g2_bs8_d16_float32"]["winner"]
        assert win["prefill_chunk"] > 1

    def test_a_measured_sweep_takes_split_waves_alone(self, monkeypatch):
        """With ``measure`` the candidates are the waves at the default
        pack and the bucket's own chunk: the entries carry one trial a
        wave and the bucket's pack and chunk, and the vote keeps the
        prefill bucket's chunk (the CPU stands in for the card: plans
        timed on the host clock, the SM count stubbed)."""
        class Props:
            multi_processor_count = 132
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: Props())
        cache = None
        for chunk, lens in ((None, [1, 40, 17, 9]), (8, [8, 30, 3, 12])):
            cache = at.sweep_ragged_serve(2, 2, 16, 8, lens, chunk=chunk,
                                          waves=(1, 2, 4), reps=1,
                                          measure=True, cache=cache,
                                          device="cpu")
        sec = cache["shapes"]["kvh2_g2_bs8_d16_float32"]
        assert sorted(b["prefill_chunk"] for b in sec["buckets"].values()) \
            == [1, 8]
        for b in sec["buckets"].values():
            assert b["measured"] and b["trials"] == 3 and b["skipped"] == 0
            assert b["pack"] == pa.default_pack(4, 2)
            assert sorted(b["plan_us"]) == ["1", "2", "4"]
        assert sec["winner"]["pack"] == pa.default_pack(4, 2)
        assert sec["winner"]["prefill_chunk"] == 8

    @pytest.mark.parametrize("batch,max_nb", [(1, 64), (4, 32), (64, 8)])
    def test_split_term_ranks_the_waves(self, batch, max_nb):
        """The model's split term is the plan's waves of blocks times the
        pages a block walks plus the workspace: the winner's waves give
        the smallest term, ties to the rule's."""
        lens = [max_nb * 16] * batch
        cache = at.sweep_ragged_serve(8, 1, 128, 16, lens, chunk=None,
                                      dtype="bfloat16", measure=False)
        win = cache["shapes"]["kvh8_g1_bs16_d128_bfloat16"]["buckets"]
        (entry,) = win.values()
        terms = {w: at.split_cost_model(batch, 1, 8, 1, max_nb, 16, 128, 2,
                                        w)["split_s"] for w in (1, 2, 4)}
        best = min(terms.values())
        assert terms[entry["split_waves"]] == best
        if terms[pa.SPLIT_WAVES] == best:
            assert entry["split_waves"] == pa.SPLIT_WAVES


def _card_cache(card):
    sweep = _sweep(at)
    for b in sweep["shapes"]["kvh2_g2_bs8_d16_float32"]["buckets"].values():
        b.update(measured=True, card=card)
    return sweep


class TestStaleCacheDegrades:
    def test_foreign_or_broken_caches_reject_as_none(self, tmp_path):
        good = _sweep(at)
        assert at.load_serve_cache(good) is good          # dict passthrough
        assert at.load_serve_cache(dict(good, schema=jat.SERVE_SCHEMA)) \
            is None
        assert at.load_serve_cache(_sweep(jat)) is None   # a JAX cache
        assert at.load_serve_cache(
            os.path.join(REPO, "tools", "serve_autotune.json")) is None
        assert at.load_serve_cache({"schema": at.SERVE_SCHEMA}) is None
        assert at.load_serve_cache(
            {"schema": at.SERVE_SCHEMA, "shapes": "nope"}) is None
        bad = {"schema": at.SERVE_SCHEMA, "shapes": {
            "kvh2_g2_bs8_d16_float32": {
                "winner": {"pack": 0, "prefill_chunk": 8, "split_waves": 2},
                "buckets": {}}}}
        assert at.load_serve_cache(bad) is None
        bad_wo = dict(good, wo_gemm={"int8": {"mc16_k64_n128_bfloat16": {
            "bn": 96, "waves": 2, "card": None}}})
        assert at.load_serve_cache(bad_wo) is None
        # a table keyed by exact M, or by an M that is no class, is stale
        for key in ("m8_k64_n128_bfloat16", "mc8_k64_n128_bfloat16",
                    "mc96_k64_n128_bfloat16", "mc16_k64_bfloat16"):
            stale = dict(good, wo_gemm={"int8": {key: {
                "bn": 64, "waves": 2, "card": None}}})
            assert at.load_serve_cache(stale) is None, key
        assert at.load_serve_cache(str(tmp_path / "missing.json")) is None
        garbled = tmp_path / "garbled.json"
        garbled.write_text("{not json")
        assert at.load_serve_cache(str(garbled)) is None

    def test_a_cache_from_another_card_is_none(self):
        cache = _card_cache("NVIDIA H100 80GB HBM3")
        assert at.load_serve_cache(cache, card="NVIDIA H100 80GB HBM3") \
            is cache
        assert at.load_serve_cache(cache, card="NVIDIA A100-SXM4-80GB") \
            is None
        assert at.load_serve_cache(cache) is None         # read on the CPU
        wo = dict(_sweep(at), wo_gemm={"int4": {"mc16_k1024_n1024_bfloat16": {
            "bn": 64, "waves": 4, "card": "NVIDIA H100 80GB HBM3"}}})
        assert at.load_serve_cache(wo, card="NVIDIA H100 80GB HBM3") is wo
        assert at.load_serve_cache(wo, card="another card") is None

    @pytest.mark.parametrize("which", ["jax", "foreign", "card"])
    def test_engines_degrade_to_defaults(self, tmp_path, which):
        if which == "jax":
            tune = os.path.join(REPO, "tools", "serve_autotune.json")
        elif which == "foreign":
            tune = str(tmp_path / "stale.json")
            with open(tune, "w") as f:
                f.write('{"schema": "somebody_else/9", "shapes": {}}')
        else:
            tune = _card_cache("NVIDIA H100 80GB HBM3")
        eng = _engine(autotune_cache=tune)
        assert eng.split_waves is None and eng._kw["_split_waves"] is None
        cb = _cb(eng, prefill_chunk=4, autotune_cache=tune)
        assert cb.prefill_chunk == 4 and cb._pack == pa.default_pack(4, 2)


class TestGenericHarness:
    def test_times_then_caches_then_persists(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                           str(tmp_path / "at.json"))
        monkeypatch.setattr(at, "_mem", None)
        calls = []

        def run(cand):
            calls.append(cand)
            return torch.ones(4) * cand[0]

        key, cands = "unit_gemm:m8", [(1, "a"), (2, "b")]
        win = at.autotune(key, cands, run, reps=1)
        assert win in cands
        n = len(calls)
        assert n >= 2 * len(cands)          # warm-up + timed rep each
        assert at.autotune(key, cands, run, reps=1) == win
        assert len(calls) == n              # in-memory hit
        monkeypatch.setattr(at, "_mem", None)
        assert at.autotune(key, cands, run, reps=1) == win
        assert len(calls) == n              # from the file
        assert json.loads((tmp_path / "at.json").read_text())[key] == \
            list(win)

    def test_failing_candidates_are_skipped_and_counted(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                           str(tmp_path / "at.json"))
        monkeypatch.setattr(at, "_mem", None)

        def run(cand):
            if cand == "bad":
                raise ValueError("tile rejected")
            return torch.zeros(2)

        before = at.cache_stats()["skipped"]
        assert at.autotune("unit_skip:x", ["bad", "ok"], run, reps=1) == "ok"
        assert at.cache_stats()["skipped"] == before + 1
        with pytest.raises(RuntimeError, match="every candidate"):
            at.autotune("unit_all_bad:x", ["bad"], run, reps=1)

    def test_metric_label_is_the_key_family(self):
        assert at._kernel_label("wo_gemm_int8:m8_k64_n128_bfloat16") == \
            "wo_gemm_int8"
        assert at.wo_gemm_key("int4", 8, 1024, 5632, torch.bfloat16) == \
            at.wo_gemm_key("int4", 16, 1024, 5632, torch.bfloat16) == \
            "wo_gemm_int4:mc16_k1024_n5632_bfloat16"
        assert at.wo_gemm_key("int8", 200, 64, 128, "float32") == \
            "wo_gemm_int8:mc256_k64_n128_float32"

    def test_wo_gemm_table_reads_back(self):
        cache = dict(_sweep(at), wo_gemm={"int8": {
            "mc16_k1024_n5632_bfloat16": {"bn": 64, "waves": 4, "m": 8,
                                          "card": None},
            "mc512_k1024_n5632_bfloat16": {"bn": 128, "waves": 2, "m": 512,
                                           "card": None},
            "mc16_k1024_n5632_float16": {"bn": 128, "waves": 1,
                                         "card": None}}})
        assert at.load_serve_cache(cache) is cache
        assert at.wo_gemm_plans(cache, "int8", "bfloat16") == \
            {(16, 1024, 5632): (64, 4), (512, 1024, 5632): (128, 2)}
        assert at.wo_gemm_plans(cache, "int4", "bfloat16") == {}
        with pytest.raises(ValueError, match="on the card"):
            at.sweep_wo_gemm([(8, 128, 128)], "int8", device="cpu")


# -- engine pickup -------------------------------------------------------------

def _mk_weights(seed, V, E, H, G, D, L, F):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        qkv_weights=[mk(H + 2 * G, D, E) for _ in range(L)],
        linear_weights=[mk(H * D, E) for _ in range(L)],
        ffn_ln_scales=[np.ones(E, np.float32) for _ in range(L)],
        ffn1_weights=[mk(E, 2 * F) for _ in range(L)],
        ffn2_weights=[mk(F, E) for _ in range(L)],
        embedding=mk(V, E), lm_head=mk(E, V))


def _engine(**kw):
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)
    return FusedMultiTransformerEngine(
        engine_weights_from_numpy(_mk_weights(0, 128, 64, 4, 2, 16, 2, 96),
                                  "cpu", "float32"),
        num_heads=4, head_dim=16, max_seq_len=64, dtype="float32",
        norm_type="rmsnorm", activation="swiglu", gqa_group_size=2,
        device="cpu", **kw)


def _cb(eng, **kw):
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    ckw = dict(num_blocks=24, block_size=8, max_batch=4)
    ckw.update(kw)
    return ContinuousBatchingEngine(eng, **ckw)


def _pickup_cache(pack=2, prefill_chunk=8, split_waves=4):
    win = {"pack": pack, "prefill_chunk": prefill_chunk,
           "split_waves": split_waves}
    return {"schema": at.SERVE_SCHEMA, "kernel": "ragged_paged_attention",
            "shapes": {"kvh2_g2_bs8_d16_float32": {
                "winner": dict(win), "buckets": {"t16_c8": dict(win)}}}}


def _counts():
    return (instrument.autotune_cache_hits().value,
            instrument.autotune_cache_misses().value)


class TestEnginePickup:
    def test_winner_lookup_prefers_exact_bucket(self):
        cache = _pickup_cache()
        cache["shapes"]["kvh2_g2_bs8_d16_float32"]["buckets"]["t16_c8"][
            "split_waves"] = 1
        exact = at.serve_winner(cache, "kvh2_g2_bs8_d16_float32",
                                bucket="t16_c8")
        assert exact["split_waves"] == 1
        agg = at.serve_winner(cache, "kvh2_g2_bs8_d16_float32",
                              bucket="t64_c4")
        assert agg["split_waves"] == 4
        assert at.serve_winner(cache, "kvh8_g1_bs8_d128_float32") is None

    def test_engine_ctor_matches_ignoring_block_size(self):
        cfg = at.serve_winner_for_engine(_pickup_cache(), 2, 2, 16,
                                         "float32")
        assert cfg["split_waves"] == 4
        assert at.serve_winner_for_engine(_pickup_cache(), 2, 2, 128,
                                          "float32") is None

    def test_engine_closes_the_tuned_split_waves_into_its_steps(self):
        eng = _engine(autotune_cache=_pickup_cache())
        assert eng.split_waves == 4 and eng._kw["_split_waves"] == 4
        assert _engine().split_waves is None

    def test_cb_picks_pack_and_chunk_without_resweep(self, monkeypatch):
        def boom(*a, **kw):
            raise AssertionError("engine construction re-swept")

        monkeypatch.setattr(at, "sweep_ragged_serve", boom)
        cb = _cb(_engine(autotune_cache=_pickup_cache()),
                 autotune_cache=_pickup_cache())
        assert cb._pack == 2 and cb.prefill_chunk == 8

    def test_cb_clamps_tuned_pack_to_max_batch(self):
        cb = _cb(_engine(), autotune_cache=_pickup_cache(pack=16))
        assert cb._pack == 4

    def test_cache_counters_move_at_construction_only(self):
        from paddle_tpu_torch.incubate.nn import GenerationRequest
        c0 = _counts()
        eng = _engine(autotune_cache=_pickup_cache())
        cb = _cb(eng, autotune_cache=_pickup_cache())
        c1 = _counts()
        assert (c1[0] - c0[0], c1[1] - c0[1]) == (2, 0)
        rng = np.random.default_rng(7)
        for p, n in WORKLOAD:
            cb.submit(GenerationRequest(
                rng.integers(1, 128, p).astype(np.int32), n))
        cb.run()
        assert _counts() == c1
        # a cache without this shape class: one miss each, still at
        # construction
        other = _pickup_cache()
        other["shapes"] = {"kvh8_g1_bs8_d16_float32":
                           other["shapes"]["kvh2_g2_bs8_d16_float32"]}
        _cb(_engine(autotune_cache=other), autotune_cache=other)
        c2 = _counts()
        assert (c2[0] - c1[0], c2[1] - c1[1]) == (0, 2)

    def test_tuned_tokens_equal_untuned(self):
        """The knob changes the card's split plan only: on the CPU the
        tuned and untuned engines serve the same tokens."""
        from paddle_tpu_torch.incubate.nn import GenerationRequest
        out = []
        for tune in (None, _pickup_cache(split_waves=1)):
            cb = _cb(_engine(autotune_cache=tune), autotune_cache=tune)
            rng = np.random.default_rng(7)
            reqs = [GenerationRequest(
                rng.integers(1, 128, p).astype(np.int32), n)
                for p, n in WORKLOAD]
            for r in reqs:
                cb.submit(r)
            res = cb.run()
            out.append([list(map(int, res[r.request_id])) for r in reqs])
        assert out[0] == out[1]


# -- the split knob's plans: every split computes the unsplit attention --------

def _paged_inputs(seed, b, c, h, kvh, max_nb, bs, d):
    rng = np.random.default_rng(seed)
    nb = b * max_nb + 3
    q = torch.as_tensor(rng.standard_normal((b, c, h, d)), dtype=torch.float32)
    kc = torch.as_tensor(rng.standard_normal((kvh, nb, bs, d)),
                         dtype=torch.float32)
    vc = torch.as_tensor(rng.standard_normal((kvh, nb, bs, d)),
                         dtype=torch.float32)
    tables = torch.as_tensor(rng.permutation(nb)[:b * max_nb].reshape(
        b, max_nb).astype(np.int32))
    lens = rng.integers(1, max_nb * bs + 1, b)
    lens[0] = max_nb * bs                  # one walk over every page
    qls = np.minimum(rng.integers(1, c + 1, b), lens)
    return q, kc, vc, tables, torch.as_tensor(lens), torch.as_tensor(qls)


# (B, C, H, KVH, max_nb, BS, D): K3's serving decode and prefill steps and
# a long walk under one wave
K3_SHAPES = [(4, 1, 8, 2, 32, 16, 32), (2, 8, 4, 2, 16, 16, 32),
             (1, 1, 4, 4, 64, 8, 32), (3, 64, 4, 1, 12, 16, 32)]
# (B, H, KVH, max_nb, BS, D): K7's decode steps
K7_SHAPES = [(8, 8, 8, 32, 16, 32), (2, 16, 1, 48, 16, 32),
             (64, 8, 8, 8, 16, 32)]


class TestSplitKnob:
    @pytest.mark.parametrize("waves", [1, 2, 4])
    @pytest.mark.parametrize("shape", K3_SHAPES)
    def test_ragged_splits_equal_the_unsplit_plain(self, shape, waves):
        b, c, h, kvh, max_nb, bs, d = shape
        plan = pa.ragged_plan(b, c, h, kvh, max_nb, bs, d, torch.float32,
                              H100_SMS, waves)
        q, kc, vc, tables, lens, qls = _paged_inputs(
            sum(shape) + waves, b, c, h, kvh, max_nb, bs, d)
        ref = pa.ragged_paged_attention_plain(q, kc, vc, tables, lens,
                                              q_lens=qls)
        got = pa.ragged_split_plain(q, kc, vc, tables, lens, plan["splits"],
                                    plan["pages_per_split"], q_lens=qls)
        torch.testing.assert_close(got, ref, atol=SPLIT_ATOL, rtol=0)
        # the CPU wrapper takes the knob and runs the plain version
        same = pa.ragged_paged_attention(q, kc, vc, tables, lens,
                                         q_lens=qls, split_waves=waves)
        assert torch.equal(same, ref)

    @pytest.mark.parametrize("waves", [1, 2, 4])
    @pytest.mark.parametrize("shape", K7_SHAPES)
    def test_decode_splits_equal_the_unsplit_plain(self, shape, waves):
        b, h, kvh, max_nb, bs, d = shape
        plan = pa.decode_plan(b, h, kvh, max_nb, bs, d, torch.float32,
                              H100_SMS, waves)
        q, kc, vc, tables, lens, _ = _paged_inputs(
            sum(shape) + waves, b, 1, h, kvh, max_nb, bs, d)
        q = q[:, 0].contiguous()
        ref = pa.paged_attention_plain(q, kc, vc, tables, lens)
        got = pa.paged_attention_split_plain(
            q, kc, vc, tables, lens, plan["splits"], plan["pages_per_split"])
        torch.testing.assert_close(got, ref, atol=SPLIT_ATOL, rtol=0)

    def test_the_rule_is_two_waves(self):
        for unsplit, max_nb in ((8, 32), (64, 8), (1, 64), (300, 4)):
            assert pa.split_pages(unsplit, max_nb, H100_SMS) == \
                pa.split_pages(unsplit, max_nb, H100_SMS, pa.SPLIT_WAVES)
        # more waves never cut the walk into fewer pieces
        for unsplit in (1, 4, 16, 64):
            s = [pa.split_pages(unsplit, 64, H100_SMS, w)[0]
                 for w in (1, 2, 4)]
            assert s == sorted(s)
        with pytest.raises(ValueError, match="waves"):
            pa.split_pages(8, 32, H100_SMS, 0)


# -- K4's plan knobs ---------------------------------------------------------------

# the smoke's 12 serving shapes: M 8 / 128 / 512 x the flagship's 4
# projections (E=1024, F=2816, 16 + 2 x 8 heads of 64)
SERVE_KN = [(1024, 2048), (1024, 1024), (1024, 5632), (2816, 1024)]


class TestGemmKnobs:
    def test_m_class_follows_the_rule_row_tile(self):
        """Each M falls in a class at least as large, of the rule's row
        tile, whose row-tile count is a power of two at most twice M's;
        a class is its own class; a paged step's M (8 batch rows times a
        pow2 slab width of 1 to 64) falls in one of five classes."""
        for m in range(1, 1100):
            c = qm.m_class(m)
            bm = qm.make_plan(m, 1024, 1024, torch.bfloat16, H100_SMS)["bm"]
            assert c >= m and qm.m_class(c) == c
            assert qm.make_plan(c, 1024, 1024, torch.bfloat16,
                                H100_SMS)["bm"] == bm
            tiles, ctiles = -(-m // bm), c // bm
            assert ctiles & (ctiles - 1) == 0 and ctiles < 2 * tiles
        assert sorted({qm.m_class(8 * w) for w in (1, 2, 4, 8, 16, 32,
                                                   64)}) == \
            [16, 64, 128, 256, 512]

    @pytest.mark.parametrize("m", [8, 128, 512])
    @pytest.mark.parametrize("k,n", SERVE_KN)
    def test_zero_is_the_rule(self, m, k, n):
        rule = qm.make_plan(m, k, n, torch.bfloat16, H100_SMS)
        assert qm.make_plan(m, k, n, torch.bfloat16, H100_SMS, 0, 0) == rule
        assert qm.make_plan(m, k, n, torch.bfloat16, H100_SMS, None,
                            qm.TC_WAVES) == rule
        tiles = -(-m // rule["bm"]) * (n // 128)
        assert rule["bn"] == (64 if tiles < H100_SMS else 128)

    @pytest.mark.parametrize("bn", [64, 128])
    @pytest.mark.parametrize("waves", [1, 2, 4])
    @pytest.mark.parametrize("k,n", SERVE_KN)
    def test_each_override_makes_its_plan(self, k, n, bn, waves):
        p = qm.make_plan(8, k, n, torch.bfloat16, H100_SMS, bn, waves)
        tiles = n // bn
        assert p["bm"] == 16 and p["bn"] == bn
        want = min((waves * H100_SMS + tiles // 2) // tiles, k // 128)
        if want > 1:
            ks = max(-(-(-(-k // want)) // 64) * 64, 128)
            assert p["splits"] == -(-k // ks)
            assert p["workspace_bytes"] == p["splits"] * 8 * n * 4 + tiles * 4
        else:
            assert p["splits"] == 1 and p["workspace_bytes"] == 0
        assert p["blocks"] == tiles * p["splits"]

    def test_f32_takes_no_knob_and_bad_knobs_raise(self):
        rule = qm.make_plan(8, 1024, 1024, torch.float32, H100_SMS)
        assert qm.make_plan(8, 1024, 1024, torch.float32, H100_SMS, 64, 4) \
            == rule == {"bm": 16, "bn": 128, "splits": 1, "blocks": 8,
                        "workspace_bytes": 0}
        for bad in ((96, 0), (0, -1), (0, 65)):
            with pytest.raises(ValueError, match="bn"):
                qm.make_plan(8, 1024, 1024, torch.bfloat16, H100_SMS, *bad)

    def test_the_cpu_wrapper_takes_the_knobs(self):
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.standard_normal((8, 256)), dtype=torch.float32)
        w = torch.as_tensor(rng.integers(-127, 128, (256, 384)),
                            dtype=torch.int8)
        s = torch.as_tensor(rng.random(384) * 0.01, dtype=torch.float32)
        ref = qm.weight_only_matmul_plain(x, w, s, "int8", 128)
        got = qm.weight_only_matmul(x, w, s, "int8", 128, bn=64, waves=4)
        assert torch.equal(got, ref)

    def test_quantized_engine_closes_the_gemm_plans_in(self, monkeypatch):
        """An int8 engine on the GEMM route reads the cache's ``wo_gemm``
        table once and passes the knobs of each call's M class with it
        (M 3 at the prefill and 1 at each decode step are both class 16;
        a 20-token prompt is class 64, which the table lacks, so it keeps
        the rule); its tokens equal the untuned engine's, also with the
        GEMM swapped for its plain version (the card smoke's reference
        route)."""
        import paddle_tpu_torch.inference as inference
        from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                                engine_weights_from_numpy)

        def eng(tune):
            return FusedMultiTransformerEngine(
                engine_weights_from_numpy(
                    _mk_weights(5, 64, 128, 4, 2, 32, 2, 128), "cpu",
                    "float32"),
                num_heads=4, head_dim=32, max_seq_len=32, dtype="float32",
                norm_type="rmsnorm", activation="swiglu", gqa_group_size=2,
                weight_quant="int8", autotune_cache=tune, device="cpu")
        table = {f"mc16_k128_n{n}_float32": {"bn": 64, "waves": 4, "m": 8,
                                             "card": None}
                 for n in (128, 256)}
        tune = dict(_pickup_cache(), wo_gemm={"int8": table})
        tuned, base = eng(tune), eng(None)
        assert set(tuned.quant_routes.values()) == {"kernel"}
        assert tuned._wo_plans == {(16, 128, 128): (64, 4),
                                   (16, 128, 256): (64, 4)}
        assert base._wo_plans == {}
        seen = []
        real = inference.weight_only_matmul

        def spy(*a, **kw):
            seen.append((a[0].shape[0], kw.get("bn"), kw.get("waves")))
            return real(*a, **kw)
        monkeypatch.setattr(inference, "weight_only_matmul", spy)
        ids = np.array([[3, 9, 27]], np.int32)
        got = tuned.generate(ids, max_new_tokens=4)
        assert set(seen) == {(3, 64, 4), (1, 64, 4)}
        long_ids = (np.arange(20, dtype=np.int32) % 60 + 1)[None, :]
        seen.clear()
        got_long = tuned.generate(long_ids, max_new_tokens=2)
        assert set(seen) == {(20, None, None), (1, 64, 4)}

        def plain(x, w, s, quant, block_n, out_dtype, bn, waves):
            return qm.weight_only_matmul_plain(x, w, s, quant, block_n,
                                               out_dtype)
        monkeypatch.setattr(inference, "weight_only_matmul",
                            lambda x, w, s, **kw: plain(x, w, s, **kw))
        assert (tuned.generate(ids, max_new_tokens=4) == got).all()
        assert (base.generate(ids, max_new_tokens=4) == got).all()
        assert (base.generate(long_ids, max_new_tokens=2) == got_long).all()
