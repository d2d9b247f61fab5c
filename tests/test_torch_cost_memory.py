"""The PyTorch port's cost and memory observability (``observability/
costs.py``, ``observability/memory.py``, the kernels' own counts in
``ops/work.py``): the port forms of every case of tests/test_cost_memory.py
that needs no mesh, on the CPU.

* the catalog counts a program as it runs (flops of the products, bytes
  of every op, argument and output bytes), records nothing for a call
  that raises, derives MFU / roofline against the device-complete time,
  keeps its signature history, and takes the kernels' own reports;
* serving: tokens equal with the catalog on and off, no new bucket after
  warm-up, ``paged_step`` counted per signature; a disabled catalog
  records nothing; submit / retire churn with prefix caching and
  speculative decode returns the live-tensor census and the KV pool to
  baseline;
* the memory monitor: the census sees created and tagged tensors; the
  engine's ``memory_watch`` lands the gauges and fires ``hbm_pressure``
  with a dump; ``shed_on_pressure`` sheds queued work under that
  pressure; a healthy budget never fires; ``update(in_use_bytes=...)``
  reports what the JAX monitor reports, field by field;
* ``shard_skew`` on one device reads 1.0;
* the pretraining step counted once as ``pretrain_step`` and timed after;
* the kernel-work table at the smoke's shapes against the bound column
  of PERF.md section 6 (within 1%, or the column's last printed digit).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.incubate.nn import (  # noqa: E402
    ContinuousBatchingEngine, GenerationRequest)
from paddle_tpu_torch.ops import work  # noqa: E402
from tools.torch_serve_gates import tiny_engine  # noqa: E402


@pytest.fixture(autouse=True)
def _catalog_off():
    cat = obs.get_cost_catalog()
    was = cat.enabled
    yield
    cat.enabled = was


def _engine():
    return tiny_engine(np.random.default_rng(0), 64, "cpu")


_PATTERN = [7, 23, 41, 11]


def _churn(cb, tag, prompts, new_tokens=6):
    reqs = [GenerationRequest(p.copy(), new_tokens, request_id=f"{tag}{j}")
            for j, p in enumerate(prompts)]
    for r in reqs:
        cb.submit(r)
    out = cb.run()
    return [out[r.request_id] for r in reqs]


def _spec_prefix_cb(eng, **kw):
    kw.setdefault("num_blocks", 16)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("spec_k", 2)
    kw.setdefault("prefix_cache", True)
    return ContinuousBatchingEngine(eng, **kw)


class TestCostCatalog:
    def test_count_call_real_program(self):
        reg = obs.MetricsRegistry()
        cat = obs.CostCatalog(registry=reg)
        x = torch.ones((32, 32))
        out, e = cat.count_call("mm", lambda a, b: (a @ b).sum(), (x, x))
        assert float(out) == 32.0 ** 3
        assert e["flops"] == 2 * 32 ** 3
        # the matmul reads 8 KiB and writes 4; the sum reads its 4 KiB
        assert e["bytes_accessed"] >= 3 * 32 * 32 * 4 + 4
        assert e["arg_bytes"] == 2 * 32 * 32 * 4
        # on the CPU the peak is the arguments plus the storages the ops
        # held at once: the 4 KiB product while the sum makes its 4 bytes
        assert e["peak_hbm"] == e["arg_bytes"] + 32 * 32 * 4 + 4
        assert e["temp_bytes"] == 32 * 32 * 4
        snap = reg.snapshot()
        assert snap["program_flops"]["children"]["mm"]["value"] == \
            e["flops"]

    def test_raising_call_records_nothing(self):
        cat = obs.CostCatalog(registry=obs.MetricsRegistry())

        def bad():
            raise RuntimeError("boom")
        with pytest.raises(RuntimeError):
            cat.count_call("nope", bad)
        assert cat.entries() == {}

    def test_kernel_reports_reach_the_counter(self):
        cat = obs.CostCatalog(registry=obs.MetricsRegistry())

        def prog():
            work.note("k", 100, 20)
            work.note("k", 100, 20)
            return torch.zeros(2) + 1

        assert not work.counting()
        _, e = cat.count_call("p", prog)
        assert e["kernels"] == {"k": {"launches": 2, "bytes": 200,
                                      "flops": 40}}
        assert e["flops"] >= 40 and e["bytes_accessed"] >= 200
        assert not work.counting()
        work.note("k", 1, 1)                    # no counter: no effect

    def test_derive_against_device_time(self):
        reg = obs.MetricsRegistry()
        cat = obs.CostCatalog(registry=reg)
        cat.record("p", flops=1e9, bytes_accessed=1e9)
        cat.observe_seconds("p", 0.01)
        d = cat.derive(registry=reg, peak_flops_override=1e12,
                       peak_bw_override=1e12)
        assert d["p"]["device_s"] == 0.01
        assert d["p"]["mfu"] == pytest.approx(0.1)
        assert d["p"]["roofline_frac"] >= d["p"]["mfu"]
        h = reg.get("program_device_seconds")
        assert h._children[("p",)].count == 1

    def test_signature_history_accumulates(self):
        cat = obs.CostCatalog(registry=obs.MetricsRegistry())
        cat.record("p", flops=1.0, bytes_accessed=1.0, signature="a")
        cat.record("p", flops=2.0, bytes_accessed=1.0, signature="b")
        e = cat.entries()["p"]
        assert e["analyses"] == 2 and set(e["signatures"]) == {"a", "b"}
        assert e["flops"] == 2.0


class TestServingAttribution:
    def test_catalog_neutral_and_attributes_paged_step(self):
        eng, _ = _engine()
        prompts = [np.asarray(_PATTERN * 4, np.int32),
                   np.asarray(_PATTERN * 2, np.int32)]
        cat = obs.get_cost_catalog()
        cat.reset()
        cat.enabled = True
        cb = _spec_prefix_cb(eng)
        try:
            out_warm = _churn(cb, "ca", prompts)
            _churn(cb, "cb", prompts)
            cb.declare_warm()
            warm = set(cb._seen_buckets)
            out_on = _churn(cb, "cc", prompts)
        finally:
            cat.enabled = False
        assert len(set(cb._seen_buckets) - warm) == 0
        out_off = _churn(_spec_prefix_cb(eng), "cd", prompts)
        assert out_on == out_off == out_warm
        e = cat.entries()["paged_step"]
        assert e["flops"] > 0 and e["bytes_accessed"] > 0
        assert len(e["signatures"]) >= 2
        rows = {r["program"]: r for r in cat.table()}
        assert rows["paged_step"]["mfu"] is not None \
            and rows["paged_step"]["mfu"] > 0

    def test_disabled_catalog_records_nothing(self):
        eng, _ = _engine()
        cat = obs.get_cost_catalog()
        cat.reset()
        assert not cat.enabled

        def timed():
            h = obs.get_registry().get("program_device_seconds")
            child = None if h is None else h._children.get(("paged_step",))
            return 0 if child is None else child.count
        before = timed()
        _churn(_spec_prefix_cb(eng), "cz",
               [np.asarray(_PATTERN * 2, np.int32)])
        assert cat.entries() == {}
        assert timed() == before


class TestServingLeakCheck:
    def test_churn_returns_census_and_pool_to_baseline(self):
        eng, V = _engine()
        rng = np.random.default_rng(3)
        prompts = [np.asarray(_PATTERN * 4, np.int32),
                   rng.integers(1, V, 13).astype(np.int32)]
        cb = _spec_prefix_cb(eng)
        _churn(cb, "la", prompts)
        baseline = obs.live_array_census()
        base_free = cb.allocator.num_free
        base_pooled = cb.allocator.num_pooled
        assert cb.allocator.num_used == 0
        _churn(cb, "lb", prompts)
        diff = obs.census_diff(baseline, obs.live_array_census())
        assert diff == {}, f"live-tensor census leaked: {diff}"
        assert cb.allocator.num_used == 0
        assert cb.allocator.num_free == base_free
        assert cb.allocator.num_pooled == base_pooled
        reg = obs.get_registry()
        assert reg.get("kv_blocks_used").value == 0
        assert reg.get("kv_blocks_free").value == base_free

    def test_rewind_churn_still_leak_free(self):
        eng, _ = _engine()
        prompts = [np.asarray(_PATTERN * 4, np.int32),
                   np.asarray(_PATTERN * 2, np.int32)]
        cb = _spec_prefix_cb(eng, spec_k=4)
        out1 = _churn(cb, "ra", prompts, new_tokens=8)
        base_free = cb.allocator.num_free
        base_pooled = cb.allocator.num_pooled
        out2 = _churn(cb, "rb", prompts, new_tokens=8)
        assert out2 == out1
        assert cb.allocator.num_used == 0
        assert cb.allocator.num_free == base_free
        assert cb.allocator.num_pooled == base_pooled


class TestMemoryMonitor:
    def test_census_sees_created_tensors(self):
        before = obs.live_array_census()
        keep = torch.ones((17, 13))
        diff = obs.census_diff(before, obs.live_array_census())
        assert diff.get("float32[17, 13]", {}).get("count") == 1
        assert diff["float32[17, 13]"]["bytes"] == 17 * 13 * 4
        del keep

    def test_tagged_tensors_group_by_owner(self):
        a = torch.ones((5, 5))
        obs.tag_arrays("my_cache", [a])
        assert obs.live_array_census().get("my_cache", {}).get(
            "count") == 1
        del a

    def test_engine_memory_watch_gauges_and_pressure(self, tmp_path):
        eng, _ = _engine()
        ring = obs.SpanRecorder()
        fr = obs.FlightRecorder(recorder=ring, min_interval_s=0.0)
        fr.arm(str(tmp_path))
        watch = obs.MemoryMonitor(budget_bytes=1.0, min_headroom_frac=0.5,
                                  interval_s=0.0, flight_recorder=fr)
        cb = _spec_prefix_cb(eng, memory_watch=watch)
        _churn(cb, "ma", [np.asarray(_PATTERN * 2, np.int32)])
        assert watch.pressure_events >= 1
        reg = obs.get_registry()
        assert reg.get("hbm_bytes_in_use").value > 0
        assert reg.get("hbm_headroom_frac").value == 0.0
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flightrec_hbm_pressure")]
        assert dumps
        dump = obs.load_dump(str(tmp_path / dumps[0]))
        assert dump["reason"] == "hbm_pressure"
        assert dump["context"]["budget_bytes"] == 1

    def test_pressure_sheds_queued_work(self):
        eng, _ = _engine()
        watch = obs.MemoryMonitor(budget_bytes=1.0, min_headroom_frac=0.5,
                                  interval_s=0.0,
                                  flight_recorder=obs.FlightRecorder())
        cb = _spec_prefix_cb(eng, memory_watch=watch, shed_on_pressure=True,
                             max_batch=1)
        keep = GenerationRequest(np.asarray(_PATTERN * 2, np.int32), 4,
                                 request_id="keep", priority=0)
        low = GenerationRequest(np.asarray(_PATTERN, np.int32), 4,
                                request_id="low", priority=2)
        cb.submit(keep)
        cb.step()                       # admits `keep`, the watch ticks
        cb.submit(low)
        out = cb.run()
        assert cb.finished["low"].status == "shed"
        assert cb.finished["keep"].status == "finished"
        ref = _churn(_spec_prefix_cb(eng), "r",
                     [np.asarray(_PATTERN * 2, np.int32)], new_tokens=4)
        assert out["keep"] == ref[0]
        snap = obs.get_registry().snapshot()
        shed = snap["serve_requests_shed_total"]["children"]
        assert shed.get("hbm_pressure", {}).get("value", 0) >= 1

    def test_healthy_budget_never_triggers(self):
        eng, _ = _engine()
        watch = obs.MemoryMonitor(budget_bytes=1e15, min_headroom_frac=0.1,
                                  flight_recorder=obs.FlightRecorder(
                                      min_interval_s=0.0))
        _churn(_spec_prefix_cb(eng, memory_watch=watch), "mh",
               [np.asarray(_PATTERN * 2, np.int32)])
        assert watch.pressure_events == 0
        assert watch.last_report["pressure"] is False

    @pytest.mark.parametrize("in_use", [100.0, 850.0, 1200.0])
    def test_update_report_equals_jax(self, in_use):
        reports = []
        for o in (jobs, obs):
            mon = o.MemoryMonitor(budget_bytes=1000.0, min_headroom_frac=0.2,
                                  registry=o.MetricsRegistry(),
                                  flight_recorder=o.FlightRecorder())
            reports.append((mon.update(in_use_bytes=in_use),
                            mon.pressure_events))
        assert reports[1] == reports[0]

    def test_shard_skew_one_device(self):
        out = obs.shard_skew({"w": torch.ones((64, 16)),
                              "b": [torch.ones(3)]})
        assert out["devices"] == {"cpu": 64 * 16 * 4 + 12}
        assert out["skew"] == pytest.approx(1.0)
        assert obs.get_registry().get("shard_skew").value == \
            pytest.approx(1.0)
        assert obs.device_memory() == {}


class TestPretrainAttribution:
    def test_train_step_counted_once_and_timed(self):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.models import pretrain
        cfg = LlamaConfig.tiny(dtype="float32")
        model = LlamaForCausalLM(cfg, device="cpu", seed=0)
        params, opt_state, meta = pretrain.make_train_state(model, None)
        step = pretrain.make_train_step(model, None, meta)
        cat = obs.get_cost_catalog()
        cat.reset()
        cat.enabled = True
        rng = np.random.default_rng(0)
        try:
            for _ in range(2):
                batch = pretrain.batch_to_device(
                    {"input_ids": rng.integers(0, cfg.vocab_size, (2, 16)),
                     "labels": rng.integers(0, cfg.vocab_size, (2, 16))},
                    "cpu")
                params, opt_state, loss, _ = step(params, opt_state, batch)
                float(loss)
        finally:
            cat.enabled = False
        e = cat.entries()["pretrain_step"]
        assert e["analyses"] == 1
        assert e["flops"] > 0 and e["bytes_accessed"] > 0
        n = sum(p.numel() for p in params.values())
        # forward, backward and the update: at least 6 N flops a token
        # less the embedding's gather
        emb = cfg.vocab_size * cfg.hidden_size
        assert e["flops"] >= 6 * (n - emb) * 2 * 16 * 0.9
        rows = {r["program"]: r for r in cat.table()}
        assert rows["pretrain_step"]["mfu"] > 0
        h = obs.get_registry().get("program_device_seconds")
        assert h._children[("pretrain_step",)].count >= 1


# -- the kernel-work table against PERF.md section 6's bound column ---------

def _smoke():
    import chip_smoke
    return chip_smoke


def _k3_decode():
    lens = np.array([1, 512, 17, 100, 256, 333, 64, 480], np.int64)
    return work.ragged_attention(lens, None, 1, 32, 16, 16, 8, 64, 2,
                                 8 * 32 * 4)


def _k8a(part):
    cs = _smoke()
    name, b, s, h, _, mh, causal, build = cs.flashmask_specs()[0]
    rng = np.random.default_rng(51)
    sr, er = (np.minimum(x, 2 ** 31 - 1).astype(np.int32)
              for x in build(rng, b, mh, s))
    pairs = work.flashmask_pairs(sr, er, h, s, causal)
    return work.flashmask(b, h, s, 64, pairs, sr.size)[part]


_FLAGSHIP_PARAMS = 32000 * 1024 * 2 + 24 * (4 * 1024 * 1024
                                            + 3 * 1024 * 2816 + 2 * 1024) \
    + 1024
BOUNDS = {                      # PERF.md section 6, "Bound ms"
    "K1_flash_fwd": (lambda: work.flash_fwd(128, 2048, 2048, 64, True),
                     0.0695),
    "K2_flash_bwd": (lambda: work.flash_bwd(128, 2048, 2048, 64, True),
                     0.1738),
    "K3_decode": (_k3_decode, 0.0011),
    "K5_ce_fwd": (lambda: work.blockwise_ce(16384, 16384, 1024,
                                            32000)["fwd"], 1.0857),
    "K6_ce_dh": (lambda: work.blockwise_ce(16384, 16384, 1024,
                                           32000)["dh"], 2.1714),
    "K6_ce_dw": (lambda: work.blockwise_ce(16384, 16384, 1024,
                                           32000)["dw"], 2.1714),
    "K8a_fwd": (lambda: _k8a("fwd"), 0.0404),
    "K8a_dq": (lambda: _k8a("dq"), 0.0604),
    "K8a_dkv": (lambda: _k8a("dkv"), 0.0705),
    "A_fwd": (lambda: work.rms_norm_fwd(16384, 1024, 2, 2, True), 0.0401),
    "A_bwd": (lambda: work.rms_norm_bwd(16384, 1024, 2, 2, True), 0.0401),
    "B_fwd": (lambda: work.swiglu_fwd(16384, 2816), 0.0826),
    "B_bwd": (lambda: work.swiglu_bwd(16384, 2816), 0.1377),
    "C_fwd": (lambda: work.token_ce_fwd(16384, 32000, 2), 0.3131),
    "C_bwd": (lambda: work.token_ce_bwd(16384, 32000, 2), 0.6261),
    "D_adamw": (lambda: work.adamw(_FLAGSHIP_PARAMS), 3.1249),
}


@pytest.mark.parametrize("kernel", sorted(BOUNDS))
def test_kernel_work_gives_perf_bound(kernel):
    fn, want = BOUNDS[kernel]
    ms, _ = work.bound_ms(*fn())
    assert abs(ms - want) <= max(0.01 * want, 5e-5), (kernel, ms, want)
