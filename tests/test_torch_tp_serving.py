"""Tensor-parallel serving of the PyTorch port on the CPU, held against
the JAX package: ``FusedMultiTransformerEngine(..., tp=2, group=...)``
with rank 0 driving ``ContinuousBatchingEngine`` and rank 1 replaying its
programs (``serve_follower``) must give the JAX package's tp=1 tokens in
every serving mode, with per-rank KV bytes 1/tp, the analytic collective
payload and the mesh-aware health block.

Ranks are threads of this process over ``dist.HashStore()`` and gloo
(each rank builds ``distributed.collective.new_group(rank, tp, store,
timeout=60)``); one test spawns a real follower process over a
``FileStore``. Every group has a 60 s timeout and every join a timeout,
so no test can hang. The JAX engine runs its ragged Pallas kernel in
interpret mode, as the JAX package's own serving tests do; the port runs
the plain PyTorch versions of its kernels (CPU tensors). The shape is
the JAX package's tensor-parallel test shape (tests/test_serve_tp.py):
8 q heads / 8 kv heads, so the kv-head axis splits at tp = 2, 4, 8.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402
from tools.torch_serve_gates import ThreadRanks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, E, H, G, D, L, F = 128, 64, 8, 8, 8, 2, 96
# a shape whose projections fit the weight-only GEMM's blocks at tp=1
# and tp=2 (qkv 256 -> 128 columns, ffn1 512 -> 256), so the quantized
# legs take the kernel route (its plain version here) as well as the
# dequant route of the shape above
QV, QE, QH, QG, QD, QL, QF = 128, 128, 4, 2, 32, 2, 256
KW = dict(num_heads=H, head_dim=D, max_seq_len=64, dtype="float32",
          norm_type="rmsnorm", activation="swiglu", gqa_group_size=G)
QKW = dict(num_heads=QH, head_dim=QD, max_seq_len=64, dtype="float32",
           norm_type="rmsnorm", activation="swiglu", gqa_group_size=QG)
TIMEOUT_S = 60.0
WORKLOAD = [(5, 4), (11, 3), (3, 6), (8, 2)]


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    yield
    fa._INTERPRET = old


def _weights(dims=(V, E, H, G, D, L, F), seed=0):
    v, e, h, g, d, n, f = dims
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        ln_scales=[np.ones(e, np.float32) for _ in range(n)],
        qkv_weights=[mk(h + 2 * g, d, e) for _ in range(n)],
        linear_weights=[mk(h * d, e) for _ in range(n)],
        ffn_ln_scales=[np.ones(e, np.float32) for _ in range(n)],
        ffn1_weights=[mk(e, 2 * f) for _ in range(n)],
        ffn2_weights=[mk(f, e) for _ in range(n)],
        embedding=mk(v, e), lm_head=mk(e, v))


def _quant_case(quant):
    """(weights, engine kwargs) of a (quant, shape) case; None: float."""
    if quant is None or quant[1] == "tiny":
        return _weights(), KW
    return _weights((QV, QE, QH, QG, QD, QL, QF)), QKW


_RANKS = {}


def _engine(tp, quant=None):
    """The port's engine at `tp` (rank 0 of thread ranks when tp > 1),
    cached per (tp, quant): every test reuses the same followers."""
    key = (tp, quant)
    if key not in _RANKS:
        from paddle_tpu_torch.inference import FusedMultiTransformerEngine
        w, kw = _quant_case(quant)
        wq = None if quant is None else quant[0]
        if tp == 1:
            _RANKS[key] = FusedMultiTransformerEngine(
                w, weight_quant=wq, device="cpu", **kw)
        else:
            _RANKS[key] = ThreadRanks(
                tp, lambda rank, g: FusedMultiTransformerEngine(
                    w, tp=tp, group=g, weight_quant=wq, device="cpu", **kw),
                timeout=TIMEOUT_S)
    r = _RANKS[key]
    return r if tp == 1 else r.engine


@pytest.fixture(scope="module", autouse=True)
def _stop_followers():
    yield
    for key, r in list(_RANKS.items()):
        if key[0] > 1:
            r.close()
    _RANKS.clear()


_JAX = {}


def _jax_engine(quant=None):
    """The JAX package's tp=1 engine, cached per (quant, shape)."""
    if quant not in _JAX:
        from paddle_tpu.inference import FusedMultiTransformerEngine as JE
        w, kw = _quant_case(quant)
        _JAX[quant] = JE(w, weight_quant=None if quant is None else quant[0],
                         **kw)
    return _JAX[quant]


# -- the serving matrix (the same scripts drive either package) -------------

def _pkg(pkg):
    if pkg == "jax":
        from paddle_tpu.incubate.nn import (ContinuousBatchingEngine,
                                            GenerationRequest)
    else:
        from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                                  GenerationRequest)
    return ContinuousBatchingEngine, GenerationRequest


def _cb(pkg, eng, **kw):
    CB, _ = _pkg(pkg)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    return CB(eng, **kw)


def _reqs(pkg, tag, workload, seed=7, **req_kw):
    _, Req = _pkg(pkg)
    rng = np.random.default_rng(seed)
    return [Req(rng.integers(1, V, p).astype(np.int32), n,
                request_id=f"{tag}r{j}", **req_kw)
            for j, (p, n) in enumerate(workload)]


def _run(cb, reqs):
    for r in reqs:
        cb.submit(r)
    out = cb.run()
    return [list(out[r.request_id]) for r in reqs]


def _plain(pkg, eng):
    cb = _cb(pkg, eng)
    return _run(cb, _reqs(pkg, "pl", WORKLOAD)) + [[cb._step_count]]


def _chunked(pkg, eng):
    cb = _cb(pkg, eng, prefill_chunk=4)
    return _run(cb, _reqs(pkg, "ch", WORKLOAD)) + [[cb._step_count]]


def _budgeted(pkg, eng):
    cb = _cb(pkg, eng, prefill_chunk=4, token_budget=6)
    return _run(cb, _reqs(pkg, "bu", WORKLOAD)) + [[cb._step_count]]


def _spec(pkg, eng):
    _, Req = _pkg(pkg)
    pattern = [7, 23, 41, 11]
    cb = _cb(pkg, eng, max_batch=2, prefill_chunk=8, spec_k=4)
    reqs = [Req(np.asarray(pattern * 6, np.int32), 10, request_id="sp0"),
            Req(np.asarray(pattern * 3, np.int32), 10, request_id="sp1")]
    toks = _run(cb, reqs)
    return toks + [[cb._step_count, sum(r.spec_drafted for r in reqs),
                    sum(r.spec_accepted for r in reqs)]]


def _prefix(pkg, eng):
    _, Req = _pkg(pkg)
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, V, 24).astype(np.int32)
    cb = _cb(pkg, eng, prefill_chunk=8, prefix_cache=True)
    reqs = [Req(np.concatenate([prefix,
                                rng.integers(1, V, 3).astype(np.int32)]),
                4, request_id=f"pf{j}") for j in range(4)]
    toks = _run(cb, reqs)
    return toks + [[cb.cache_stats["hit_blocks"],
                    cb.cache_stats["cow_copies"], cb.allocator.high_water]]


def _cancel(pkg, eng):
    # step twice, cancel the longest request mid-decode, drain
    cb = _cb(pkg, eng)
    reqs = _reqs(pkg, "cx", [(5, 6), (9, 6)])
    for r in reqs:
        cb.submit(r)
    for _ in range(4):
        cb.step()
    assert cb.cancel(reqs[1].request_id)
    cb.run()
    return ([list(cb.finished[r.request_id]) for r in reqs],
            cb.finished[reqs[1].request_id].status)


def _preempt(pkg, eng):
    # a tight pool and a priority-0 arrival preempt the newest
    # low-priority request TO BLOCKS; the resume must be token-exact
    cb = _cb(pkg, eng, num_blocks=7, max_batch=2)
    low = _reqs(pkg, "pel", [(9, 6), (9, 6)], seed=11, priority=2)
    for r in low:
        cb.submit(r)
    cb.step()
    cb.step()
    hi = _reqs(pkg, "peh", [(8, 4)], seed=12, priority=0)[0]
    cb.submit(hi)
    cb.run()
    return ([list(cb.finished[r.request_id]) for r in low + [hi]],
            [cb.finished[r.request_id].preemptions for r in low])


MODES = {"plain": _plain, "chunked": _chunked, "budgeted": _budgeted,
         "spec": _spec, "prefix": _prefix, "cancel": _cancel,
         "preempt": _preempt}
_REFS = {}


def _jax_ref(mode):
    if mode not in _REFS:
        _REFS[mode] = MODES[mode]("jax", _jax_engine())
    return _REFS[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_tokens_equal_jax_tp1(mode):
    ref = _jax_ref(mode)
    if mode == "cancel":
        assert ref[1] == "cancelled"
    if mode == "preempt":
        assert sum(ref[1]) >= 1, "workload failed to force a preemption"
    assert MODES[mode]("port", _engine(2)) == ref


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_repack_round_trips_bit_equal_jax(tp):
    from paddle_tpu.inference import tp_layout as J
    from paddle_tpu_torch.inference import tp_layout as T
    rng = np.random.default_rng(tp)
    w = rng.standard_normal((H + 2 * G, D, E)).astype(np.float32)
    bias = rng.standard_normal((H + 2 * G, D)).astype(np.float32)
    f1 = rng.standard_normal((E, 2 * F)).astype(np.float32)
    for a in (w, bias):
        rp = T.repack_gqa_qkv(a, H, G, tp)
        np.testing.assert_array_equal(rp, J.repack_gqa_qkv(a, H, G, tp))
        np.testing.assert_array_equal(T.unpack_gqa_qkv(rp, H, G, tp), a)
    np.testing.assert_array_equal(T._gqa_row_order(H, G, tp),
                                  J._gqa_row_order(H, G, tp))
    np.testing.assert_array_equal(T.repack_glu_ffn1(f1, tp),
                                  J.repack_glu_ffn1(f1, tp))
    np.testing.assert_array_equal(T._glu_col_order(2 * F, tp),
                                  J._glu_col_order(2 * F, tp))
    for args in ((H, G, F, tp), (H, G, F, 3), (H, 6, F, 4)):
        try:
            J.validate_tp(*args)
        except ValueError as e:
            with pytest.raises(ValueError) as te:
                T.validate_tp(*args)
            assert str(te.value) == str(e)
        else:
            assert T.validate_tp(*args) == args[-1]


def test_local_blocks_are_the_ranks_heads_and_glu_pairs():
    """Each rank's shard of seeded asymmetric weights holds its own q / k
    / v heads and its own (activation, gate) columns, biases and
    weight-only scales split alike, out-projection / ffn2 rows split in
    order and everything else replicated."""
    from paddle_tpu_torch.inference.tp_layout import (serving_weight_specs,
                                                      shard_serving_weights)
    tp = 4
    w = _weights()
    w["qkv_biases"] = [np.arange((H + 2 * G) * D, dtype=np.float32)
                       .reshape(H + 2 * G, D)]
    w["ffn1_biases"] = [np.arange(2 * F, dtype=np.float32)]
    w["ffn1_wscales"] = [np.arange(2 * F, dtype=np.float32)[None]]
    w["linear_wscales"] = [np.arange(E, dtype=np.float32)[None]]
    specs = serving_weight_specs(w)
    assert specs["qkv_weights"] == [0] * L and specs["ffn1_weights"] == \
        [-1] * L and specs["linear_wscales"] == [None]
    assert specs["embedding"] is None
    hq, hk, fl = H // tp, G // tp, F // tp
    qkv, f1 = w["qkv_weights"][0], w["ffn1_weights"][0]
    for d in range(tp):
        s, _ = shard_serving_weights(w, d, H, G, True, tp)
        blk = s["qkv_weights"][0].numpy()
        np.testing.assert_array_equal(blk[:hq], qkv[d * hq:(d + 1) * hq])
        np.testing.assert_array_equal(blk[hq:hq + hk],
                                      qkv[H + d * hk:H + (d + 1) * hk])
        np.testing.assert_array_equal(
            blk[hq + hk:], qkv[H + G + d * hk:H + G + (d + 1) * hk])
        a, g = np.split(s["ffn1_weights"][0].numpy(), 2, axis=-1)
        np.testing.assert_array_equal(a, f1[:, d * fl:(d + 1) * fl])
        np.testing.assert_array_equal(g, f1[:, F + d * fl:F + (d + 1) * fl])
        b = s["ffn1_biases"][0].numpy()
        assert b.tolist() == list(range(d * fl, (d + 1) * fl)) + \
            list(range(F + d * fl, F + (d + 1) * fl))
        np.testing.assert_array_equal(s["ffn1_wscales"][0].numpy()[0], b)
        np.testing.assert_array_equal(
            s["qkv_biases"][0].numpy()[:hq],
            w["qkv_biases"][0][d * hq:(d + 1) * hq])
        step = H * D // tp
        np.testing.assert_array_equal(
            s["linear_weights"][0].numpy(),
            w["linear_weights"][0][d * step:(d + 1) * step])
        np.testing.assert_array_equal(
            s["ffn2_weights"][0].numpy(),
            w["ffn2_weights"][0][d * fl:(d + 1) * fl])
        for k in ("embedding", "lm_head"):
            np.testing.assert_array_equal(s[k].numpy(), w[k])
        np.testing.assert_array_equal(s["linear_wscales"][0].numpy(),
                                      w["linear_wscales"][0])


def test_kv_head_shard_contract_equals_jax():
    from paddle_tpu.ops.pallas import paged_attention as jpa
    from paddle_tpu_torch.ops import paged_attention as tpa
    assert tpa.kv_head_shard(8, 4) == jpa.kv_head_shard(8, 4) == 2
    assert tpa.kv_head_shard(8, 4, rank=3) == (6, 2)
    for args, kw in (((6, 4), {}), ((8, 4), {"rank": 4}),
                     ((8, -1), {}), ((8, 0), {})):
        with pytest.raises(ValueError) as je:
            jpa.kv_head_shard(*args, **kw)
        with pytest.raises(ValueError) as te:
            tpa.kv_head_shard(*args, **kw)
        assert str(te.value) == str(je.value)


def _refusal(jax_kw, port_kw=None, weights=None, dims=None):
    """(JAX message, port message) of the same refused construction."""
    from paddle_tpu.inference import FusedMultiTransformerEngine as JE
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    w = weights or _weights()
    kw = dict(KW, **(dims or {}))
    with pytest.raises(ValueError) as je:
        JE(dict(w), **kw, **jax_kw)
    with pytest.raises(ValueError) as te:
        FusedMultiTransformerEngine(dict(w), device="cpu", **kw,
                                    **dict(jax_kw, **(port_kw or {})))
    return str(je.value), str(te.value)


@pytest.mark.parametrize("case", ["indivisible", "negative", "int4_odd"])
def test_refusals_carry_the_jax_messages(case):
    if case == "indivisible":
        j, t = _refusal(dict(tp=3))
        assert "divisible" in t
    elif case == "negative":
        j, t = _refusal(dict(tp=-2))
        assert "tp must be >= 1" in t
    else:
        # H*D / tp odd: 2 heads of 3 dims over tp=2 (all divisible)
        dims = dict(num_heads=2, head_dim=3, gqa_group_size=2)
        w = _weights((V, 8, 2, 2, 3, 1, 4))
        j, t = _refusal(dict(tp=2, weight_quant="int4"), weights=w,
                        dims=dims)
        assert "even" in t
    assert t == j


def test_tp_needs_a_group_and_generate_refuses_tp():
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    with pytest.raises(ValueError, match="needs group="):
        FusedMultiTransformerEngine(_weights(), tp=2, device="cpu", **KW)
    eng = _engine(2)
    with pytest.raises(NotImplementedError, match="tp=1") as te:
        eng.generate(np.ones((1, 4), np.int32), max_new_tokens=2)
    assert "ContinuousBatchingEngine's paged path" in str(te.value)


# -- accounting ---------------------------------------------------------------

def test_kv_device_bytes_are_one_over_tp():
    bs = 8
    single = _engine(1).kv_device_block_bytes(bs)
    assert single == L * 2 * G * bs * D * 4
    assert _engine(2).kv_device_block_bytes(bs) * 2 == single
    caches = _engine(2).new_paged_caches(24, bs)
    full = _engine(1).new_paged_caches(24, bs)
    nbytes = [sum(c.numel() * c.element_size() for c in cs)
              for cs in (caches, full)]
    assert nbytes[0] * 2 == nbytes[1] == 24 * single
    assert caches[0].shape == (2, G // 2, 24, bs, D)


def test_step_comm_bytes_equal_the_jax_formula():
    assert _engine(2).tp_step_comm_bytes(4, 8) == 2 * L * 4 * 8 * E * 4
    assert _engine(1).tp_step_comm_bytes(4, 8) == 0


def test_collective_telemetry_lands():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import collective
    reg = obs.get_registry()

    def total():
        fam = reg.get("collective_bytes_total")
        return sum(c.value for c in fam._children.values()) \
            if fam is not None else 0.0

    before = total()
    calls0 = collective.all_reduce.calls
    obs.get_tracer().clear()
    eng = _engine(2)
    cb = _cb("port", eng)
    reqs = _reqs("port", "ct", [(5, 3)])
    _run(cb, reqs)
    # one collective task per dispatched step, each carrying the analytic
    # payload: 2 all_reduces a layer over the step's [B, C, E] slab
    steps = [s for s in obs.get_tracer().spans()
             if s["name"] == "serve_step"]
    colls = [s for s in obs.get_tracer().spans()
             if s["name"] == "collective"]
    assert len(colls) == len(steps) == cb._step_count > 0
    for st, co in zip(steps, colls):
        assert co["args"]["op"] == "all_reduce"
        assert co["args"]["axis"] == "tp"
        assert co["args"]["nbytes"] == eng.tp_step_comm_bytes(
            cb.max_batch, st["args"]["chunk"])
    expected = sum(co["args"]["nbytes"] for co in colls)
    assert total() - before == expected > 0
    # both ranks reduced twice a layer a step
    assert collective.all_reduce.calls - calls0 == 2 * 2 * L * cb._step_count
    ex = cb.explain(reqs[0].request_id)
    assert ex["tp"] == 2 and ex["comm_s"] > 0
    assert cb._comm_seconds == {}
    assert cb.finished[reqs[0].request_id].comm_s == ex["comm_s"]


def test_gauges_and_buckets_after_churn():
    from paddle_tpu_torch import observability as obs
    cb = _cb("port", _engine(2), prefill_chunk=4, token_budget=6,
             spec_k=2, prefix_cache=True)
    _run(cb, _reqs("port", "chn", WORKLOAD))
    cb.declare_warm()
    warm = set(cb._seen_buckets)
    _run(cb, _reqs("port", "chw", WORKLOAD, seed=5))
    assert set(cb._seen_buckets) == warm
    assert cb.allocator.num_used == 0 and cb.allocator._ref == {}
    snap = obs.get_registry().snapshot()
    used = snap["kv_device_bytes_used"]["children"]
    assert {k: v["value"] for k, v in used.items()} == {"0": 0.0, "1": 0.0}
    hw = snap["kv_device_bytes_high_water"]["children"]
    assert hw["0"]["value"] == \
        cb.allocator.high_water * cb._kv_dev_block_bytes
    assert snap["serve_tp_degree"]["children"][""]["value"] == 2.0 or \
        snap["serve_tp_degree"]["value"] == 2.0


def test_healthz_mesh_block_through_the_gateway():
    """The port's gateway in front of rank 0 of a tp=2 engine: /healthz
    carries the mesh block (two device rows at half the tp=1 bytes), and
    both packages' validators take it; one device row fails them."""
    import http.client

    from paddle_tpu import serving as jax_serving
    from paddle_tpu_torch import serving
    from tools.torch_serve_gates import GatewayThread
    cb = _cb("port", _engine(2))
    stepper = serving.EngineStepper(cb).start()
    gw = serving.ServingGateway(stepper)
    th = GatewayThread(gw).start()
    try:
        def get(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=60)
            conn.request(method, path, body=body and json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, data

        prompt = [int(t) for t in np.arange(1, 8)]
        code, body = get("POST", "/v1/generate", {
            "prompt": prompt, "max_new_tokens": 3, "stream": False})
        assert code == 200
        jref = _jax_engine().generate(np.asarray([prompt], np.int32), 3)
        assert json.loads(body)["tokens"] == jref[0].tolist()
        code, body = get("GET", "/healthz")
        payload = json.loads(body)
        assert code == 200
        serving.validate_healthz(payload)
        jax_serving.validate_healthz(payload)
        rows = payload["mesh"]["devices"]
        assert payload["mesh"]["tp"] == 2 and len(rows) == 2
        single = _engine(1).kv_device_block_bytes(cb.block_size)
        assert rows[0]["kv_bytes_high_water"] * 2 == \
            cb.allocator.high_water * single > 0
        payload["mesh"]["devices"] = rows[:1]
        for validate in (serving.validate_healthz,
                         jax_serving.validate_healthz):
            with pytest.raises(ValueError, match="exactly tp"):
                validate(payload)
        code, body = get("GET", "/metrics")
        text = body.decode()
        assert 'collective_bytes_total{axis="tp",op="all_reduce"}' in text \
            or 'collective_bytes_total{op="all_reduce",axis="tp"}' in text
        assert 'kv_device_bytes_high_water{device="1"}' in text
    finally:
        th.close()
        stepper.stop()


# -- weight-only quantization -------------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("shape", ["tiny", "gemm"])
def test_quantized_tp2_tokens_equal_tp1(quant, shape):
    """Quantized once on the full weight, then split: rank shards of the
    tp=1 engine's values and scales give its tokens, on the dequant route
    (the tiny widths) and the weight-only GEMM's (its plain version on the
    CPU). The tokens are the port's tp=1 engine's and the JAX package's
    tp=1 quantized engine's, which serves every case through its dequant
    route."""
    e1, e2 = _engine(1, (quant, shape)), _engine(2, (quant, shape))
    route = {"tiny": "dequant", "gemm": "kernel"}[shape]
    assert set(e1.quant_routes.values()) == {route}
    assert set(e2.quant_routes.values()) == {route}
    if shape != "tiny":
        # row-parallel scales replicate: rank 0's are tp=1's
        for kind in ("lin", "f2"):
            np.testing.assert_array_equal(
                e2._kw["_mm"].scales[kind][0].numpy(),
                e1._kw["_mm"].scales[kind][0].numpy())
        # column-parallel scales split with their columns
        assert e2._kw["_mm"].scales["f1"][0].shape[0] * 2 == \
            e1._kw["_mm"].scales["f1"][0].shape[0]
    je = _jax_engine((quant, shape))
    for mode in ("plain", "spec"):
        ref = MODES[mode]("jax", je)
        assert MODES[mode]("port", e1) == ref
        assert MODES[mode]("port", e2) == ref


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_a_quantized_shard_that_fits_no_block_is_refused(quant):
    """Full widths that take the weight-only GEMM make the tp=1 engine
    quantize for it; a tp=2 rank whose qkv shard (384 // 2 = 192 columns)
    fits no 128-multiple block cannot take the GEMM, so the engine refuses
    at construction, before any group is asked for."""
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    w = _weights((128, 128, 4, 4, 32, 2, 256))
    kw = dict(QKW, gqa_group_size=4)
    assert set(FusedMultiTransformerEngine(
        w, weight_quant=quant, device="cpu", **kw).quant_routes.values()) \
        == {"kernel"}
    with pytest.raises(ValueError, match=r"qkv shard's width 192 "
                       r"\(384//2\) fits no block"):
        FusedMultiTransformerEngine(w, tp=2, weight_quant=quant,
                                    device="cpu", **kw)


# -- collectives --------------------------------------------------------------

def test_collectives_on_an_explicit_group():
    """all_reduce (f32 / bf16 / f16), broadcast and barrier over two
    thread ranks; no group, no collective."""
    from paddle_tpu_torch.distributed import collective as C
    store = dist.HashStore()
    got = {}

    def rank(r):
        g = C.new_group(r, 2, store, timeout=TIMEOUT_S)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            t = torch.full((3,), r + 1.5, dtype=dt)
            got[(r, dt)] = C.all_reduce(t, group=g).tolist()
        h = torch.arange(4) * 7 if r == 0 else torch.zeros(4,
                                                           dtype=torch.long)
        got[(r, "b")] = C.broadcast(h, 0, group=g).tolist()
        C.barrier(g)

    t = threading.Thread(target=rank, args=(1,), daemon=True)
    t.start()
    rank(0)
    t.join(TIMEOUT_S)
    assert not t.is_alive()
    for r in (0, 1):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert got[(r, dt)] == [4.0] * 3
        assert got[(r, "b")] == [0, 7, 14, 21]
    with pytest.raises(ValueError, match="explicit group"):
        C.all_reduce(torch.ones(1))


# -- failures -----------------------------------------------------------------

def test_a_hung_follower_makes_rank_0_raise():
    """A follower that never serves leaves rank 0's first op waiting on
    it: the group's timeout ends the wait with an error, and the broken
    engine refuses every later program."""
    from paddle_tpu_torch.distributed.collective import new_group
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    store = dist.HashStore()
    release = threading.Event()
    held = {}

    def idle():
        held["g"] = new_group(1, 2, store, timeout=3)
        held["e"] = FusedMultiTransformerEngine(
            _weights(), tp=2, group=held["g"], device="cpu", **KW)
        release.wait(TIMEOUT_S)

    t = threading.Thread(target=idle, daemon=True)
    t.start()
    g = new_group(0, 2, store, timeout=3)
    eng = FusedMultiTransformerEngine(_weights(), tp=2, group=g,
                                      device="cpu", **KW)
    with pytest.raises(RuntimeError):
        # the caches' op already waits on the follower
        _cb("port", eng)
    with pytest.raises(RuntimeError, match="failed earlier"):
        eng.new_paged_caches(4, 8)
    release.set()
    t.join(TIMEOUT_S)
    assert not t.is_alive()


_FOLLOWER = r"""
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.collective import new_group
from paddle_tpu_torch.inference import FusedMultiTransformerEngine
w = dict(np.load({weights!r}))
lists = {{k: [w.pop(f"{{k}}.{{i}}") for i in range({layers})]
         for k in ("ln_scales", "qkv_weights", "linear_weights",
                   "ffn_ln_scales", "ffn1_weights", "ffn2_weights")}}
g = new_group(1, 2, {store!r}, timeout={timeout})
eng = FusedMultiTransformerEngine(dict(w, **lists), tp=2, group=g,
                                  device="cpu", **{kw!r})
print(json.dumps(eng.serve_follower(idle_timeout={timeout})), flush=True)
"""


def test_spawned_follower_process_over_a_file_store(tmp_path):
    """Rank 1 as a real process over a FileStore: tokens equal the JAX
    tp=1 engine's, the follower replays every step and exits 0 when rank
    0 stops it; then a killed follower makes rank 0's next step raise."""
    from paddle_tpu_torch.distributed.collective import new_group
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine
    w = _weights()
    flat = {k: v for k, v in w.items() if not isinstance(v, list)}
    for k, v in w.items():
        if isinstance(v, list):
            flat.update({f"{k}.{i}": a for i, a in enumerate(v)})
    np.savez(tmp_path / "w.npz", **flat)
    store = str(tmp_path / "store")

    def spawn():
        code = _FOLLOWER.format(repo=REPO, weights=str(tmp_path / "w.npz"),
                                layers=L, store=store, timeout=TIMEOUT_S,
                                kw=KW)
        return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    proc = spawn()
    try:
        g = new_group(0, 2, store, timeout=TIMEOUT_S)
        eng = FusedMultiTransformerEngine(w, tp=2, group=g, device="cpu",
                                          **KW)
        cb = _cb("port", eng)
        got = _run(cb, _reqs("port", "pl", WORKLOAD))
        assert got + [[cb._step_count]] == _jax_ref("plain")
        eng.stop_followers()
        out, err = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, err[-3000:]
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["steps"] == cb._step_count and stats["caches"] == 1
        assert stats["cache_bytes"] * 2 == \
            24 * _engine(1).kv_device_block_bytes(8)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT_S)

    # a follower that dies mid-service: rank 0 raises, never hangs
    os.unlink(store)
    proc = spawn()
    try:
        g = new_group(0, 2, store, timeout=TIMEOUT_S)
        eng = FusedMultiTransformerEngine(w, tp=2, group=g, device="cpu",
                                          **KW)
        cb = _cb("port", eng)
        cb.submit(_reqs("port", "dd", [(5, 6)])[0])
        cb.step()
        proc.kill()
        proc.wait(TIMEOUT_S)
        with pytest.raises(RuntimeError):
            for _ in range(8):
                cb.step()
        eng.stop_followers()            # a no-op on a broken group
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT_S)
