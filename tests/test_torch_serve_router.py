"""The PyTorch port's multi-replica router held against the JAX package
on the CPU: every routing policy picks the JAX policy's replica on the
same route views, and a pool of the port's engines behind
``EngineRouter`` (and behind the port's gateway) streams the JAX engine's
``generate()`` tokens under every policy, a crashed replica's queued
request finishing on the survivor. The JAX engine runs in interpret mode
and is built once per file (``test_torch_serving_gateway.engines``)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402
from paddle_tpu.serving import router as jax_router  # noqa: E402
from paddle_tpu_torch import serving as port_serving  # noqa: E402
from paddle_tpu_torch.serving import router as port_router  # noqa: E402
from test_torch_serving_gateway import (  # noqa: E402
    Harness, _end, _leak_free, _tokens, engines, jax_ref)
from tools.torch_serve_gates import (crash_scenario,  # noqa: E402
                                     family_prompts, run_wave)

POOL_KW = dict(num_blocks=40, block_size=8, max_batch=4, prefill_chunk=8,
               prefix_cache=True)


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    yield
    fa._INTERPRET = old


# -- policies: the same replica on the same views ---------------------------

def _views(seed, n=60):
    """(live, inflight, summaries, keys) draws: pools of 1-4 replicas with
    drained slots, loads 0-6, prefix summaries sharing leading runs of
    the prompt's key ladder."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(1, 5))
        live = tuple(int(i) for i in range(size) if rng.random() < 0.8) \
            or (0,)
        inflight = {i: int(rng.integers(0, 7)) for i in range(size)}
        ladder = tuple(f"k{seed}_{j}" for j in range(int(rng.integers(0, 6))))
        summaries = {i: frozenset(ladder[:int(rng.integers(0, len(ladder)
                                                           + 1))]
                                  + (("other",) if rng.random() < 0.3
                                     else ()))
                     for i in range(size)}
        out.append((live, inflight, summaries, ladder))
    return out


POLICY_CASES = [("round_robin", {}), ("least_loaded", {}),
                ("prefix_affinity", {}),
                ("prefix_affinity", {"imbalance_cap": 1}),
                ("prefix_affinity", {"imbalance_cap": 3})]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_policies_pick_the_jax_replica(case, seed):
    name, kw = POLICY_CASES[case]
    jp = jax_router.POLICIES[name](**kw)
    pp = port_router.POLICIES[name](**kw)
    picks = []
    for live, inflight, summaries, keys in _views(seed):
        got = pp.choose(port_router.RouteView(live, dict(inflight),
                                              dict(summaries), keys))
        ref = jp.choose(jax_router.RouteView(live, dict(inflight),
                                             dict(summaries), keys))
        assert got == ref, (live, inflight, summaries, keys)
        picks.append(got)
    assert len({json.dumps(p) for p in picks}) > 1   # the views vary


def test_policy_validation_equal_jax():
    for mod in (jax_router, port_router):
        with pytest.raises(ValueError):
            mod.PrefixAffinityPolicy(imbalance_cap=0)
        with pytest.raises(ValueError, match="at least one replica"):
            mod.EngineRouter([])


# -- pools of the port's engines --------------------------------------------

def _pool(policy, replicas=2):
    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    te = engines()[1]
    steppers = [port_serving.EngineStepper(
        ContinuousBatchingEngine(te, **POOL_KW), name=f"test-replica-{i}")
        for i in range(replicas)]
    return port_serving.EngineRouter(steppers, policy=policy).start()


def _families():
    return family_prompts(np.random.default_rng(5), engines()[2], 3, 3,
                          16, 8, 3)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity"])
def test_pool_streams_jax_tokens_under_every_policy(policy):
    prompts = _families()
    refs = {k: jax_ref(p, 4) for k, p in prompts.items()}
    router = _pool(policy)
    try:
        subs = run_wave(router, prompts, 3, 3, 4,
                        lambda m, r: f"{policy}.f{m}r{r}")
        for key, sub in subs.items():
            assert sub.end["status"] == "finished", key
            assert sub.tokens == refs[key], key
        stats = [s.call(lambda c: dict(c.cache_stats)).result(30)
                 for s in router.steppers]
        hits = sum(s["hit_blocks"] for s in stats)
        if policy == "prefix_affinity":
            # every resume maps its family's cached blocks: 2 resumes x 3
            # families x the blocks of the shorter prompt it extends
            assert hits == 3 * ((19 // 8) + (27 // 8))
        assert all(s.call(_leak_free).result(30) for s in router.steppers)
        assert router.error is None
    finally:
        router.stop()


def test_gateway_over_router_and_a_crashed_replica():
    router = _pool("round_robin")
    h = Harness(port_serving, router)
    try:
        # one request on each replica (round robin), so the rotation
        # points at replica 0 again for the crash below
        for j, n in enumerate((13, 6)):
            p = [int(t) for t in
                 np.random.default_rng(6 + j).integers(1, 128, n)]
            code, events = h.stream({"prompt": p, "max_new_tokens": 5,
                                     "request_id": f"via-router{j}"})
            assert code == 200 and _tokens(events) == jax_ref(p, 5)
            assert _end(events)["status"] == "finished"
        code, hz = h.request("GET", "/healthz")
        assert code == 200 and json.loads(hz)["status"] == "ok"

        rng = np.random.default_rng(8)
        prompts = {k: [int(t) for t in rng.integers(1, 128, n)]
                   for k, n in (("stream", 5), ("bystander", 11),
                                ("victim", 19), ("post", 7))}
        news = {"stream": 24, "bystander": 4, "victim": 4, "post": 4}
        from paddle_tpu_torch.observability import tracing
        subs, steps, target, post = crash_scenario(
            router, prompts, news, tracing.get_tracer())
        a, c = subs["stream"], subs["victim"]
        assert (a.end["status"], a.end["reason"]) == \
            ("failed", "engine_error")
        assert a.tokens == jax_ref(prompts["stream"], 24)[:len(a.tokens)]
        assert c.end["status"] == "finished" and target == 1
        assert c.tokens == jax_ref(prompts["victim"], 4)
        assert subs["post"].tokens == jax_ref(prompts["post"], 4)
        assert post == 1 and router.live_replicas() == [1]
        # the pool survives: /healthz still answers ok, the survivor's
        # pool is whole
        assert router.error is None
        code, hz = h.request("GET", "/healthz")
        assert code == 200 and json.loads(hz)["status"] == "ok"
        assert router.steppers[1].call(_leak_free).result(30)
    finally:
        h.close()
