"""The PyTorch port's serving front door held against the JAX package on
the CPU: the SSE bytes and parser, the request and health validators,
the port's gateway over real TCP in front of the port's tiny f32 engine
streaming the JAX engine's ``generate()`` tokens for the same weights and
prompts, and the lifecycle answers (cancel, deadline, shed, 422, bad
requests, /healthz under a burn) equal to the JAX gateway's in front of
the JAX engine.

The JAX engine runs its ragged Pallas kernel in interpret mode, as the
JAX package's own serving tests do, and is built once per file; the port
runs the plain PyTorch versions of its kernels (CPU tensors)."""
import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import serving as jax_serving  # noqa: E402
from paddle_tpu.observability import (  # noqa: E402
    parse_prometheus as jax_parse, validate_report as jax_validate)
from paddle_tpu.ops.pallas import flash_attention as fa  # noqa: E402
from paddle_tpu_torch import serving as port_serving  # noqa: E402
from paddle_tpu_torch.observability import parse_prometheus  # noqa: E402
from tools.torch_serve_gates import (TINY_DIMS, GatewayThread,  # noqa: E402
                                     tiny_weights)

SMAX = 64
CB_KW = dict(num_blocks=40, block_size=8, max_batch=4, prefill_chunk=8,
             spec_k=2)


@pytest.fixture(autouse=True)
def _interpret():
    old = fa._INTERPRET
    fa._INTERPRET = True
    yield
    fa._INTERPRET = old


_ENGINES = {}


def engines():
    """(JAX engine, port engine, vocab) over the same weights, built once
    per process (the JAX engine's programs are instance-held)."""
    if not _ENGINES:
        from paddle_tpu.inference import FusedMultiTransformerEngine as JE
        from paddle_tpu_torch.inference import FusedMultiTransformerEngine
        V, E, H, G, D, L, F = TINY_DIMS
        w = tiny_weights(np.random.default_rng(0), TINY_DIMS)
        kw = dict(num_heads=H, head_dim=D, max_seq_len=SMAX,
                  dtype="float32", norm_type="rmsnorm", activation="swiglu",
                  gqa_group_size=G)
        _ENGINES["e"] = (JE(w, **kw),
                         FusedMultiTransformerEngine(w, device="cpu", **kw),
                         V)
    return _ENGINES["e"]


_REFS = {}


def jax_ref(prompt, n):
    """The JAX engine's greedy generate() tokens, memoised."""
    key = (tuple(prompt), n)
    if key not in _REFS:
        je, _, _ = engines()
        _REFS[key] = np.asarray(je.generate(
            np.asarray(prompt, np.int32)[None, :], max_new_tokens=n))[
                0, :n].tolist()
    return _REFS[key]


class FlagMonitor:
    """A real SLOMonitor whose ``last_report`` a test can force into a
    burn: /healthz and the shed gate read ``last_report['breaches']``."""

    def __init__(self, inner):
        self.inner = inner
        self.burn = False

    @property
    def last_report(self):
        return {"breaches": 1} if self.burn else self.inner.last_report

    def tick(self, now=None):
        return self.inner.tick(now)

    def report(self, now=None):
        return self.inner.report(now)


def flag_monitor(pkg):
    if pkg == "jax":
        from paddle_tpu.observability import SLOMonitor
    else:
        from paddle_tpu_torch.observability import SLOMonitor
    return FlagMonitor(SLOMonitor.from_config({
        "cadence_s": 60.0,
        "objectives": [{"name": "ttft_p99", "kind": "quantile",
                        "metric": "serve_ttft_seconds", "q": 0.99,
                        "max": 600.0}]}))


class Harness:
    """A live gateway of either package on 127.0.0.1, its asyncio loop on
    a thread of its own (the stepper has its own too); tests speak real
    HTTP over http.client, synchronously."""

    def __init__(self, serving, stepper, monitor=None):
        self.stepper = stepper.start()
        self.gw = serving.ServingGateway(self.stepper, monitor=monitor)
        self.thread = GatewayThread(self.gw).start()

    def close(self):
        self.thread.close()
        self.stepper.stop()

    def engine_queue(self):
        return len(self.stepper.engine.queue)

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.gw.port,
                                          timeout=60)
        payload = None if body is None else (
            body if isinstance(body, str) else json.dumps(body))
        headers = {"Content-Type": "application/json"} if payload else {}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    def stream(self, body, on_token=None):
        """POST a streaming generate: (status, events). `on_token(n)`
        fires after the n-th token event."""
        conn = http.client.HTTPConnection("127.0.0.1", self.gw.port,
                                          timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            data = json.loads(resp.read())
            conn.close()
            return resp.status, [("error", data)]
        lines, events, ntok = [], [], 0
        while True:
            line = resp.readline()
            if not line:
                break
            lines.append(line)
            if line.strip():
                continue
            frame = port_serving.parse_events(b"".join(lines))
            lines = []
            events += frame
            for etype, _ in frame:
                if etype == "token":
                    ntok += 1
                    if on_token is not None:
                        on_token(ntok)
            if events and events[-1][0] == "end":
                break
        conn.close()
        return 200, events


def _tokens(events):
    return [t for e, p in events if e == "token" for t in p["tokens"]]


def _end(events):
    ends = [p for e, p in events if e == "end"]
    return ends[0] if ends else None


def _leak_free(cb):
    a = cb.allocator
    return (a.num_used == 0 and not a._ref
            and a.num_free + a.num_pooled == a.num_blocks - a.reserved)


def _harness(pkg):
    if pkg == "jax":
        from paddle_tpu.incubate.nn import ContinuousBatchingEngine
        eng, serving = engines()[0], jax_serving
    else:
        from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
        eng, serving = engines()[1], port_serving
    mon = flag_monitor(pkg)
    cb = ContinuousBatchingEngine(eng, monitor=mon, shed_on_pressure=True,
                                  **CB_KW)
    h = Harness(serving, serving.EngineStepper(cb), monitor=mon)
    h.cb, h.monitor = cb, mon
    return h


@pytest.fixture(scope="module")
def gws():
    hs = {pkg: _harness(pkg) for pkg in ("jax", "port")}
    yield hs
    for h in hs.values():
        h.close()


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, TINY_DIMS[0], n)]


# -- the wire: bytes, parser, validators ------------------------------------

EVENTS = [("accepted", {"request": "g1"}),
          ("token", {"request": 7, "tokens": [1, 2, 3], "step": 4,
                     "index": 0}),
          ("end", {"request": "r", "status": "cancelled", "reason": None,
                   "preemptions": 2, "tokens": []}),
          ("end", {"request": "ü\n\"q\"", "error": "boom: ∞",
                   "tokens": [0]})]


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_format_event_bytes_equal_jax(i):
    event, data = EVENTS[i]
    assert port_serving.format_event(event, data) == \
        jax_serving.format_event(event, data)


SSE_TEXTS = [
    b"".join(jax_serving.format_event(e, d) for e, d in EVENTS),
    "event: token\r\ndata: {\"a\": 1}\r\n\r\n: comment\n\ndata: [1]\n\n",
    "data: {\"x\":\ndata: 2}\n\nevent: end\ndata:{\"y\": 3}",
    "event: lonely\n\n\n\nevent:t\ndata: 5\n",
]


@pytest.mark.parametrize("i", range(len(SSE_TEXTS)))
def test_parse_events_equal_jax(i):
    text = SSE_TEXTS[i]
    got = port_serving.parse_events(text)
    assert got == jax_serving.parse_events(text)
    lines = text.splitlines(keepends=True)
    assert list(port_serving.iter_events(lines)) == \
        list(jax_serving.iter_events(lines)) == got


BODIES = [
    {"prompt": [1, 2, 3], "max_new_tokens": 4},
    {"prompt": [5], "max_new_tokens": 1, "request_id": 9, "priority": 2,
     "deadline_steps": 3, "deadline_s": 0.5, "spec_k": 0,
     "temperature": 0.7, "stream": False},
    [], {"prompt": [], "max_new_tokens": 1}, {"prompt": [1, -2],
                                              "max_new_tokens": 1},
    {"prompt": [1, True], "max_new_tokens": 1},
    {"prompt": [1], "max_new_tokens": 0}, {"prompt": [1]},
    {"prompt": [1], "max_new_tokens": 1, "bogus": 1},
    {"prompt": [1], "max_new_tokens": 1, "request_id": 1.5},
    {"prompt": [1], "max_new_tokens": 1, "priority": -1},
    {"prompt": [1], "max_new_tokens": 1, "deadline_steps": 0},
    {"prompt": [1], "max_new_tokens": 1, "deadline_s": True},
    {"prompt": [1], "max_new_tokens": 1, "spec_k": -1},
    {"prompt": [1], "max_new_tokens": 1, "temperature": -0.1},
    {"prompt": [1], "max_new_tokens": 1, "stream": "yes"},
]


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_validate_generate_body_equal_jax(i):
    assert port_serving.validate_generate_body(BODIES[i]) == \
        jax_serving.validate_generate_body(BODIES[i])


def _healthz(**kw):
    base = {"schema": jax_serving.HEALTHZ_SCHEMA, "status": "ok",
            "reason": None, "inflight": 0, "queue_depth": 1, "steps": 3,
            "finished": 2}
    base.update(kw)
    return base


HEALTHZ = [
    _healthz(), _healthz(status="degraded", reason="slo_burn"),
    _healthz(status="degraded"), _healthz(status="bad"), _healthz(steps=-1),
    _healthz(schema="x/1"), {"schema": jax_serving.HEALTHZ_SCHEMA},
    _healthz(mesh={"tp": 1, "devices": [{"device": 0, "kv_bytes_used": 5,
                                         "kv_bytes_high_water": 9}]}),
    _healthz(mesh={"tp": 2, "devices": []}), "not a dict",
]


@pytest.mark.parametrize("i", range(len(HEALTHZ)))
def test_validate_healthz_equal_jax(i):
    def verdict(serving):
        try:
            serving.validate_healthz(HEALTHZ[i])
            return "ok"
        except ValueError as e:
            return str(e)
    assert verdict(port_serving) == verdict(jax_serving)


def test_status_codes_and_schemas_equal_jax():
    for name in ("STATUS_HTTP", "HEALTHZ_SCHEMA", "REQUESTS_SCHEMA",
                 "DUMPS_SCHEMA", "POLICIES"):
        got, ref = getattr(port_serving, name), getattr(jax_serving, name)
        if name == "POLICIES":
            got, ref = sorted(got), sorted(ref)
        assert got == ref, name
    assert sorted(port_serving.__all__) == sorted(jax_serving.__all__)


# -- the slice: the port's gateway streams the JAX engine's tokens ----------

def test_concurrent_streams_are_jax_generate(gws):
    h = gws["port"]
    work = [(_prompt(10 + j, p), n)
            for j, (p, n) in enumerate(((5, 6), (11, 5), (16, 8), (7, 4)))]
    refs = [jax_ref(p, n) for p, n in work]
    out = [None] * len(work)

    def run(j):
        p, n = work[j]
        out[j] = h.stream({"prompt": p, "max_new_tokens": n,
                           "request_id": f"cs{j}"})

    h.stepper.hold()
    threads = [threading.Thread(target=run, args=(j,)) for j in
               range(len(work))]
    for t in threads:
        t.start()
    # all four are queued in the engine before a step runs
    for _ in range(200):
        if h.engine_queue() == len(work):
            break
        threading.Event().wait(0.01)
    h.stepper.release()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for j, (code, events) in enumerate(out):
        assert code == 200 and events[0][0] == "accepted"
        assert _tokens(events) == refs[j], j
        assert _end(events)["status"] == "finished"
        assert _end(events)["tokens"] == refs[j]
    code, body = h.request("POST", "/v1/generate", {
        "prompt": work[2][0], "max_new_tokens": work[2][1],
        "stream": False})
    assert code == 200 and json.loads(body)["tokens"] == refs[2]
    assert h.stepper.call(_leak_free).result(30)


def test_control_plane_parses_with_jax_parsers(gws):
    h = gws["port"]
    p = _prompt(20, 7)
    code, body = h.request("POST", "/v1/generate", {
        "prompt": p, "max_new_tokens": 3, "stream": False})
    assert code == 200 and json.loads(body)["tokens"] == jax_ref(p, 3)
    code, body = h.request("GET", "/metrics")
    assert code == 200
    fams = jax_parse(body.decode())
    assert json.dumps(fams, default=repr, sort_keys=True) == json.dumps(
        parse_prometheus(body.decode()), default=repr, sort_keys=True)
    assert {"gateway_responses_total", "gateway_request_seconds",
            "serve_ttft_seconds", "kv_blocks_free"} <= set(fams)
    code, body = h.request("GET", "/slo")
    assert code == 200
    jax_validate(json.loads(body))
    code, body = h.request("GET", "/healthz")
    assert code == 200
    jax_serving.validate_healthz(json.loads(body))
    code, body = h.request("GET", "/requests")
    assert code == 200 and json.loads(body)["schema"] == \
        jax_serving.REQUESTS_SCHEMA


# -- lifecycle answers equal to the JAX gateway's ---------------------------

def _cancel(h, tag):
    p = _prompt(31, 9)
    ref = jax_ref(p, 24)
    dels = []

    def hook(n):
        if n == 2:
            dels.append(h.request("DELETE", f"/v1/requests/{tag}c")[0])

    code, events = h.stream({"prompt": p, "max_new_tokens": 24,
                             "request_id": f"{tag}c"}, on_token=hook)
    end, toks = _end(events), _tokens(events)
    return (code, dels, end["status"], end["reason"], len(toks) >= 2,
            toks == ref[:len(toks)], end["tokens"] == toks)


def _deadline(h, tag):
    code, body = h.request("POST", "/v1/generate", {
        "prompt": _prompt(32, 16), "max_new_tokens": 4,
        "request_id": f"{tag}d", "deadline_steps": 1, "stream": False})
    body = json.loads(body)
    return code, {k: v for k, v in body.items() if k != "request"}


def _shed(h, tag):
    h.monitor.burn = True
    try:
        code, events = h.stream({"prompt": _prompt(33, 6),
                                 "max_new_tokens": 4, "priority": 2,
                                 "request_id": f"{tag}s"})
    finally:
        h.monitor.burn = False
    end = _end(events)
    return code, [e for e, _ in events], end["status"], end["reason"], \
        end["tokens"]


def _healthz_burn(h, tag):
    out = []
    for burn in (True, False):
        h.monitor.burn = burn
        code, body = h.request("GET", "/healthz")
        body = json.loads(body)
        out.append((code, body["status"], body["reason"]))
    return out


def _reject(h, tag):
    code, body = h.request("POST", "/v1/generate", {
        "prompt": [1, 2, 3], "max_new_tokens": 2, "request_id": f"{tag}r",
        "spec_k": 99})
    body = json.loads(body)
    return code, {k: v for k, v in body.items() if k != "request"}


def _bad_requests(h, tag):
    return [h.request("POST", "/v1/generate", "{not json")[0],
            h.request("POST", "/v1/generate", {"prompt": []})[0],
            h.request("GET", "/v1/generate")[0],
            h.request("GET", "/nowhere")[0],
            h.request("DELETE", f"/v1/requests/{tag}-unknown")[0],
            h.request("GET", f"/requests/{tag}-unknown")[0]]


SCENARIOS = {"cancel": _cancel, "deadline": _deadline, "shed": _shed,
             "healthz_burn": _healthz_burn, "reject": _reject,
             "bad_requests": _bad_requests}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_lifecycle_answers_equal_jax_gateway(gws, name):
    got = SCENARIOS[name](gws["port"], f"port-{name}")
    ref = SCENARIOS[name](gws["jax"], f"jax-{name}")
    assert got == ref
    for pkg in ("port", "jax"):
        h = gws[pkg]
        assert h.stepper.call(_leak_free).result(30), pkg
        assert h.stepper.error is None


def test_lifecycle_answers_are_the_expected_ones(gws):
    """What the equality above pins, spelled out once for the port."""
    h = gws["port"]
    code, dels, status, _, at_least_two, prefix, _ = _cancel(h, "x")
    assert (code, dels, status, at_least_two, prefix) == \
        (200, [200], "cancelled", True, True)
    assert _deadline(h, "x")[0] == 504
    assert _shed(h, "x")[2:4] == ("shed", "slo_burn")
    assert _healthz_burn(h, "x") == [(503, "degraded", "slo_burn"),
                                     (200, "ok", None)]
    assert _reject(h, "x") == (422, {"status": "rejected",
                                     "reason": "spec_k_exceeds_engine",
                                     "tokens": []})
    assert _bad_requests(h, "x") == [400, 400, 405, 404, 404, 404]
