#!/usr/bin/env python
"""Serving gates of the PyTorch port: the HTTP/SSE gateway, the
multi-replica router and the fault-injection (chaos) harness, over the
port's ``ContinuousBatchingEngine`` (``paddle_tpu_torch``).

The port's form of ``tools/serve_gateway.py``, ``tools/serve_replica.py``
and ``tools/serve_chaos.py``: three legs that emit the same report
schemas, driven from the configs of the committed baselines
(``tools/serve_gateway.json``, ``serve_replica.json``,
``serve_chaos.json``):

* **gateway** — a real-TCP gateway on 127.0.0.1 and an asyncio client,
  three passes on one engine (cold, prefix-cache warm, after
  ``declare_warm``): concurrent SSE streams byte-identical to
  ``engine.generate()`` with the span ring's emission order, one
  mid-stream cancel, one deadline, one shed under a forced burn with
  /healthz degrading, one 422 rejection, the control plane parsing, KV
  gauges back at baseline, zero new step buckets after warmup;
* **replica** — N replicas behind ``EngineRouter`` under every policy on
  a shared-prefix workload (token-exact, prefix affinity strictly beats
  round robin on exact cache counts) and a crash of one replica
  (queued request resubmitted to the survivor, streamed one failed
  structured, later submits on the survivor only);
* **chaos** — alloc outages, dispatch stalls, cancels, dump-write
  failures and a step-clock shed window through ``FaultInjector``:
  survivors token-exact, partials exact prefixes, gauges at baseline,
  pass 3 replaying pass 2;
* **tp** — tensor-parallel serving (``tools/serve_tp.json``, the JAX
  package's ``serve_bench.py --tp`` baseline): for each tp the same
  scheduler on rank 0 of a group whose other ranks are threads of this
  process (``ThreadRanks``: a ``HashStore`` and gloo, 60 s timeout)
  drives plain / chunked / spec / prefix workloads; every mode
  token-exact against tp=1, per-rank KV high-water bytes exactly 1/tp,
  the collective payload and zero new buckets after warmup. It runs on
  the CPU (8 q / 8 kv heads of 8 dims, below the card's attention
  kernel; chip_smoke.py's phase 25 serves tp on the card);
* **autotune** — the serving autotuner (``tools/serve_autotune.json``'s
  ``gate.autotune``, the JAX package's ``serve_bench.py --autotune``
  baseline): the model-ranked sweep of ``ops.autotune`` over the tiny
  engine's decode and chunk-8 buckets gives the committed pack /
  prefill_chunk winners (``split_waves``, the port's knob, in
  ``buffer_depth``'s place), twice; the scheduler built from the cache
  serves the workload's tokens in the untuned run's steps, with zero new
  buckets after warm-up and the cache counters moved at construction
  only. On the card the engine's head dim is 32, so the shape class is
  another and only these invariants hold (phase 29 of chip_smoke.py
  sweeps on the card).

The engine is the tiny serving engine of ``tools/serve_bench.py``
(V=128, E=64, 4 q / 2 kv heads, L=2, f32) built from the same numpy
draws (this file keeps its own copy of the weight draws). With
``--device cpu`` every host-deterministic field of a committed baseline
(tokens, statuses, per-event token widths, routing tables, cache
counters) must be reproduced exactly: the baselines are f32 CPU runs of
the JAX engine. On the GPU (the default) the kernel takes head dims 32,
64 and 128, so the engine's head dim is 32 there; the gates hold the
port to its own references and the baselines' tokens are not compared.
Latencies are reported, never gated.

Usage:
  python tools/torch_serve_gates.py [--device cpu] [--json OUT]
  python tools/torch_serve_gates.py --device cpu \
      --check tools/serve_gateway.json
  python tools/torch_serve_gates.py --device cpu \
      --check tools/serve_tp.json
  python tools/torch_serve_gates.py --device cpu \
      --check tools/serve_autotune.json
"""
import argparse
import asyncio
import contextlib
import json
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASELINES = {"gateway": "tools/serve_gateway.json",
             "replica": "tools/serve_replica.json",
             "chaos": "tools/serve_chaos.json",
             "tp": "tools/serve_tp.json",
             "autotune": "tools/serve_autotune.json"}
SCHEMAS = {"gateway": "paddle_tpu.serve_gateway/1",
           "replica": "paddle_tpu.serve_replica/1",
           "chaos": "paddle_tpu.serve_chaos/1"}

# V, E, H, G, D, L, F of tools/serve_bench.py's tiny engine; the card's
# ragged-attention kernel takes D in (32, 64, 128)
TINY_DIMS = (128, 64, 4, 2, 16, 2, 96)
CARD_DIMS = (128, 64, 4, 2, 32, 2, 96)
# tools/serve_bench.py's tensor-parallel engine: 8 q / 8 kv heads, so the
# kv-head axis splits at tp = 1, 2, 4, 8
TP_DIMS = (128, 64, 8, 8, 8, 2, 96)
TP_TIMEOUT_S = 60.0


# -- the engine ---------------------------------------------------------------

def tiny_weights(rng, dims):
    """Raw f32 weights drawn in tools/serve_bench.py's order
    (``_tiny_cpu_weights``)."""
    import numpy as np

    V, E, H, G, D, L, F = dims

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


def tiny_engine(rng, max_seq_len, device, autotune_cache=None):
    """(the port's f32 engine on `device`, vocab). Takes the caller's rng
    so the weight draws stay at the head of its stream, as in
    tools/serve_bench.py; ``autotune_cache`` passes through."""
    from paddle_tpu_torch.inference import (FusedMultiTransformerEngine,
                                            engine_weights_from_numpy)

    dims = TINY_DIMS if device == "cpu" else CARD_DIMS
    V, E, H, G, D, L, F = dims
    eng = FusedMultiTransformerEngine(
        engine_weights_from_numpy(tiny_weights(rng, dims), device,
                                  "float32"),
        num_heads=H, head_dim=D, max_seq_len=max_seq_len, dtype="float32",
        norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
        autotune_cache=autotune_cache, device=device)
    return eng, V


def _ref(eng, prompt, n):
    import numpy as np
    return np.asarray(eng.generate(np.asarray(prompt, np.int32)[None, :],
                                   max_new_tokens=n))[0, :n].tolist()


def alloc_baseline(cb):
    """No physical block held, refcount table empty, free + pooled
    covering the whole allocatable pool."""
    a = cb.allocator
    return (a.num_used == 0 and not a._ref
            and a.num_free + a.num_pooled == a.num_blocks - a.reserved)


class GatewayThread:
    """A ServingGateway's asyncio loop on a thread of its own, so that a
    caller can drive the gateway synchronously, or from a loop of its own
    (an asyncio client on the main thread)."""

    def __init__(self, gw):
        self.gw = gw
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._run, name="gateway",
                                        daemon=True)

    def start(self, timeout=30.0):
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("the gateway did not start")
        if self._error is not None:
            raise RuntimeError("the gateway did not start") from self._error
        return self

    def _run(self):
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.gw.start())
        except Exception as e:      # reported by start() on the caller
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()

    def close(self, timeout=10.0):
        asyncio.run_coroutine_threadsafe(self.gw.close(),
                                         self.loop).result(timeout)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the gateway thread did not stop")
        self.loop.close()


# -- minimal asyncio HTTP/SSE client ------------------------------------------

async def request(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    # one-shot client: opt out of keep-alive so read-to-EOF terminates
    head = (f"{method} {path} HTTP/1.1\r\nHost: gw\r\n"
            "Connection: close\r\n")
    if payload:
        head += ("Content-Type: application/json\r\n"
                 f"Content-Length: {len(payload)}\r\n")
    writer.write(head.encode() + b"\r\n" + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    with contextlib.suppress(OSError):
        await writer.wait_closed()
    headb, _, rest = data.partition(b"\r\n\r\n")
    return int(headb.split(None, 2)[1]), rest


async def get_json(port, path):
    code, body = await request(port, "GET", path)
    return code, json.loads(body)


async def open_stream(port, body):
    """POST a streaming generate; (status, reader, writer) positioned
    after the response headers."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: gw\r\n"
                  "Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    status = int((await reader.readline()).split(None, 2)[1])
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
    return status, reader, writer


async def next_sse(reader):
    """One SSE frame -> (event, payload), or None on EOF."""
    etype, data = None, []
    while True:
        line = await reader.readline()
        if not line:
            return None
        line = line.decode().rstrip("\r\n")
        if line == "":
            if data:
                return etype or "message", json.loads("\n".join(data))
            continue
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "event":
            etype = value
        elif field == "data":
            data.append(value)


async def drain_events(reader, writer, events=None):
    """Read frames through the `end` event (or EOF) and close."""
    events = [] if events is None else events
    while True:
        ev = await next_sse(reader)
        if ev is None:
            break
        events.append(ev)
        if ev[0] == "end":
            break
    writer.close()
    return events


async def run_stream(port, body, cancel_after=None):
    """Drive one SSE stream to its `end` event; with `cancel_after`,
    DELETE the request after that many token events. Returns
    (http_status, events, delete_status)."""
    status, reader, writer = await open_stream(port, body)
    events, ntok, del_code = [], 0, None
    if status == 200:
        while True:
            ev = await next_sse(reader)
            if ev is None:
                break
            events.append(ev)
            if ev[0] == "token":
                ntok += 1
                if cancel_after is not None and ntok == cancel_after:
                    del_code, _ = await request(
                        port, "DELETE",
                        f"/v1/requests/{body['request_id']}")
            if ev[0] == "end":
                break
    writer.close()
    with contextlib.suppress(OSError):
        await writer.wait_closed()
    return status, events, del_code


def stream_tokens(events):
    return [t for e, p in events if e == "token" for t in p["tokens"]]


def _token_widths(events):
    return [len(p["tokens"]) for e, p in events if e == "token"]


def end_event(events):
    ends = [p for e, p in events if e == "end"]
    return ends[0] if ends else None


# -- gateway leg --------------------------------------------------------------

class BurnFlagMonitor:
    """SLOMonitor wrapper whose ``last_report`` the gate can force into a
    burn: the engine's pressure-aware admission and the gateway's
    /healthz both read ``last_report["breaches"]``, so flipping the flag
    drives the production shed and degrade paths on a deterministic
    trigger."""

    def __init__(self, inner):
        self.inner = inner
        self.force_burn = False

    @property
    def last_report(self):
        if self.force_burn:
            return {"breaches": 1, "forced": True}
        return self.inner.last_report

    def tick(self, now=None):
        return self.inner.tick(now)

    def report(self, now=None):
        return self.inner.report(now)


def _expected_emissions(rid, prompt_len):
    """Per-emission token widths the span ring predicts for `rid`: one
    1-token emission from the prefill chunk that reached the prompt's
    end, then each decode span's `emitted`."""
    from paddle_tpu_torch.observability import tracing

    out = []
    for s in tracing.get_tracer().spans(request=rid):
        a = s["args"] or {}
        if s["name"] == "prefill_chunk" and a.get("progress") == prompt_len:
            out.append(1)
        elif s["name"] == "decode":
            out.append(a.get("emitted", 1))
    return out


async def _drive_pass(gw, stepper, monitor, workload, refs, tag, faulted):
    """One scenario suite against a live gateway. `faulted` runs the
    cancel / deadline / shed variants; a plain pass runs those requests
    to completion (warmup must see their full solo shapes)."""
    from paddle_tpu_torch.observability import tracing

    port = gw.port
    tracing.get_tracer().clear()
    report = {"tag": tag}

    # concurrent streams, held so that all land on one admission pass
    stepper.hold()
    tasks = []
    for j, (p, n) in enumerate(workload["streams"]):
        body = {"prompt": refs[f"s{j}"]["prompt"], "max_new_tokens": n,
                "request_id": f"{tag}s{j}"}
        st, reader, writer = await open_stream(port, body)
        if st != 200:
            raise RuntimeError(f"stream {j} HTTP {st}")
        first = await next_sse(reader)
        if not first or first[0] != "accepted":
            raise RuntimeError(f"stream {j} opened with {first}")
        tasks.append((j, reader, writer))
    stepper.release()
    drained = await asyncio.gather(
        *(drain_events(r, w, [("accepted", {})]) for _, r, w in tasks))
    stream_ok, emissions, statuses = True, {}, {}
    for (j, _, _), events in zip(tasks, drained):
        rid = f"{tag}s{j}"
        end = end_event(events)
        statuses[f"s{j}"] = end["status"] if end else None
        toks = stream_tokens(events)
        ref = refs[f"s{j}"]["tokens"]
        if not (end and end["status"] == "finished" and toks == ref
                and end["tokens"] == ref):
            stream_ok = False
        widths = _token_widths(events)
        emissions[f"s{j}"] = widths
        if widths != _expected_emissions(rid,
                                         len(refs[f"s{j}"]["prompt"])):
            report.setdefault("sse_order_mismatch", []).append(rid)
    report["streams_token_exact"] = stream_ok
    report["stream_emissions"] = emissions
    report["sse_order_matches_spans"] = \
        "sse_order_mismatch" not in report

    # mid-stream cancel (unfaulted: a full solo run for warmup)
    c = workload["cancel"]
    body = {"prompt": refs["cancel"]["prompt"],
            "max_new_tokens": c["max_new_tokens"],
            "request_id": f"{tag}c0"}
    st, events, del_code = await run_stream(
        port, body, cancel_after=c["after_events"] if faulted else None)
    end = end_event(events)
    toks = stream_tokens(events)
    ref = refs["cancel"]["tokens"]
    statuses["cancel"] = end["status"] if end else None
    if faulted:
        report["cancel_delete_code"] = del_code
        report["cancel_ok"] = bool(
            st == 200 and del_code == 200 and end
            and end["status"] == "cancelled"
            and len(toks) >= c["after_events"]
            and toks == ref[:len(toks)])
    else:
        report["cancel_ok"] = bool(end and end["status"] == "finished"
                                   and toks == ref)

    # deadline (non-stream: the status maps to the HTTP code)
    d = workload["deadline"]
    body = {"prompt": refs["deadline"]["prompt"],
            "max_new_tokens": d["max_new_tokens"],
            "request_id": f"{tag}d0", "stream": False}
    if faulted:
        body["deadline_steps"] = d["deadline_steps"]
    code, resp = await request(port, "POST", "/v1/generate", body)
    resp = json.loads(resp)
    statuses["deadline"] = resp["status"]
    ref_d = refs["deadline"]["tokens"]
    if faulted:
        # partial tokens are kept at the deadline: an exact prefix
        report["deadline_ok"] = bool(
            code == 504 and resp["status"] == "deadline_exceeded"
            and resp["tokens"] == ref_d[:len(resp["tokens"])])
    else:
        report["deadline_ok"] = bool(
            code == 200 and resp["status"] == "finished"
            and resp["tokens"] == ref_d)

    # shed under a forced burn, /healthz degrading while it is up
    s = workload["shed"]
    body = {"prompt": refs["shed"]["prompt"],
            "max_new_tokens": s["max_new_tokens"],
            "request_id": f"{tag}h0", "priority": s["priority"]}
    if faulted:
        monitor.force_burn = True
        hcode, hz = await get_json(port, "/healthz")
        st, events, _ = await run_stream(port, body)
        end = end_event(events)
        monitor.force_burn = False
        hcode2, hz2 = await get_json(port, "/healthz")
        statuses["shed"] = end["status"] if end else None
        report["healthz_degraded"] = (hcode, hz.get("status"),
                                      hz.get("reason"))
        report["shed_ok"] = bool(
            st == 200 and end and end["status"] == "shed"
            and end["reason"] == "slo_burn")
        report["healthz_flips"] = bool(
            hcode == 503 and hz["status"] == "degraded"
            and hz["reason"] == "slo_burn" and hcode2 == 200
            and hz2["status"] == "ok")
    else:
        st, events, _ = await run_stream(port, body)
        end = end_event(events)
        statuses["shed"] = end["status"] if end else None
        report["shed_ok"] = bool(end and end["status"] == "finished")

    # structured rejection: spec_k wider than the engine
    code, resp = await request(
        port, "POST", "/v1/generate",
        {"prompt": [1, 2, 3], "max_new_tokens": 2,
         "request_id": f"{tag}r0", "spec_k": 99})
    resp = json.loads(resp)
    statuses["reject"] = resp.get("status")
    report["reject_ok"] = bool(
        code == 422 and resp["status"] == "rejected"
        and resp["reason"] == "spec_k_exceeds_engine")

    report["gauges_baseline"] = await asyncio.wrap_future(
        stepper.call(alloc_baseline))
    report["statuses"] = statuses
    return report


async def check_control_plane(port, rid=None):
    """/metrics, /slo and /healthz (and, with `rid`, /requests and
    /dumps) must parse against their schemas."""
    from paddle_tpu_torch.observability import (parse_prometheus,
                                                validate_report)
    from paddle_tpu_torch.serving import validate_healthz

    out = {}
    code, body = await request(port, "GET", "/metrics")
    fams = parse_prometheus(body.decode())
    needed = {"gateway_responses_total", "gateway_request_seconds",
              "gateway_stream_seconds", "gateway_live_connections",
              "gateway_live_streams", "gateway_sse_pending_events",
              "gateway_sse_events_total", "serve_ttft_seconds",
              "serve_tokens_total", "kv_blocks_free"}
    missing = sorted(needed - set(fams))
    out["metrics_parse"] = bool(code == 200 and not missing)
    if missing:
        out["metrics_missing"] = missing
    code, rep = await get_json(port, "/slo")
    try:
        validate_report(rep)
        out["slo_parse"] = code == 200
    except ValueError as e:
        out["slo_parse"] = False
        out["slo_error"] = str(e)
    code, hz = await get_json(port, "/healthz")
    try:
        validate_healthz(hz)
        out["healthz_parse"] = code == 200
    except ValueError as e:
        out["healthz_parse"] = False
        out["healthz_error"] = str(e)
    if rid is None:
        return out
    code, digest = await get_json(port, f"/requests/{rid}")
    out["request_digest_parse"] = bool(
        code == 200 and digest.get("request") == rid
        and digest.get("retired") is True
        and {"ttft_s", "prefill_chunks", "decode_steps",
             "stalls"} <= set(digest))
    code, listing = await get_json(port, "/requests")
    out["requests_list_parse"] = bool(
        code == 200 and listing.get("count", 0) >= 1
        and any(d["request"] == rid for d in listing["requests"]))
    code, dumps = await get_json(port, "/dumps")
    ok = code == 200 and dumps.get("armed") and dumps["retained"]
    if ok:
        name = dumps["retained"][-1]["file"]
        code, blob = await request(port, "GET", f"/dumps/{name}")
        payload = json.loads(blob)
        ok = code == 200 and payload.get("schema", "").startswith(
            "paddle_tpu.flight_recorder/")
    out["dumps_parse"] = bool(ok)
    return out


def gateway_leg(config, device, flight_dir=None):
    import numpy as np

    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from paddle_tpu_torch.observability import SLOMonitor, tracing
    from paddle_tpu_torch.serving import EngineStepper, ServingGateway

    ecfg = config["engine"]
    eng, V = tiny_engine(np.random.default_rng(ecfg["seed"]),
                         ecfg["max_seq_len"], device)
    wl = config["workload"]
    wrng = np.random.default_rng(wl["seed"])

    def _mk(plen):
        return [int(t) for t in wrng.integers(1, V, plen)]

    prompts = {f"s{j}": _mk(p) for j, (p, n) in enumerate(wl["streams"])}
    news = {f"s{j}": n for j, (p, n) in enumerate(wl["streams"])}
    for k in ("cancel", "deadline", "shed"):
        prompts[k] = _mk(wl[k]["prompt_len"])
        news[k] = wl[k]["max_new_tokens"]
    refs = {k: {"prompt": p, "tokens": _ref(eng, p, news[k])}
            for k, p in prompts.items()}

    monitor = BurnFlagMonitor(SLOMonitor.from_config(config["slo"]))
    kw = dict(num_blocks=ecfg["num_blocks"], block_size=ecfg["block_size"],
              max_batch=ecfg["max_batch"],
              prefill_chunk=ecfg["prefill_chunk"], spec_k=ecfg["spec_k"])
    cb = ContinuousBatchingEngine(
        eng, prefix_cache=ecfg["prefix_cache"], monitor=monitor,
        shed_on_pressure=True, shed_priority_min=ecfg["shed_priority_min"],
        **kw)
    # the same four streams with no HTTP in the path, for the overhead
    # table (a fresh scheduler on the same engine)
    cb_direct = ContinuousBatchingEngine(eng, **kw)
    fr = tracing.get_flight_recorder()
    fr.arm(flight_dir or tempfile.mkdtemp(prefix="torch_serve_gateway_"))
    stepper = EngineStepper(cb).start()
    gw = ServingGateway(stepper, monitor=monitor)

    async def _main():
        await gw.start()
        passes, walls, warm = [], [], None
        for k, (tag, faulted) in enumerate(
                (("p1", False), ("p2", True), ("p3", True))):
            if k == 2:
                warm = set(cb._seen_buckets)
                await asyncio.wrap_future(
                    stepper.call(lambda c: c.declare_warm()))
            t0 = time.perf_counter()
            passes.append(await _drive_pass(gw, stepper, monitor, wl, refs,
                                            tag, faulted))
            walls.append(time.perf_counter() - t0)
        # evidence for the /dumps round trip, then the control plane
        tracing.write_dump(os.path.join(fr._dir,
                                        "flightrec_manual_gate_0.json"),
                           reason="manual", gate="serve_gateway")
        control = await check_control_plane(gw.port, "p3s0")
        await gw.close()
        return passes, warm, control, walls

    try:
        passes, warm, control, walls = asyncio.run(_main())
    finally:
        stepper.stop()
    if stepper.error is not None:
        raise RuntimeError("the stepper failed") from stepper.error
    t0 = time.perf_counter()
    for j, (p, n) in enumerate(wl["streams"]):
        cb_direct.submit(GenerationRequest(
            np.asarray(refs[f"s{j}"]["prompt"], np.int32), n,
            request_id=f"dir{j}"))
    cb_direct.run()
    direct_wall = time.perf_counter() - t0
    p1, p2, p3 = passes

    out = {
        "schema": SCHEMAS["gateway"],
        "device": device,
        "config": config,
        "workload": {k: {"prompt_len": len(refs[k]["prompt"]),
                         "new_tokens": news[k]} for k in sorted(refs)},
        "ref_tokens": {k: refs[k]["tokens"] for k in sorted(refs)},
        "passes": passes,
        "statuses_gated": p3["statuses"],
        "stream_emissions_gated": p3["stream_emissions"],
        "streams_token_exact": all(p["streams_token_exact"]
                                   for p in passes),
        "sse_order_matches_spans": all(p["sse_order_matches_spans"]
                                       for p in passes),
        "cancel_ok": all(p["cancel_ok"] for p in passes),
        "deadline_ok": all(p["deadline_ok"] for p in passes),
        "shed_ok": all(p["shed_ok"] for p in passes),
        "reject_ok": all(p["reject_ok"] for p in passes),
        "healthz_flips": bool(p2.get("healthz_flips")
                              and p3.get("healthz_flips")),
        "gauges_return_to_baseline": all(p["gauges_baseline"]
                                         for p in passes),
        "new_buckets_after_warmup": len(set(cb._seen_buckets) - warm),
        "deterministic_replay": (
            p3["statuses"] == p2["statuses"]
            and p3["stream_emissions"] == p2["stream_emissions"]),
        "control_plane": control,
        "overhead": {"gateway_pass3_wall_s": round(walls[2], 3),
                     "direct_engine_wall_s": round(direct_wall, 3)},
        "steps": int(cb._step_count),
    }
    print(f"gateway leg [{device}]: {len(wl['streams'])} concurrent "
          f"streams x3 passes token-exact={out['streams_token_exact']}, "
          f"sse-order={out['sse_order_matches_spans']}, statuses "
          f"{out['statuses_gated']}, new buckets after warmup "
          f"{out['new_buckets_after_warmup']}, gateway wall "
          f"{out['overhead']['gateway_pass3_wall_s']}s vs direct "
          f"{out['overhead']['direct_engine_wall_s']}s")
    return out


GATEWAY_KEYS = ("workload", "ref_tokens", "statuses_gated",
                "stream_emissions_gated")
GATEWAY_INVARIANTS = (
    "streams_token_exact", "sse_order_matches_spans", "cancel_ok",
    "deadline_ok", "shed_ok", "reject_ok", "healthz_flips",
    "gauges_return_to_baseline", "deterministic_replay",
)


# -- replica leg --------------------------------------------------------------

POLICY_ORDER = ("round_robin", "least_loaded", "prefix_affinity")


class Sub:
    """One request's event subscription: collects the fanout and flags
    the first token and the terminal for cross-thread waits."""

    def __init__(self):
        self.events = []
        self.first_token = threading.Event()
        self.done = threading.Event()
        self.end = None

    def __call__(self, ev):
        self.events.append(ev)
        if ev["type"] == "token":
            self.first_token.set()
        elif ev["type"] == "end":
            self.end = ev
            self.done.set()

    @property
    def tokens(self):
        return [t for e in self.events if e["type"] == "token"
                for t in e["tokens"]]

    def wait(self, what, timeout=300.0):
        if not self.done.wait(timeout):
            raise RuntimeError(f"timed out waiting for {what}")


def mk_request(prompt, n, rid):
    import numpy as np

    from paddle_tpu_torch.incubate.nn import GenerationRequest

    return GenerationRequest(np.asarray(prompt, np.int32), n,
                             request_id=rid)


def _build_pool(config, policy, device):
    """N fresh replicas (same seed, identical weights) behind one started
    EngineRouter."""
    import numpy as np

    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch.serving import EngineRouter, EngineStepper

    ecfg = config["engine"]
    steppers = []
    for slot in range(config["pool"]["replicas"]):
        eng, _ = tiny_engine(np.random.default_rng(ecfg["seed"]),
                             ecfg["max_seq_len"], device)
        cb = ContinuousBatchingEngine(
            eng, num_blocks=ecfg["num_blocks"],
            block_size=ecfg["block_size"], max_batch=ecfg["max_batch"],
            prefill_chunk=ecfg["prefill_chunk"],
            prefix_cache=ecfg["prefix_cache"])
        steppers.append(EngineStepper(cb, name=f"replica-{slot}"))
    return EngineRouter(steppers, policy=policy).start()


def run_wave(router, prompts, families, resumes, n, rid_of, order=None):
    """One wave over a families x resumes workload. Family heads land as
    ONE held batch (no terminal fires between their routing decisions);
    resumes go one at a time, each seeing the prefix summaries its
    predecessors published at terminal fanout; `order(r)` gives round
    r's family order (pool order by default). Returns {(m, r): Sub}."""
    subs = {}
    router.hold()
    futs = []
    for m in range(families):
        subs[(m, 0)] = Sub()
        futs.append(router.submit(mk_request(prompts[(m, 0)], n,
                                              rid_of(m, 0)),
                                  on_event=subs[(m, 0)]))
    router.release()
    for f in futs:
        f.result(60)
    for m in range(families):
        subs[(m, 0)].wait(f"head {rid_of(m, 0)}")
    for r in range(1, resumes):
        for m in (order(r) if order else range(families)):
            sub = subs[(m, r)] = Sub()
            router.submit(mk_request(prompts[(m, r)], n, rid_of(m, r)),
                          on_event=sub).result(60)
            sub.wait(f"resume {rid_of(m, r)}")
    return subs


def routes_of(tracer, keys, rid_of):
    """{f{m}r{r}: the replica its `route` span names} over `keys`."""
    out = {}
    for m, r in keys:
        rep = None
        for s in tracer.spans(request=rid_of(m, r)):
            if s["name"] == "route":
                rep = s["args"].get("replica")
        out[f"f{m}r{r}"] = rep
    return out


def _wave_exact(subs, refs):
    return all(sub.end is not None and sub.end["status"] == "finished"
               and sub.tokens == refs[key] for key, sub in subs.items())


def _policy_leg(config, policy, prompts, refs, tracer, device):
    """One policy, one fresh pool: wave 1 cold (the routing table and
    cache counters), and for affinity wave 2 (warm shapes),
    declare_warm, wave 3 as the 0-new-buckets replay."""
    wl = config["workload"]
    bs = config["engine"]["block_size"]
    fam, res, n = wl["families"], wl["resumes"], wl["max_new_tokens"]
    keys = [(m, r) for m in range(fam) for r in range(res)]
    router = _build_pool(config, policy, device)
    try:
        nrep = router.num_replicas

        def wave(w):
            return run_wave(router, prompts, fam, res, n,
                            lambda m, r: f"{policy}.{w}.f{m}r{r}")

        def on_each(fn):
            return [router.steppers[i].call(fn).result(60)
                    for i in range(nrep)]

        tracer.clear()
        exact = _wave_exact(wave("w1"), refs)
        routes = routes_of(tracer, keys,
                           lambda m, r: f"{policy}.w1.f{m}r{r}")
        stats = on_each(lambda c: dict(c.cache_stats))
        cached = sum(s["hit_blocks"] for s in stats) * bs
        leg = {"routes": routes, "cache_stats": stats,
               "cached_prefix_tokens": cached,
               "prefill_sweep_tokens": sum(len(p) for p in prompts.values())
               - cached}
        new_buckets = None
        if policy == "prefix_affinity":
            exact = exact and _wave_exact(wave("w2"), refs)
            warm = on_each(lambda c: (c.declare_warm(),
                                      set(c._seen_buckets))[1])
            exact = exact and _wave_exact(wave("w3"), refs)
            new_buckets = sum(
                len(b - w) for b, w in
                zip(on_each(lambda c: set(c._seen_buckets)), warm))
        leg["token_exact"] = exact
        leg["gauges_baseline"] = all(on_each(alloc_baseline))
        print(f"  {policy}: routes {routes}, cached "
              f"{leg['cached_prefix_tokens']} tok, sweeps "
              f"{leg['prefill_sweep_tokens']} tok, token-exact={exact}")
        return leg, new_buckets
    finally:
        router.stop()


def inject_step_fault(cb):
    """Swap the engine's step() for one that raises: the stepper fans
    `engine_error` terminals to every subscriber and stops."""
    def _boom():
        raise RuntimeError("injected replica fault")
    cb.step = _boom


def crash_scenario(router, prompts, news, tracer, prefix="crash"):
    """Replica 0 held: a streaming request (round robin -> replica 0) is
    stepped by hand to its first token, a bystander (-> replica 1) runs
    to its end, a victim (-> replica 0) queues; replica 0's step() then
    raises and it is released. Returns ({name: Sub}, steps to the first
    token, the victim's resubmit target, the post-crash route)."""
    s0 = router.steppers[0]
    s0.hold()
    subs = {k: Sub() for k in ("stream", "bystander", "victim", "post")}

    def submit(k):
        router.submit(mk_request(prompts[k], news[k], f"{prefix}.{k}"),
                      on_event=subs[k]).result(60)

    submit("stream")
    steps = 0
    while not subs["stream"].first_token.is_set():
        s0.call(lambda c: c.step()).result(60)
        steps += 1
        if steps > 20:
            raise RuntimeError("stream never produced a token")
    submit("bystander")
    subs["bystander"].wait("bystander")
    submit("victim")
    s0.call(inject_step_fault).result(60)
    s0.release()                    # the next step raises -> drain
    subs["stream"].wait("crashed stream terminal")
    subs["victim"].wait("resubmitted victim")
    submit("post")
    subs["post"].wait("post-crash submit")
    target = post = None
    for s in tracer.spans(request=f"{prefix}.victim"):
        if s["name"] == "resubmit":
            target = s["args"].get("replica")
    for s in tracer.spans(request=f"{prefix}.post"):
        if s["name"] == "route":
            post = s["args"].get("replica")
    return subs, steps, target, post


def _crash_leg(config, crefs, cprompts, tracer, device):
    ccfg = config["crash"]
    router = _build_pool(config, "round_robin", device)
    try:
        tracer.clear()
        news = {k: ccfg[k]["max_new_tokens"] for k in cprompts}
        subs, steps, target, post = crash_scenario(router, cprompts, news,
                                                   tracer)
        a, b, c, d = (subs[k] for k in ("stream", "bystander", "victim",
                                        "post"))
        leg = {
            "steps_to_first_token": steps,
            "streamed_prefix_len": len(a.tokens),
            "statuses": {k: (s.end["status"] if s.end else None)
                         for k, s in subs.items()},
            "stream_reason": a.end and a.end["reason"],
            "resubmit_target": target,
            "post_route": post,
            "live_after": router.live_replicas(),
        }
        inv = {
            "crash_stream_failed_structured": bool(
                a.end and a.end["status"] == "failed"
                and a.end["reason"] == "engine_error"
                and len(a.tokens) >= 1
                and a.tokens == crefs["stream"][:len(a.tokens)]),
            "crash_victim_resubmitted_exact": bool(
                c.end and c.end["status"] == "finished"
                and c.tokens == crefs["victim"] and target == 1),
            "crash_bystander_exact": bool(
                b.end and b.end["status"] == "finished"
                and b.tokens == crefs["bystander"]),
            "crash_post_routes_survivor": bool(
                d.end and d.end["status"] == "finished"
                and d.tokens == crefs["post"] and post == 1
                and router.live_replicas() == [1]),
            "pool_error_masked": bool(
                router.error is None
                and router.steppers[0].error is not None),
            "crash_survivor_gauges_baseline": bool(
                router.steppers[1].call(alloc_baseline).result(60)),
        }
        print(f"  crash: stream failed after {leg['streamed_prefix_len']} "
              f"token(s), victim resubmitted -> replica {target}, "
              f"post-crash route -> replica {post}, live "
              f"{leg['live_after']}")
        return leg, inv
    finally:
        router.stop()


def family_prompts(rng, vocab, families, resumes, prefix_len, resume_step,
                   tail):
    """{(m, r): prompt}: resume r of family m is the first prefix_len +
    r * resume_step + tail tokens of the family's sequence, so each
    resume extends the last."""
    full = prefix_len + (resumes - 1) * resume_step + tail
    seqs = [[int(t) for t in rng.integers(1, vocab, full)]
            for _ in range(families)]
    return {(m, r): seqs[m][:prefix_len + r * resume_step + tail]
            for m in range(families) for r in range(resumes)}


def replica_leg(config, device):
    import numpy as np

    from paddle_tpu_torch.observability import tracing

    ecfg = config["engine"]
    wl = config["workload"]
    eng_ref, V = tiny_engine(np.random.default_rng(ecfg["seed"]),
                             ecfg["max_seq_len"], device)
    wrng = np.random.default_rng(wl["seed"])
    prompts = family_prompts(wrng, V, wl["families"], wl["resumes"],
                             wl["prefix_len"], wl["resume_step"], wl["tail"])
    cprompts = {k: [int(t) for t in
                    wrng.integers(1, V, config["crash"][k]["prompt_len"])]
                for k in ("stream", "bystander", "victim", "post")}
    refs = {k: _ref(eng_ref, p, wl["max_new_tokens"])
            for k, p in prompts.items()}
    crefs = {k: _ref(eng_ref, p, config["crash"][k]["max_new_tokens"])
             for k, p in cprompts.items()}

    tracer = tracing.get_tracer()
    print(f"replica leg [{device}]: {config['pool']['replicas']} replicas, "
          f"{wl['families']} families x {wl['resumes']} resumes")
    routing, new_buckets = {}, None
    for policy in POLICY_ORDER:
        leg, buckets = _policy_leg(config, policy, prompts, refs, tracer,
                                   device)
        routing[policy] = leg
        if buckets is not None:
            new_buckets = buckets
    crash, crash_inv = _crash_leg(config, crefs, cprompts, tracer, device)

    aff, rr = routing["prefix_affinity"], routing["round_robin"]
    keys = [(m, r) for m in range(wl["families"])
            for r in range(wl["resumes"])]
    out = {
        "schema": SCHEMAS["replica"],
        "device": device,
        "config": config,
        "workload": {
            "prompt_lens": {f"f{m}r{r}": len(prompts[(m, r)])
                            for m, r in keys},
            "crash_prompt_lens": {k: len(p)
                                  for k, p in sorted(cprompts.items())},
            "max_new_tokens": wl["max_new_tokens"],
        },
        "ref_tokens": {f"f{m}r{r}": refs[(m, r)] for m, r in keys},
        "routing": routing,
        "crash": crash,
        "new_buckets_after_warmup": new_buckets,
        "token_exact_all_policies": all(
            routing[p]["token_exact"] for p in POLICY_ORDER),
        "affinity_beats_round_robin": bool(
            aff["cached_prefix_tokens"] > rr["cached_prefix_tokens"]
            and aff["prefill_sweep_tokens"] < rr["prefill_sweep_tokens"]),
        "gauges_return_to_baseline": all(
            routing[p]["gauges_baseline"] for p in POLICY_ORDER),
    }
    out.update(crash_inv)
    print(f"replica leg: affinity cached {aff['cached_prefix_tokens']} vs "
          f"round_robin {rr['cached_prefix_tokens']} tok, sweeps "
          f"{aff['prefill_sweep_tokens']} vs {rr['prefill_sweep_tokens']} "
          f"tok, new buckets after warmup {new_buckets}")
    return out


REPLICA_KEYS = ("workload", "ref_tokens", "routing", "crash")
REPLICA_INVARIANTS = (
    "token_exact_all_policies", "affinity_beats_round_robin",
    "crash_stream_failed_structured", "crash_victim_resubmitted_exact",
    "crash_bystander_exact", "crash_post_routes_survivor",
    "pool_error_masked", "crash_survivor_gauges_baseline",
    "gauges_return_to_baseline",
)


# -- chaos leg ----------------------------------------------------------------

class StepPressureMonitor:
    """Stand-in for the SLO monitor: reports a burn-rate breach while the
    engine's step count sits inside a configured window (the admission
    gate reads ``last_report['breaches']`` and calls ``tick()``)."""

    def __init__(self, windows):
        self.windows = [(int(a), int(b)) for a, b in windows]
        self.steps = 0

    @property
    def last_report(self):
        hot = any(a <= self.steps < b for a, b in self.windows)
        return {"breaches": 1 if hot else 0}

    def tick(self):
        self.steps += 1


def build_workload(cfg, vocab):
    """Config-seeded request set: every number a function of the seed."""
    import numpy as np

    rng = np.random.default_rng(cfg["seed"])
    n = cfg["requests"]
    lens = rng.integers(cfg["prompt_min"], cfg["prompt_max"] + 1, n)
    new = rng.integers(cfg["new_tokens_min"], cfg["new_tokens_max"] + 1, n)
    prompts = [rng.integers(1, vocab, int(p)).astype(np.int32)
               for p in lens]
    return {"prompts": prompts,
            "prompt_lens": [int(x) for x in lens],
            "new_tokens": [int(x) for x in new],
            "arrival_steps": list(cfg["arrival_steps"]),
            "priorities": list(cfg["priorities"]),
            "deadline_steps": {int(k): int(v) for k, v
                               in cfg.get("deadline_steps", {}).items()}}


def _build_injector(fcfg, tag):
    from paddle_tpu_torch.testing import FaultInjector

    inj = FaultInjector()
    inj.fail_alloc(calls=fcfg.get("alloc_fail_calls", ()),
                   steps=fcfg.get("alloc_fail_steps", ()))
    if fcfg.get("slow_steps"):
        inj.slow_step(fcfg["slow_steps"], fcfg.get("slow_delay_s", 0.005))
    for c in fcfg.get("cancel", ()):
        inj.cancel_request(f"{tag}{c['request']}", c["step"])
    if fcfg.get("dump_failures"):
        inj.fail_dump_writes(fcfg["dump_failures"])
    return inj


def _drive(cb, workload, tag, faults=None, max_ticks=3000):
    """Submit on the arrival schedule and step to completion, with the
    injector (if any) attached for the whole drive."""
    from paddle_tpu_torch.incubate.nn import GenerationRequest

    reqs = [GenerationRequest(
        p.copy(), n, request_id=f"{tag}{j}",
        priority=workload["priorities"][j],
        deadline_steps=workload["deadline_steps"].get(j))
        for j, (p, n) in enumerate(zip(workload["prompts"],
                                       workload["new_tokens"]))]
    arrivals = workload["arrival_steps"]
    i, tick = 0, 0
    step0 = cb._step_count
    ctx = faults.attach(cb) if faults is not None \
        else contextlib.nullcontext()
    with ctx:
        while i < len(reqs) or cb.queue or cb.num_active:
            while i < len(reqs) and arrivals[i] <= tick:
                cb.submit(reqs[i])
                i += 1
            cb.step()
            tick += 1
            if tick > max_ticks:
                raise RuntimeError(f"chaos: {tag} run did not converge "
                                   f"within {max_ticks} ticks")
    cb._retire()
    results = [cb.finished[r.request_id] for r in reqs]
    return {
        "results": results,
        "statuses": [r.status for r in results],
        "tokens": [list(r) for r in results],
        "preemptions": [r.preemptions for r in results],
        "steps": cb._step_count - step0,
        "injected": dict(faults.injected) if faults is not None else {},
        "gauges_baseline": alloc_baseline(cb),
    }


def chaos_leg(config, device, flight_dir=None):
    """truth run -> chaos pass 1 (cold) -> pass 2 (pool-warm) ->
    declare_warm -> pass 3 (the steady-state gate)."""
    import numpy as np

    from paddle_tpu_torch.incubate.nn import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import tracing

    ecfg = config["engine"]
    eng, V = tiny_engine(np.random.default_rng(ecfg["seed"]),
                         ecfg["max_seq_len"], device)
    workload = build_workload(config["workload"], V)
    fr = tracing.get_flight_recorder()
    fr.arm(flight_dir or tempfile.mkdtemp(prefix="torch_serve_chaos_"))

    def make_cb(num_blocks, pressure):
        return ContinuousBatchingEngine(
            eng, num_blocks=num_blocks, block_size=ecfg["block_size"],
            max_batch=ecfg["max_batch"],
            prefill_chunk=ecfg["prefill_chunk"], spec_k=ecfg["spec_k"],
            prefix_cache=ecfg["prefix_cache"],
            monitor=StepPressureMonitor(config["pressure_steps"])
            if pressure else None,
            shed_on_pressure=pressure,
            shed_priority_min=ecfg["shed_priority_min"])

    # ground truth: the same prompts in an ample pool, no faults, no
    # pressure, no deadlines
    truth = _drive(make_cb(config["truth_num_blocks"], pressure=False),
                   dict(workload, deadline_steps={}), "ct")
    if not all(s == "finished" for s in truth["statuses"]):
        raise RuntimeError("the reference run must complete undisturbed")

    cb = make_cb(ecfg["num_blocks"], pressure=True)
    passes = []
    for k, tag in enumerate(("c1", "c2", "c3")):
        if k == 2:
            warm = set(cb._seen_buckets)
            cb.declare_warm()
        passes.append(_drive(cb, workload, tag,
                             faults=_build_injector(config["faults"], tag)))
    p1, p2, p3 = passes

    def exact(pass_res):
        ok_full = ok_prefix = ok_resumed = True
        for j, res in enumerate(pass_res["results"]):
            ref = truth["tokens"][j]
            if res.status == "finished":
                if list(res) != ref:
                    ok_full = False
                    if res.preemptions:
                        ok_resumed = False
            elif res.status in ("cancelled", "deadline_exceeded",
                                "failed"):
                if list(res) != ref[:len(res)]:
                    ok_prefix = False
        return ok_full, ok_prefix, ok_resumed

    ex = [exact(p) for p in passes]
    every = [r for p in passes for r in p["results"]]
    resumed_finished = sum(1 for r in every
                           if r.status == "finished" and r.preemptions)
    status_counts, tokens_by_status = {}, {}
    for r in every:
        status_counts[r.status] = status_counts.get(r.status, 0) + 1
        tokens_by_status[r.status] = \
            tokens_by_status.get(r.status, 0) + len(r)
    out = {
        "schema": SCHEMAS["chaos"],
        "device": device,
        "config": config,
        "workload": {k: workload[k] for k in
                     ("prompt_lens", "new_tokens", "arrival_steps",
                      "priorities")},
        "truth_steps": truth["steps"],
        "truth_tokens": sum(len(t) for t in truth["tokens"]),
        "passes": [{
            "steps": p["steps"],
            "statuses": p["statuses"],
            "preemptions": p["preemptions"],
            "tokens_per_request": [len(t) for t in p["tokens"]],
            "injected": p["injected"],
            "gauges_baseline": p["gauges_baseline"],
        } for p in passes],
        "status_counts": status_counts,
        "tokens_by_status": tokens_by_status,
        "resumed_and_finished": resumed_finished,
        "survivors_token_exact": all(e[0] for e in ex),
        "partials_prefix_exact": all(e[1] for e in ex),
        "preempted_resumed_token_exact": all(e[2] for e in ex)
        and resumed_finished > 0,
        "gauges_return_to_baseline": all(p["gauges_baseline"]
                                         for p in passes),
        "new_buckets_after_warmup": len(set(cb._seen_buckets) - warm),
        "deterministic_replay": (p3["statuses"] == p2["statuses"]
                                 and p3["tokens"] == p2["tokens"]
                                 and p3["steps"] == p2["steps"]),
        "flight_dumps": len(fr.dumps),
    }
    print(f"chaos leg [{device}]: truth {out['truth_steps']} steps / "
          f"{out['truth_tokens']} tokens; statuses over 3 passes "
          f"{out['status_counts']}; resumed+finished "
          f"{out['resumed_and_finished']}; injected (last pass) "
          f"{p3['injected']}; new buckets after warmup "
          f"{out['new_buckets_after_warmup']}")
    return out


CHAOS_KEYS = ("workload", "truth_steps", "truth_tokens", "passes",
              "status_counts", "tokens_by_status", "resumed_and_finished")
CHAOS_INVARIANTS = ("survivors_token_exact", "partials_prefix_exact",
                    "preempted_resumed_token_exact",
                    "gauges_return_to_baseline", "deterministic_replay")


# -- tp -----------------------------------------------------------------------

class ThreadRanks:
    """A tensor-parallel group whose ranks are threads of this process
    (``testing.ThreadRankSet``: a ``HashStore`` and gloo, every operation
    bounded by `timeout`): ``engine`` is rank 0's engine, built by
    `build(rank, group)` on the caller's thread as every follower's is
    on its own; followers ``serve_follower()`` until ``close()``, which
    stops and joins them (within `timeout`) and returns their replay
    counts."""

    def __init__(self, tp, build, timeout=TP_TIMEOUT_S):
        from paddle_tpu_torch.testing import ThreadRankSet

        self.timeout = timeout
        self.ranks = ThreadRankSet(
            tp, lambda rank, g: build(rank, g).serve_follower(), timeout,
            ranks=range(1, tp))
        self.engine = build(0, self.ranks.group(0))

    def close(self):
        self.engine.stop_followers()
        return self.ranks.join(self.timeout)


TP_KEYS = ("shape", "tps", "workload", "token_exact", "steps", "spec",
           "prefix", "effective_tokens_per_step", "kv_high_water_blocks",
           "kv_device_high_water_bytes", "collective_bytes",
           "new_buckets_after_warmup")


def tp_leg(config, device, tps=(1, 2, 4, 8)):
    """tools/serve_bench.py's tp leg over the port: for each tp the same
    scheduler drives the kv-head-sharded engine (rank 0 of ThreadRanks)
    through plain / chunked / spec / prefix workloads. Reports the
    baseline's keys: token-exact vs tp=1 in every mode, steps, spec and
    prefix counters, per-rank KV high-water bytes (1/tp of tp=1), the
    collective payload of all_reduce over 'tp' (2 a layer over the
    [B, C, E] slab) and new buckets after warmup."""
    import numpy as np

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from paddle_tpu_torch.inference import FusedMultiTransformerEngine

    if device != "cpu":
        raise SystemExit("the tp leg runs on the CPU (its 8-dim heads are "
                         "below the card's attention kernel); "
                         "chip_smoke.py's phase 25 serves tp on the card")
    V, E, H, G, D, L, F = TP_DIMS
    rng = np.random.default_rng(0)
    weights = tiny_weights(rng, TP_DIMS)
    block_size = 8
    workload = [tuple(w) for w in config.get(
        "workload", [(5, 4), (11, 3), (3, 6), (8, 2)])]
    pattern = [7, 23, 41, 11]
    prefix_toks = rng.integers(1, V, 24).astype(np.int32)
    kw = dict(num_heads=H, head_dim=D, max_seq_len=64, dtype="float32",
              norm_type="rmsnorm", activation="swiglu", gqa_group_size=G,
              device="cpu")

    def drive(cb, reqs):
        for r in reqs:
            cb.submit(r)
        res = cb.run()
        return [list(res[r.request_id]) for r in reqs]

    def cb_of(engine, **k):
        return ContinuousBatchingEngine(engine, num_blocks=24,
                                        block_size=block_size, **k)

    def ragged(tag, seed):
        prng = np.random.default_rng(seed)
        return [GenerationRequest(prng.integers(1, V, p).astype(np.int32),
                                  n, request_id=f"{tag}{j}")
                for j, (p, n) in enumerate(workload)]

    def modes(engine, tp):
        runs = {}
        cb = cb_of(engine, max_batch=4)
        toks = drive(cb, ragged(f"tp{tp}_pl", 7))
        runs["plain"] = {"outputs": toks, "steps": cb._step_count,
                         "high_water_blocks": cb.allocator.high_water}
        cb = cb_of(engine, max_batch=4, prefill_chunk=4, token_budget=6)
        toks = drive(cb, ragged(f"tp{tp}_ch", 7))
        cb.declare_warm()
        warm = set(cb._seen_buckets)
        drive(cb, ragged(f"tp{tp}_cw", 5))
        runs["chunked"] = {"outputs": toks, "steps": cb._step_count,
                           "new_buckets_after_warmup":
                               len(set(cb._seen_buckets) - warm)}
        cb = cb_of(engine, max_batch=2, prefill_chunk=8, spec_k=4)
        reqs = [GenerationRequest(np.asarray(pattern * k, np.int32), 10,
                                  request_id=f"tp{tp}_sp{k}")
                for k in (6, 3)]
        toks = drive(cb, reqs)
        runs["spec"] = {"outputs": toks, "steps": cb._step_count,
                        "drafted": sum(r.spec_drafted for r in reqs),
                        "accepted": sum(r.spec_accepted for r in reqs)}
        cb = cb_of(engine, max_batch=4, prefill_chunk=8,
                   prefix_cache=True)
        prng = np.random.default_rng(3)
        toks = drive(cb, [GenerationRequest(
            np.concatenate([prefix_toks,
                            prng.integers(1, V, 3).astype(np.int32)]),
            4, request_id=f"tp{tp}_pf{j}") for j in range(4)])
        runs["prefix"] = {"outputs": toks, "steps": cb._step_count,
                          "cache_hits": cb.cache_stats["hit_blocks"],
                          "cow_copies": cb.cache_stats["cow_copies"]}
        return {"runs": runs,
                "tokens": sum(len(t) for t in runs["plain"]["outputs"]),
                "kv_device_high_water_bytes":
                    runs["plain"]["high_water_blocks"]
                    * engine.kv_device_block_bytes(block_size)}

    reg = obs.get_registry()

    def coll_bytes():
        fam = reg.get("collective_bytes_total")
        return sum(c.value for c in fam._children.values()) \
            if fam is not None else 0.0

    per_tp = {}
    for tp in tps:
        b0 = coll_bytes()
        if tp == 1:
            ranks = None
            engine = FusedMultiTransformerEngine(dict(weights), **kw)
        else:
            ranks = ThreadRanks(tp, lambda rank, g, tp=tp:
                                FusedMultiTransformerEngine(
                                    dict(weights), tp=tp, group=g, **kw))
            engine = ranks.engine
        try:
            r = modes(engine, tp)
        finally:
            if ranks is not None:
                replayed = ranks.close()
        if ranks is not None:
            steps = sum(m["steps"] for m in r["runs"].values())
            # the chunked run's warm replay steps on the same scheduler
            if any(s["steps"] < steps for s in replayed.values()):
                raise RuntimeError(f"tp={tp}: followers replayed "
                                   f"{replayed} of {steps} steps")
        r["collective_bytes"] = int(coll_bytes() - b0)
        per_tp[str(tp)] = r
        print(f"tp[{tp}]: plain {r['runs']['plain']['steps']} steps / "
              f"{r['tokens']} tokens, spec "
              f"{r['runs']['spec']['accepted']}/"
              f"{r['runs']['spec']['drafted']} accepted, per-device KV "
              f"high-water {r['kv_device_high_water_bytes']} B, "
              f"collective {r['collective_bytes']} B, "
              f"{r['runs']['chunked']['new_buckets_after_warmup']} new "
              "buckets after warmup", flush=True)

    base = per_tp[str(tps[0])]
    exact = {str(tp): all(per_tp[str(tp)]["runs"][m]["outputs"]
                          == base["runs"][m]["outputs"]
                          for m in ("plain", "chunked", "spec", "prefix"))
             for tp in tps[1:]}
    return {
        "shape": {"V": V, "E": E, "H": H, "KVH": G, "D": D, "L": L,
                  "block_size": block_size},
        "tps": list(tps),
        "workload": [list(w) for w in workload],
        "token_exact": exact,
        "steps": {m: base["runs"][m]["steps"]
                  for m in ("plain", "chunked", "spec", "prefix")},
        "spec": {"drafted": base["runs"]["spec"]["drafted"],
                 "accepted": base["runs"]["spec"]["accepted"]},
        "prefix": {"cache_hits": base["runs"]["prefix"]["cache_hits"],
                   "cow_copies": base["runs"]["prefix"]["cow_copies"]},
        "effective_tokens_per_step": round(
            base["tokens"] / base["runs"]["plain"]["steps"], 4),
        "kv_high_water_blocks": base["runs"]["plain"]["high_water_blocks"],
        "kv_device_high_water_bytes": {
            str(tp): per_tp[str(tp)]["kv_device_high_water_bytes"]
            for tp in tps},
        "collective_bytes": {str(tp): per_tp[str(tp)]["collective_bytes"]
                             for tp in tps},
        "new_buckets_after_warmup": {
            str(tp): per_tp[str(tp)]["runs"]["chunked"]
            ["new_buckets_after_warmup"] for tp in tps},
    }


def check_tp(base, device):
    """The tp gate: the baseline's keys at the baseline's tps, every mode
    token-exact against tp=1, per-rank KV high-water bytes exactly 1/tp
    of tp=1's and zero new buckets after warmup at every tp. Returns the
    list of failed keys."""
    tps = tuple(base["tps"])
    cur = tp_leg({"workload": base["workload"]}, device, tps)
    bad = [k for k in TP_KEYS if cur[k] != base[k]]
    for k in bad:
        print(f"MISMATCH {k}: current {cur[k]!r} != baseline {base[k]!r}")
    if not all(cur["token_exact"].values()):
        print("REGRESSION: tensor-parallel serving is not token-exact vs "
              f"tp=1: {cur['token_exact']}")
        bad.append("token_exact")
    hw = cur["kv_device_high_water_bytes"]
    for tp, v in hw.items():
        if v * int(tp) != hw["1"]:
            print(f"REGRESSION: per-device KV high-water at tp={tp} is "
                  f"{v}, not 1/{tp} of tp=1's {hw['1']}")
            bad.append("kv_device_high_water_bytes")
    if any(cur["new_buckets_after_warmup"].values()):
        print("REGRESSION: a tp compiled fresh buckets after warmup: "
              f"{cur['new_buckets_after_warmup']}")
        bad.append("new_buckets_after_warmup")
    print(f"tp leg {'OK' if not bad else 'FAILED'} [{device}]: tps "
          f"{list(tps)}, token-exact {cur['token_exact']}, per-device KV "
          f"high-water {hw}, collective {cur['collective_bytes']} B")
    return bad


# -- the serving autotuner ----------------------------------------------------

AUTOTUNE_WORKLOAD = [(5, 3), (11, 4), (3, 5), (8, 2)]
# the baseline's knobs that the port has; JAX's buffer_depth (the Pallas
# DMA depth) has no counterpart, and the port reports split_waves instead
AUTOTUNE_KNOBS = ("pack", "prefill_chunk")
AUTOTUNE_KEYS = ("shape_class", "winner", "buckets", "deterministic",
                 "workload", "tokens", "steps_default", "steps_tuned",
                 "token_exact_tuned_vs_default", "default_config",
                 "tuned_config", "new_buckets_after_warmup_tuned")
# the bucket fields both caches carry with the same meaning
AUTOTUNE_BUCKET_FIELDS = AUTOTUNE_KNOBS + ("intensity", "measured",
                                          "suspect", "trials")


def _autotune_sweep(at, dims):
    """tools/serve_bench.py's committed sweep, model-ranked: the tiny
    engine's shape class (kvh=2, g=2, block=8, its head dim, f32) over its
    two occupancy buckets, the decode bucket at the workload's post-prefill
    lengths and the chunk-8 prefill bucket."""
    _, _, H, G, D, _, _ = dims
    lens = [p + n for p, n in AUTOTUNE_WORKLOAD]
    cache = None
    for chunk in (None, 8):
        cache = at.sweep_ragged_serve(G, H // G, D, 8, lens, chunk=chunk,
                                      measure=False, cache=cache)
    return cache


def autotune_leg(config, device):
    """The serving autotuner end to end (tools/serve_bench.py's
    ``autotune_leg``): sweep (pack, prefill_chunk, split_waves) per
    occupancy bucket by the analytic model, twice (the same winners), and
    drive the same continuous-batching workload untuned and tuned from
    the cache: tokens equal, zero new step buckets after warm-up, and the
    cache counters moved by construction alone."""
    import numpy as np

    from paddle_tpu_torch.incubate.nn import (ContinuousBatchingEngine,
                                              GenerationRequest)
    from paddle_tpu_torch.observability import instrument
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.ops.paged_attention import SPLIT_WAVES

    dims = TINY_DIMS if device == "cpu" else CARD_DIMS
    V, _, H, G, D, _, _ = dims
    workload = [tuple(t) for t in config.get("workload", AUTOTUNE_WORKLOAD)]
    cache = _autotune_sweep(at, dims)
    deterministic = _autotune_sweep(at, dims) == cache
    shape_cls = at.serve_shape_class(G, H // G, 8, D, "float32")

    def counters():
        return (instrument.autotune_cache_hits().value,
                instrument.autotune_cache_misses().value)

    def drive(tune):
        rng = np.random.default_rng(0)
        c0 = counters()
        eng, _ = tiny_engine(rng, 64, device, autotune_cache=tune)
        cb = ContinuousBatchingEngine(eng, num_blocks=24, block_size=8,
                                      max_batch=4, autotune_cache=tune)
        built = counters()

        def submit():
            prng = np.random.default_rng(7)
            reqs = [GenerationRequest(
                prng.integers(1, V, p).astype(np.int32), n)
                for p, n in workload]
            for r in reqs:
                cb.submit(r)
            return reqs
        reqs = submit()
        out = cb.run()
        toks = [list(map(int, out[r.request_id])) for r in reqs]
        steps = cb._step_count
        warm = set(cb._seen_buckets)
        submit()                     # the same workload again: warm replay
        cb.run()
        return {
            "tokens": toks, "steps": steps,
            "new_buckets": len(set(cb._seen_buckets) - warm),
            "config": {"pack": cb._pack, "prefill_chunk": cb.prefill_chunk,
                       "split_waves": eng.split_waves or SPLIT_WAVES},
            "lookups_at_construction": [b - a for a, b in zip(c0, built)],
            "lookups_while_serving": [b - a for a, b in
                                      zip(built, counters())],
        }

    default = drive(None)
    tuned = drive(cache)
    ntok = sum(n for _, n in workload)
    sec = cache["shapes"][shape_cls]
    out = {
        "interpret": False,
        "shape_class": shape_cls,
        "winner": dict(sec["winner"]),
        "buckets": {k: {p: b[p] for p in AUTOTUNE_KNOBS + ("split_waves",)}
                    for k, b in sec["buckets"].items()},
        "deterministic": deterministic,
        "workload": [list(t) for t in workload],
        "tokens": ntok,
        "steps_default": default["steps"],
        "steps_tuned": tuned["steps"],
        "steps_per_token_default": round(default["steps"] / ntok, 4),
        "steps_per_token_tuned": round(tuned["steps"] / ntok, 4),
        "token_exact_tuned_vs_default": tuned["tokens"] == default["tokens"],
        "default_config": default["config"],
        "tuned_config": tuned["config"],
        "new_buckets_after_warmup_tuned": tuned["new_buckets"],
        "cache_lookups": {"default": default["lookups_at_construction"],
                          "tuned": tuned["lookups_at_construction"],
                          "while_serving": [default["lookups_while_serving"],
                                            tuned["lookups_while_serving"]]},
        "cache": cache,
    }
    print(f"autotune[{shape_cls}]: winner {out['winner']}, "
          f"{out['steps_tuned']} tuned vs {out['steps_default']} default "
          f"steps for {ntok} tokens; {out['new_buckets_after_warmup_tuned']} "
          f"new buckets after warmup; deterministic={deterministic}; cache "
          f"hits/misses at construction {out['cache_lookups']}")
    return out


def _knobs_of(d):
    return {k: d[k] for k in AUTOTUNE_KNOBS}


def check_autotune(base, device):
    """The autotune gate (tools/serve_bench.py's ``check_autotune``): on
    the CPU every key of the baseline's ``gate.autotune`` over
    AUTOTUNE_KEYS, the winner / bucket / config dicts on the knobs the port
    has (AUTOTUNE_KNOBS; ``split_waves`` is printed in ``buffer_depth``'s
    place), and the sweep's buckets against the committed ``shapes``
    section on AUTOTUNE_BUCKET_FIELDS; on both devices tokens exact,
    deterministic winners, zero new buckets after warm-up and cache
    lookups at construction only. Returns the list of failed keys."""
    gate = base["gate"]["autotune"]
    cur = autotune_leg({"workload": gate["workload"]}, device)
    bad = []
    if device == "cpu":
        want = dict(gate)
        for k in ("winner", "default_config", "tuned_config"):
            want[k] = _knobs_of(gate[k])
        want["buckets"] = {b: _knobs_of(v) for b, v in gate["buckets"].items()}
        got = dict(cur)
        for k in ("winner", "default_config", "tuned_config"):
            got[k] = _knobs_of(cur[k])
        got["buckets"] = {b: _knobs_of(v) for b, v in cur["buckets"].items()}
        for k in AUTOTUNE_KEYS:
            if got[k] != want.get(k):
                print(f"MISMATCH {k}: current {got[k]!r} != baseline "
                      f"{want.get(k)!r}")
                bad.append(k)
        base_sec = base["shapes"].get(cur["shape_class"], {})
        cur_sec = cur["cache"]["shapes"][cur["shape_class"]]
        rows = {b: {f: v[f] for f in AUTOTUNE_BUCKET_FIELDS}
                for b, v in cur_sec["buckets"].items()}
        base_rows = {b: {f: v.get(f) for f in AUTOTUNE_BUCKET_FIELDS}
                     for b, v in base_sec.get("buckets", {}).items()}
        if rows != base_rows:
            print(f"MISMATCH shapes: current buckets {rows!r} != baseline "
                  f"{base_rows!r}")
            bad.append("shapes")
    for k in ("deterministic", "token_exact_tuned_vs_default"):
        if cur[k] is not True:
            print(f"REGRESSION: {k} is {cur[k]!r}")
            bad.append(k)
    if cur["new_buckets_after_warmup_tuned"] != 0:
        print("REGRESSION: the tuned engine compiled "
              f"{cur['new_buckets_after_warmup_tuned']} new buckets after "
              "warm-up")
        bad.append("new_buckets_after_warmup_tuned")
    looks = cur["cache_lookups"]
    if looks["while_serving"] != [[0, 0], [0, 0]] or looks["tuned"][0] < 2:
        print(f"REGRESSION: cache lookups {looks}: want two hits at the "
              "tuned construction and none while serving")
        bad.append("cache_lookups")
    print(f"autotune leg {'OK' if not bad else 'FAILED'} [{device}]: winner "
          f"pack {cur['winner']['pack']} prefill_chunk "
          f"{cur['winner']['prefill_chunk']}, split_waves (in buffer_depth's "
          f"place) {cur['winner']['split_waves']}; tuned config "
          f"{cur['tuned_config']}")
    return bad


# -- checking -----------------------------------------------------------------

LEGS = {"gateway": (gateway_leg, GATEWAY_KEYS, GATEWAY_INVARIANTS),
        "replica": (replica_leg, REPLICA_KEYS, REPLICA_INVARIANTS),
        "chaos": (chaos_leg, CHAOS_KEYS, CHAOS_INVARIANTS)}


def check(name, base, device):
    """Run leg `name` with the baseline's config and hold it to the
    baseline: every invariant, zero new buckets after warmup, the
    control plane (gateway), and, on the CPU, every host-deterministic
    key. Returns the list of failed keys."""
    _, keys, invariants = LEGS[name]
    cur = LEGS[name][0](base["config"], device)
    bad = []
    if device == "cpu":
        bad = [k for k in keys if cur[k] != base.get(k)]
        for k in bad:
            print(f"MISMATCH {k}: current {cur[k]!r} != baseline "
                  f"{base.get(k)!r}")
    else:
        print(f"{name}: the baseline's tokens and schedule are the JAX "
              "engine's f32 CPU run and are not compared on the GPU")
    for k in invariants:
        if cur[k] is not True:
            print(f"REGRESSION: {k} is {cur[k]!r}")
            bad.append(k)
    if cur["new_buckets_after_warmup"] != 0:
        print(f"REGRESSION: {cur['new_buckets_after_warmup']} new step "
              "buckets after warmup")
        bad.append("new_buckets_after_warmup")
    for k, ok in cur.get("control_plane", {}).items():
        if ok is not True and not k.endswith(("_missing", "_error")):
            print(f"REGRESSION: control plane {k} failed "
                  f"({cur['control_plane']})")
            bad.append(k)
    print(f"{name} leg {'OK' if not bad else 'FAILED'} [{device}]")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serving gates of the PyTorch port: gateway, replica "
                    "router, chaos, tensor parallel, autotune")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--check", metavar="BASELINE_JSON", action="append",
                    default=None,
                    help="gate against a committed baseline "
                         "(tools/serve_{gateway,replica,chaos,tp,autotune}"
                         ".json); "
                         "may repeat")
    ap.add_argument("--json", default=None,
                    help="write the legs' full reports here")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.core.device import resolve_device
    device = resolve_device(args.device).type

    if args.check:
        failed = []
        for path in args.check:
            with open(path) as f:
                base = json.load(f)
            names = [n for n in list(LEGS) + ["tp"] if n in base]
            if "autotune" in base.get("gate", {}):
                names.append("autotune")
            if len(names) != 1:
                print(f"{path}: want one of "
                      f"{sorted(LEGS) + ['tp', 'gate.autotune']} sections")
                return 1
            if names[0] == "autotune":
                failed += check_autotune(base, device)
            elif names[0] == "tp":
                failed += check_tp(base["tp"], device)
            else:
                failed += check(names[0], base[names[0]], device)
        return 1 if failed else 0

    out = {}
    for name, path in BASELINES.items():
        with open(os.path.join(REPO, path)) as f:
            base = json.load(f)
        base = base["gate"][name] if name == "autotune" else base[name]
        if name == "autotune":
            out[name] = autotune_leg(base, device)
            continue
        if name == "tp":
            if device == "cpu":
                out[name] = tp_leg(base, device, tuple(base["tps"]))
            else:
                print("tp leg: CPU only (phase 25 of chip_smoke.py serves "
                      "tp on the card)")
            continue
        out[name] = LEGS[name][0](base["config"], device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
