"""Async HTTP/SSE serving gateway + live observability control plane.

The PyTorch port's copy of ``paddle_tpu/serving/gateway.py``, in front of
the port's ``ContinuousBatchingEngine``: the same routes, schemas, status
codes and SSE bytes.

The production front door: an
external client can stream tokens, cancel requests, scrape metrics,
and pull SLO reports and flight-recorder evidence over the wire —
every telemetry layer PRs 3-11 built in-process becomes reachable
from outside it.

Data plane (the engine side runs on the EngineStepper thread; every
handler below is an asyncio coroutine in the main loop):

* ``POST /v1/generate`` — JSON body (prompt ids, max_new_tokens, and
  the resilience knobs: priority / deadline_steps / deadline_s /
  spec_k / temperature). Validation failures answer 400; config
  combos the engine cannot honor flow through the engine's structured-
  rejection path and answer 422 with the engine's fixed reason label.
  ``"stream": true`` (the default) streams per-token SSE frames
  (``accepted`` -> ``token``* -> ``end``; see sse.py) fed by the
  engine's ``on_token`` emission hook; ``"stream": false`` waits for
  the terminal record and answers one JSON body with the status-
  mapped HTTP code (finished 200, deadline 504, shed 503, failed 500).
* ``DELETE /v1/requests/{id}`` — ``engine.cancel()``: queued requests
  leave immediately, active ones retire at the next step with their
  KV reclaimed mid-stream; the open SSE stream gets its typed ``end``
  event (status ``cancelled``).

Control plane:

* ``GET /metrics`` — Prometheus text exposition (``to_prometheus``).
* ``GET /slo`` — the SLO engine's burn-rate report (JSON-safe).
* ``GET /requests`` / ``/requests/{id}`` — ``engine.explain()``-style
  digests from the span ring.
* ``GET /dumps`` / ``/dumps/{name}`` — flight-recorder retention
  manifest + dump download from the armed directory.
* ``GET /healthz`` — 200 while healthy, 503 + a fixed reason label
  (``slo_burn`` / ``hbm_pressure`` / ``engine_error``) when the SLO
  monitor is burning budget, the memory watch reports HBM pressure,
  or the stepper died.

stdlib only (asyncio + json; the HTTP/1.1 framing is hand-rolled,
one request per connection, ``Connection: close``). Importable in a
bare container — torch/numpy are touched lazily at request time — so
a monitoring sidecar can validate the schemas and the gateway metric
families without a working accelerator stack.

Gateway telemetry (all label values from small FIXED literal sets —
so the label sets stay bounded): per-route request/stream duration histograms,
per-(route, code) response counters, live-connection / live-stream /
SSE-backpressure gauges, per-type SSE event counters, and /healthz
state-transition counters.
"""
import asyncio
import json
import os
import time

from ..observability import instrument as _metrics
from ..observability import tracing as _tracing
from ..observability.exporters import to_prometheus
from ..observability.slo import json_safe
from . import sse
from .stepper import EngineStepper

__all__ = [
    "ServingGateway", "EngineStepper", "validate_generate_body",
    "validate_healthz", "HEALTHZ_SCHEMA", "REQUESTS_SCHEMA",
    "DUMPS_SCHEMA", "STATUS_HTTP", "run_gateway",
]

HEALTHZ_SCHEMA = "paddle_tpu.gateway_healthz/1"
REQUESTS_SCHEMA = "paddle_tpu.gateway_requests/1"
DUMPS_SCHEMA = "paddle_tpu.gateway_dumps/1"

# terminal RequestResult.status -> HTTP code for non-streaming
# responses (an SSE stream is already 200 by the time the terminal
# lands; there the typed `end` event carries the status)
STATUS_HTTP = {
    "finished": 200,
    "cancelled": 200,
    "deadline_exceeded": 504,
    "shed": 503,
    "failed": 500,
    "rejected": 422,
}

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
    422: "Unprocessable Entity", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

_MAX_BODY = 8 * 1024 * 1024
_MAX_HEADER_LINES = 100
# HTTP/1.1 keep-alive bounds: an idle reused socket is reaped after
# this many seconds, and one socket serves at most this many requests
# before the gateway closes it (a rotation backstop against a client
# pinning one connection forever)
_KEEPALIVE_IDLE_S = 75.0
_MAX_KEEPALIVE_REQUESTS = 1000


def _read_file(path):
    """Blocking dump-file read, offloaded via run_in_executor — the
    event loop never waits on a disk."""
    with open(path, "rb") as f:
        return f.read()


# strong references to in-flight aborted-stream drain tasks (the
# done-callback drops the reference when the drain
# completes, so the set stays empty at quiescence)
_drain_tasks = set()

_GENERATE_FIELDS = {
    "prompt", "max_new_tokens", "request_id", "priority",
    "deadline_steps", "deadline_s", "spec_k", "temperature", "stream",
}


def _is_int(v):
    return isinstance(v, int) and not isinstance(v, bool)


def validate_generate_body(data):
    """Screen a /v1/generate JSON body into a clean spec dict.
    Returns ``(spec, None)`` or ``(None, reason_string)`` — pure
    stdlib, no engine touched, so the selfcheck can pin the contract
    in a bare container. Engine-level config combos (spec-on-sampling,
    spec_k wider than the engine) are NOT judged here: those flow to
    submit()'s structured-rejection path, which owns the fixed reason
    labels."""
    if not isinstance(data, dict):
        return None, "body must be a JSON object"
    unknown = set(data) - _GENERATE_FIELDS
    if unknown:
        return None, f"unknown fields: {sorted(unknown)}"
    prompt = data.get("prompt")
    if not isinstance(prompt, list) or not prompt \
            or not all(_is_int(t) and t >= 0 for t in prompt):
        return None, "prompt must be a non-empty list of token ids"
    mnt = data.get("max_new_tokens")
    if not _is_int(mnt) or mnt < 1:
        return None, "max_new_tokens must be an int >= 1"
    spec = {"prompt": prompt, "max_new_tokens": mnt}
    rid = data.get("request_id")
    if rid is not None and not (isinstance(rid, str) or _is_int(rid)):
        return None, "request_id must be a string or int"
    spec["request_id"] = rid
    pr = data.get("priority", 0)
    if not _is_int(pr) or pr < 0:
        return None, "priority must be an int >= 0"
    spec["priority"] = pr
    ds = data.get("deadline_steps")
    if ds is not None and (not _is_int(ds) or ds < 1):
        return None, "deadline_steps must be an int >= 1"
    spec["deadline_steps"] = ds
    dsec = data.get("deadline_s")
    if dsec is not None and (isinstance(dsec, bool)
                             or not isinstance(dsec, (int, float))
                             or dsec <= 0):
        return None, "deadline_s must be a number > 0"
    spec["deadline_s"] = dsec
    sk = data.get("spec_k")
    if sk is not None and (not _is_int(sk) or sk < 0):
        return None, "spec_k must be an int >= 0"
    spec["spec_k"] = sk
    temp = data.get("temperature")
    if temp is not None and (isinstance(temp, bool)
                             or not isinstance(temp, (int, float))
                             or temp < 0):
        return None, "temperature must be a number >= 0"
    spec["temperature"] = temp
    stream = data.get("stream", True)
    if not isinstance(stream, bool):
        return None, "stream must be a boolean"
    spec["stream"] = stream
    return spec, None


def validate_healthz(payload):
    """Schema-check a /healthz payload (stdlib-only, same contract as
    tracing.load_dump). Raises ValueError; returns the payload."""
    if not isinstance(payload, dict) \
            or payload.get("schema") != HEALTHZ_SCHEMA:
        raise ValueError(
            f"not a {HEALTHZ_SCHEMA} payload (schema="
            f"{payload.get('schema') if isinstance(payload, dict) else None!r})")
    missing = {"status", "reason", "inflight", "queue_depth",
               "steps", "finished"} - set(payload)
    if missing:
        raise ValueError(f"healthz payload missing {sorted(missing)}")
    if payload["status"] not in ("ok", "degraded"):
        raise ValueError(f"healthz status {payload['status']!r} not in "
                         "('ok', 'degraded')")
    if payload["status"] == "degraded" and not payload["reason"]:
        raise ValueError("degraded healthz must carry a reason")
    for k in ("inflight", "queue_depth", "steps", "finished"):
        if not _is_int(payload[k]) or payload[k] < 0:
            raise ValueError(f"healthz {k} must be a non-negative int")
    mesh = payload.get("mesh")
    if mesh is not None:
        # mesh-aware health (tensor-parallel serving): tp width + one
        # row PER DEVICE — a load balancer sizing by KV headroom must
        # see every device's shard, not a silently-device-0 figure
        if not _is_int(mesh.get("tp")) or mesh["tp"] < 1:
            raise ValueError("healthz mesh.tp must be a positive int")
        devs = mesh.get("devices")
        if not isinstance(devs, list) or len(devs) != mesh["tp"]:
            raise ValueError(
                "healthz mesh.devices must list exactly tp entries")
        for row in devs:
            for k in ("device", "kv_bytes_used", "kv_bytes_high_water"):
                if not _is_int(row.get(k)) or row[k] < 0:
                    raise ValueError(
                        f"healthz mesh device row needs non-negative "
                        f"int {k}")
    return payload


class ServingGateway:
    """One asyncio HTTP server over one EngineStepper — or over an
    EngineRouter fronting N of them (the router presents the same
    submit/cancel/call/error surface, so the pool is invisible here).

    ``monitor`` / ``memory_watch`` are the SAME objects the engine was
    constructed with (the gateway only reads their ``last_report`` for
    /healthz and routes /slo's ``report()`` through the stepper) —
    passing different ones would make the front door report a health
    the scheduler never saw.
    """

    def __init__(self, stepper, monitor=None, memory_watch=None,
                 host="127.0.0.1", port=0):
        self.stepper = stepper
        self.engine = stepper.engine
        self.monitor = monitor
        self.memory_watch = memory_watch
        self.host = host
        self.port = port
        self._server = None
        self._id_counter = 0
        self._last_health = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self):
        await self._server.serve_forever()

    # -- health ------------------------------------------------------------
    def health(self):
        """(status, reason): the /healthz verdict. Degrades on the SLO
        monitor's last burn-rate breach, the memory watch's HBM
        pressure, or a dead stepper — the same signals the engine's
        pressure-aware admission reads, surfaced to the load
        balancer."""
        if self.stepper.error is not None:
            return "degraded", "engine_error"
        rep = getattr(self.monitor, "last_report", None) \
            if self.monitor is not None else None
        if rep and rep.get("breaches", 0) > 0:
            return "degraded", "slo_burn"
        mrep = getattr(self.memory_watch, "last_report", None) \
            if self.memory_watch is not None else None
        if mrep and mrep.get("pressure"):
            return "degraded", "hbm_pressure"
        return "ok", None

    # -- HTTP plumbing -----------------------------------------------------
    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) < 2:
            return None
        method, target = parts[0].upper(), parts[1]
        headers = {}
        for _ in range(_MAX_HEADER_LINES):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            n = 0
        if n > _MAX_BODY:
            raise ValueError(f"body too large ({n} bytes)")
        body = await reader.readexactly(n) if n else b""
        return method, target, headers, body

    def _write_head(self, writer, status, ctype, length=None, extra=()):
        # the per-connection keep-alive verdict is pinned on the writer
        # by _handle (HTTP/1.1 default) and cleared by the SSE path —
        # a stream's framing is "read until close", so it must not
        # invite a second request on the same socket
        keep = getattr(writer, "_pt_keep_alive", False)
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                 f"Content-Type: {ctype}",
                 "Cache-Control: no-store",
                 "Connection: keep-alive" if keep else "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        lines.extend(f"{k}: {v}" for k, v in extra)
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def _respond(self, writer, route, status, payload,
                       ctype="application/json"):
        if isinstance(payload, (dict, list)):
            body = (json.dumps(json_safe(payload), sort_keys=True)
                    + "\n").encode("utf-8")
        elif isinstance(payload, str):
            body = payload.encode("utf-8")
        else:
            body = payload
        self._write_head(writer, status, ctype, length=len(body))
        writer.write(body)
        await writer.drain()
        _metrics.gateway_responses().labels(
            route=route, code=str(status)).inc()

    # -- routing -----------------------------------------------------------
    def _route(self, method, path):
        """(route_label, handler, path_arg) — route labels are a fixed
        literal set (they feed the metric labels)."""
        if path == "/v1/generate":
            if method == "POST":
                return "generate", self._h_generate, None
            return "generate", self._h_method_not_allowed, None
        if path.startswith("/v1/requests/"):
            arg = path[len("/v1/requests/"):]
            if method == "DELETE":
                return "cancel", self._h_cancel, arg
            return "cancel", self._h_method_not_allowed, None
        if path == "/metrics" and method == "GET":
            return "metrics", self._h_metrics, None
        if path == "/slo" and method == "GET":
            return "slo", self._h_slo, None
        if path == "/requests" and method == "GET":
            return "requests", self._h_requests, None
        if path.startswith("/requests/") and method == "GET":
            return "request_detail", self._h_request_detail, \
                path[len("/requests/"):]
        if path == "/dumps" and method == "GET":
            return "dumps", self._h_dumps, None
        if path.startswith("/dumps/") and method == "GET":
            return "dump_file", self._h_dump_file, \
                path[len("/dumps/"):]
        if path == "/healthz" and method == "GET":
            return "healthz", self._h_healthz, None
        return "unknown", self._h_not_found, None

    async def _handle(self, reader, writer):
        """Per-connection loop: HTTP/1.1 keep-alive by default, so a
        load generator or router-fronted client reuses one socket
        instead of paying a TCP handshake per request. `Connection:
        close` (or an SSE stream, whose framing is read-until-close)
        ends the loop after the response; an idle reused socket is
        reaped after _KEEPALIVE_IDLE_S."""
        conns = _metrics.gateway_live_connections()
        conns.inc()
        route = "unknown"
        try:
            for served in range(_MAX_KEEPALIVE_REQUESTS):
                route = "unknown"
                t0 = time.perf_counter()
                try:
                    if served == 0:
                        parsed = await self._read_request(reader)
                    else:
                        parsed = await asyncio.wait_for(
                            self._read_request(reader),
                            _KEEPALIVE_IDLE_S)
                except asyncio.TimeoutError:
                    return              # idle keep-alive socket reaped
                except ValueError as e:
                    # client-side limit violation, not a server bug
                    await self._respond(
                        writer, route, 413,
                        {"error": "payload_too_large",
                         "reason": str(e)})
                    return
                if parsed is None:
                    return
                method, target, headers, body = parsed
                # HTTP/1.1: persistent unless the client opts out
                keep = (headers.get("connection", "").lower()
                        != "close"
                        and served + 1 < _MAX_KEEPALIVE_REQUESTS)
                writer._pt_keep_alive = keep
                path = target.split("?", 1)[0]
                route, handler, arg = self._route(method, path)
                try:
                    await handler(writer, route, headers, body, arg)
                finally:
                    _metrics.gateway_request_seconds().labels(
                        route=route).observe(time.perf_counter() - t0)
                # a handler may have withdrawn keep-alive (SSE)
                if not getattr(writer, "_pt_keep_alive", False):
                    return
        except Exception as e:
            # a handler bug answers 500 with a structured reason,
            # never a silently dropped connection (and never a dead
            # accept loop — asyncio isolates us per-connection)
            writer._pt_keep_alive = False
            try:
                await self._respond(
                    writer, route, 500,
                    {"error": "internal_error", "reason": str(e)})
            except OSError:
                pass        # client already gone
        finally:
            conns.dec()
            try:
                writer.close()
                await writer.wait_closed()
            except OSError:
                pass

    # -- handlers ----------------------------------------------------------
    async def _h_not_found(self, writer, route, headers, body, arg):
        await self._respond(writer, route, 404, {"error": "not_found"})

    async def _h_method_not_allowed(self, writer, route, headers, body,
                                    arg):
        await self._respond(writer, route, 405,
                            {"error": "method_not_allowed"})

    def _next_id(self):
        self._id_counter += 1
        return f"g{self._id_counter}"

    def _build_request(self, spec, rid):
        import numpy as np

        from ..incubate.nn import GenerationRequest
        return GenerationRequest(
            np.asarray(spec["prompt"], dtype=np.int32),
            spec["max_new_tokens"], request_id=rid,
            priority=spec["priority"],
            deadline_steps=spec["deadline_steps"],
            deadline_s=spec["deadline_s"], spec_k=spec["spec_k"],
            temperature=spec["temperature"])

    async def _h_generate(self, writer, route, headers, body, arg):
        try:
            data = json.loads(body or b"")
        except ValueError:
            return await self._respond(
                writer, route, 400,
                {"error": "bad_request", "reason": "invalid JSON body"})
        spec, err = validate_generate_body(data)
        if err is not None:
            return await self._respond(
                writer, route, 400, {"error": "bad_request",
                                     "reason": err})
        rid = spec["request_id"]
        if rid is None:
            rid = self._next_id()
        try:
            req = self._build_request(spec, rid)
        except ValueError as e:
            return await self._respond(
                writer, route, 400, {"error": "bad_request",
                                     "reason": str(e)})
        loop = asyncio.get_running_loop()
        q = asyncio.Queue()
        pending = _metrics.gateway_sse_pending_events()

        def bridge(ev):
            # stepper thread -> asyncio loop; the registry is lock-
            # protected, so the backpressure gauge moves from here
            pending.inc()
            try:
                loop.call_soon_threadsafe(q.put_nowait, ev)
            except RuntimeError:
                pending.dec()   # loop shut down mid-stream

        try:
            status = await asyncio.wrap_future(
                self.stepper.submit(req, on_event=bridge))
        except ValueError as e:
            return await self._respond(
                writer, route, 409, {"error": "conflict",
                                     "reason": str(e)})

        async def next_event():
            ev = await q.get()
            pending.dec()
            return ev

        if status == "rejected":
            ev = await next_event()     # the structured `end` record
            return await self._respond(
                writer, route, STATUS_HTTP["rejected"],
                {"request": rid, "status": "rejected",
                 "reason": ev.get("reason"), "tokens": []})
        if not spec["stream"]:
            while True:
                ev = await next_event()
                if ev["type"] == "end":
                    break
            return await self._respond(
                writer, route, STATUS_HTTP.get(ev["status"], 200),
                {"request": rid, "status": ev["status"],
                 "reason": ev.get("reason"), "tokens": ev["tokens"],
                 "preemptions": ev.get("preemptions", 0)})
        # SSE stream: read-until-close framing — withdraw keep-alive
        # before the head goes out
        writer._pt_keep_alive = False
        self._write_head(writer, 200, "text/event-stream")
        _metrics.gateway_responses().labels(route=route,
                                            code="200").inc()
        streams = _metrics.gateway_live_streams()
        streams.inc()
        t0 = time.perf_counter()
        try:
            await self._pump_stream(writer, next_event, rid)
        finally:
            streams.dec()
            _metrics.gateway_stream_seconds().observe(
                time.perf_counter() - t0)

    async def _pump_stream(self, writer, next_event, rid):
        """Relay fanout events to one SSE client, `accepted` frame
        through the terminal `end`. The broad handler below is the
        swallowed-cancellation discipline done right: a stream
        failure — client gone (even before the first frame), encode
        bug, anything — CANCELS the engine-side request, so its KV is
        reclaimed and a structured terminal status still lands in
        engine.finished instead of the request generating into the
        void forever; a background drain then consumes the fanout
        through that terminal so the backpressure gauge stays exact."""
        try:
            writer.write(sse.format_event("accepted", {"request": rid}))
            await writer.drain()
            _metrics.gateway_sse_events().labels(event="accepted").inc()
            while True:
                ev = await next_event()
                etype = ev.pop("type")
                writer.write(sse.format_event(etype, ev))
                await writer.drain()
                _metrics.gateway_sse_events().labels(event=etype).inc()
                if etype == "end":
                    return "closed"
        except Exception:
            self.stepper.cancel(rid)
            _metrics.gateway_responses().labels(
                route="generate", code="aborted").inc()
            _tracing.get_tracer().event(
                "stream_aborted", request=rid, status="cancelled",
                reason="client_gone")
            # the drain task holds a strong reference in _drain_tasks
            # until done (the loop only weak-refs running tasks — a
            # bare create_task could be GC'd mid-drain and its
            # exception would vanish)
            task = asyncio.get_running_loop().create_task(
                self._drain_stream(next_event))
            _drain_tasks.add(task)
            task.add_done_callback(_drain_tasks.discard)
            return "aborted"

    @staticmethod
    async def _drain_stream(next_event):
        """Consume an aborted stream's remaining fanout through its
        terminal event: the engine keeps emitting until the cancel
        lands, and every bridged event inc'd the backpressure gauge —
        without this drain each aborted stream would inflate
        gateway_sse_pending_events forever. cancel() guarantees a
        terminal; the timeout is a backstop against a dead stepper."""
        try:
            while True:
                ev = await asyncio.wait_for(next_event(), timeout=60.0)
                if ev["type"] == "end":
                    return
        except asyncio.TimeoutError:
            return

    async def _h_cancel(self, writer, route, headers, body, arg):
        ok = await asyncio.wrap_future(self.stepper.cancel(arg))
        if not ok and arg.isdigit():
            # a client-supplied INT id round-trips through the URL as
            # its decimal string
            ok = await asyncio.wrap_future(self.stepper.cancel(int(arg)))
        if ok:
            return await self._respond(
                writer, route, 200, {"request": arg, "cancelled": True})
        await self._respond(
            writer, route, 404,
            {"error": "not_found", "request": arg,
             "reason": "unknown or already terminal"})

    async def _h_metrics(self, writer, route, headers, body, arg):
        await self._respond(
            writer, route, 200, to_prometheus(),
            ctype="text/plain; version=0.0.4; charset=utf-8")

    async def _h_slo(self, writer, route, headers, body, arg):
        if self.monitor is None:
            return await self._respond(
                writer, route, 404, {"error": "no_monitor"})
        if hasattr(self.monitor, "report"):
            # serialized with the engine's tick() cadence: the monitor
            # is single-threaded by contract
            rep = await asyncio.wrap_future(
                self.stepper.call(lambda cb: self.monitor.report()))
        else:
            rep = getattr(self.monitor, "last_report", None)
        if rep is None:
            return await self._respond(
                writer, route, 404, {"error": "no_report"})
        await self._respond(writer, route, 200, json_safe(rep))

    async def _h_requests(self, writer, route, headers, body, arg):
        ids = _tracing.requests_seen(limit=64)
        digests = []
        for r in ids:
            d = _tracing.request_summary(r)
            digests.append({
                "request": r, "status": d["status"],
                "retired": d["retired"],
                "generated_tokens": d["generated_tokens"],
                "preemptions": d["preemptions"],
            })
        await self._respond(
            writer, route, 200,
            {"schema": REQUESTS_SCHEMA, "count": len(digests),
             "inflight": int(self.engine.num_active),
             "queue_depth": len(self.engine.queue),
             "requests": digests})

    async def _h_request_detail(self, writer, route, headers, body, arg):
        rid = arg if not arg.isdigit() else int(arg)
        d = _tracing.request_summary(rid)
        if d["spans"] == 0 and arg.isdigit():
            d = _tracing.request_summary(arg)      # string-typed id
        if d["spans"] == 0:
            return await self._respond(
                writer, route, 404,
                {"error": "not_found", "request": arg,
                 "reason": "no spans in the ring (unknown, or aged out)"})
        await self._respond(writer, route, 200, d)

    async def _h_dumps(self, writer, route, headers, body, arg):
        fr = _tracing.get_flight_recorder()
        await self._respond(
            writer, route, 200,
            {"schema": DUMPS_SCHEMA, "armed": fr.armed,
             "dir": fr._dir, "retained": fr.retained(),
             "dumps_this_process": len(fr.dumps)})

    async def _h_dump_file(self, writer, route, headers, body, arg):
        fr = _tracing.get_flight_recorder()
        if (not fr.armed or "/" in arg or os.sep in arg
                or not arg.startswith("flightrec_")
                or not arg.endswith(".json")):
            return await self._respond(
                writer, route, 404, {"error": "not_found", "file": arg})
        path = os.path.join(fr._dir, arg)
        try:
            # a dump can be megabytes: the disk read runs on an executor
            # thread so a slow volume can't freeze every live SSE stream
            blob = await asyncio.get_running_loop().run_in_executor(
                None, _read_file, path)
        except OSError:
            return await self._respond(
                writer, route, 404, {"error": "not_found", "file": arg})
        await self._respond(writer, route, 200, blob)

    async def _h_healthz(self, writer, route, headers, body, arg):
        status, reason = self.health()
        if status != self._last_health:
            _metrics.gateway_health_transitions().labels(
                to=status).inc()
            self._last_health = status
        payload = {
            "schema": HEALTHZ_SCHEMA, "status": status, "reason": reason,
            "inflight": int(self.engine.num_active),
            "queue_depth": len(self.engine.queue),
            "steps": int(self.engine._step_count),
            "finished": len(self.engine.finished),
        }
        report = getattr(self.engine, "device_kv_report", None)
        if report is not None:
            # mesh block: tp width + per-device paged-KV bytes (each
            # device holds 1/tp of every block's kv heads under TP
            # serving; single-chip reports its one device) — the
            # per-device view a load balancer sizes KV headroom by
            rows = report()
            payload["mesh"] = {
                "tp": int(getattr(self.engine, "tp", 1) or 1),
                "devices": [{
                    "device": int(r["device"]),
                    "kv_bytes_used": int(r["kv_bytes_used"]),
                    "kv_bytes_high_water": int(r["kv_bytes_high_water"]),
                } for r in rows],
            }
        await self._respond(writer, route,
                            200 if status == "ok" else 503, payload)


def run_gateway(engine, host="127.0.0.1", port=8000, monitor=None,
                memory_watch=None, banner=True):
    """Blocking convenience runner for entrypoints: stepper thread up,
    gateway bound, serve until interrupted. KeyboardInterrupt/
    SystemExit propagate to the caller (examples/torch_serve_gateway.py
    wraps this in tracing.run_with_abort_evidence so Ctrl-C leaves an
    operator_abort flight dump + final metrics snapshot)."""
    stepper = EngineStepper(engine).start()
    gw = ServingGateway(stepper, monitor=monitor,
                        memory_watch=memory_watch, host=host, port=port)

    async def _main():
        await gw.start()
        if banner:
            print(f"serving gateway listening on {gw.url} "
                  f"(POST /v1/generate, GET /metrics /slo /requests "
                  f"/dumps /healthz)")
        await gw.serve_forever()

    try:
        asyncio.run(_main())
    finally:
        stepper.stop()
    return 0
