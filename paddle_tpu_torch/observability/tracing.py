"""Per-request lifecycle tracing + anomaly flight recorder.

A copy of ``paddle_tpu/observability/tracing.py`` (stdlib only), kept apart
so the PyTorch package imports nothing of the JAX package.

PR 3's metrics answer "how is the fleet doing"; this module answers
"why was THIS request slow". With chunked prefill, token budgets,
speculative decode, and KV rewind all interleaving on one compiled
step, a p99 outlier can be queue starvation, a budget-starved prefill,
a spec-rejection storm, an alloc-failure stall, or a post-warmup
recompile — aggregates cannot tell those apart; request-scoped spans
can.

Three pieces, same design constraints as metrics.py (host-side only,
stdlib-only at import, lock-protected):

* ``SpanRecorder`` — a bounded ring of spans ``(ts_us, dur_us, name,
  request, args)``. Recording is a deque append under one lock; the
  ring is sized so "always on" costs nothing measurable next to a
  serving step, and old spans fall off the back instead of growing
  memory. The same ``float()`` tracer guard as the metrics registry
  protects every recorded value: a span recorded under a jax trace
  raises at trace time (graftlint GL105 enforces the same contract
  statically, now covering ``tracing.*`` too).
* chrome export — ``chrome_span_events()`` renders the ring as
  ``"ph": "X"`` duration events on per-request lanes; the profiler
  merges them into its host-range + metric-counter stream so one
  chrome://tracing view shows what every request was doing inside
  every step.
* ``FlightRecorder`` — the ring always runs; when an anomaly trigger
  fires (KV alloc failure, post-warmup bucket recompile, rolling-TPOT
  SLO breach, comm-watchdog stall) it dumps the last ``window_s``
  seconds of spans plus a full metrics snapshot to a timestamped JSON
  file. Disarmed by default (``arm(dir)`` opts in) and rate-limited
  per reason, so a repeating anomaly produces evidence, not a disk
  full of identical dumps. ``tools/request_trace.py`` replays a dump
  as per-request timelines; ``tools/metrics_snapshot.py --selfcheck``
  validates the schema stdlib-only.

Span timebase is ``time.perf_counter()`` microseconds — the same clock
the profiler stamps host ranges and the metrics timeline with, so all
three streams land on one chrome timeline without skew.
"""
import collections
import contextlib
import json
import os
import tempfile
import threading
import time

from .metrics import _host_float, get_registry

__all__ = [
    "SpanRecorder", "FlightRecorder", "get_tracer", "get_flight_recorder",
    "span", "event", "chrome_span_events", "request_summary",
    "requests_seen", "load_dump", "write_dump", "arm_default",
    "load_manifest", "operator_abort_dump", "run_with_abort_evidence",
    "DUMP_SCHEMA", "MANIFEST_SCHEMA", "MANIFEST_NAME",
]

DUMP_SCHEMA = "paddle_tpu.flight_recorder/1"
MANIFEST_SCHEMA = "paddle_tpu.flight_manifest/1"
MANIFEST_NAME = "flightrec_manifest.json"

# server-entrypoint retention defaults (arm_default): bounded enough
# that a long-running server can never fill a disk with evidence, deep
# enough that a p99 incident's dump survives until a human looks
DEFAULT_MAX_DUMPS = 16
DEFAULT_MAX_BYTES = 64 * 1024 * 1024

# chrome tids for span lanes: far away from thread idents (host ranges)
# and from tid 0 (metric counters) so per-request lanes group cleanly
_LANE_TID_BASE = 1000000


def _clean_value(v, what):
    """Host-scalar guard for span args: strings/None pass through, bools
    stay bools, everything else must coerce through float() — a jax
    tracer fails that coercion, which is the runtime half of the
    host-side-only contract (static half: graftlint GL105). Integral
    floats come back as ints so dumps stay readable."""
    if v is None or isinstance(v, (str, bool)):
        return v
    f = _host_float(v, what)
    return int(f) if f.is_integer() else f


class SpanRecorder:
    """Bounded, lock-protected ring of host-side spans."""

    def __init__(self, capacity=8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._spans = collections.deque(maxlen=self.capacity)
        self.enabled = True
        self.recorded_total = 0     # appends ever (ring drops the oldest)

    # -- recording --------------------------------------------------------
    def record_span(self, name, start_us, dur_us, request=None, **args):
        """Append one span. `start_us`/`dur_us` are perf_counter
        microseconds; `request` is the request id the span belongs to
        (None = engine lane); `args` are small host scalars/strings."""
        if not self.enabled:
            return
        what = f"span {name!r}"
        start_us = _host_float(start_us, what)
        dur_us = _host_float(dur_us, what)
        if request is not None and not isinstance(request, str):
            request = _clean_value(request, what)
        if args:
            args = {k: _clean_value(v, f"{what} arg {k!r}")
                    for k, v in args.items()}
        with self._lock:
            self._spans.append((start_us, dur_us, str(name), request,
                                args or None))
            self.recorded_total += 1

    def event(self, name, request=None, **args):
        """Zero-duration instant (first token, stall, trigger, ...)."""
        self.record_span(name, time.perf_counter() * 1e6, 0.0,
                         request=request, **args)

    @contextlib.contextmanager
    def span(self, name, request=None, **args):
        """Context manager measuring the enclosed host interval."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record_span(name, t0 * 1e6,
                             (time.perf_counter() - t0) * 1e6,
                             request=request, **args)

    # -- reading ----------------------------------------------------------
    def spans(self, since_us=None, until_us=None, request=None):
        """Snapshot as json-friendly dicts, oldest first. The window
        keeps any span that OVERLAPS it: `since_us` tests the span's
        END (a 60s queue_wait that closes inside a 30s flight-recorder
        window is exactly the outlier evidence the dump exists for),
        `until_us` its start. `request` filters one lane."""
        with self._lock:
            raw = list(self._spans)
        out = []
        for ts, dur, name, req, args in raw:
            if since_us is not None and ts + dur < since_us:
                continue
            if until_us is not None and ts > until_us:
                continue
            if request is not None and req != request:
                continue
            out.append({"name": name, "ts_us": ts, "dur_us": dur,
                        "request": req, "args": args or {}})
        return out

    def __len__(self):
        with self._lock:
            return len(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()


_tracer = SpanRecorder()


def get_tracer():
    """The process-wide span ring every instrumented surface records
    into (the serving engine, the paged-step dispatch wrappers, ...)."""
    return _tracer


def span(name, request=None, **args):
    """`with tracing.span("prefill_chunk", request=rid, width=64):` on
    the process-wide recorder."""
    return _tracer.span(name, request=request, **args)


def event(name, request=None, **args):
    _tracer.event(name, request=request, **args)


# -- chrome export ---------------------------------------------------------

def chrome_span_events(recorder=None, pid=None, since_us=None,
                       until_us=None):
    """The ring as chrome-trace ``"ph": "X"`` duration events, one lane
    (tid) per request id plus lane 0 for engine-scope spans, with
    ``"M"`` thread_name metadata naming each lane — merged by
    Profiler._export_chrome into the host-range + counter stream. Every
    event carries the full profiler key set (the export contract)."""
    recorder = recorder if recorder is not None else get_tracer()
    if pid is None:
        pid = os.getpid()
    lanes = {}      # request id -> lane tid, by first appearance

    def lane(req):
        if req is None:
            return _LANE_TID_BASE
        t = lanes.get(req)
        if t is None:
            t = lanes[req] = _LANE_TID_BASE + 1 + len(lanes)
        return t

    events = []
    for s in recorder.spans(since_us=since_us, until_us=until_us):
        args = dict(s["args"])
        if s["request"] is not None:
            args["request"] = s["request"]
        events.append({"name": s["name"], "ph": "X", "ts": s["ts_us"],
                       "dur": s["dur_us"], "pid": pid,
                       "tid": lane(s["request"]), "cat": "request",
                       "args": args})
    meta = [{"name": "thread_name", "ph": "M", "ts": 0, "dur": 0,
             "pid": pid, "tid": _LANE_TID_BASE, "cat": "request",
             "args": {"name": "serve engine"}}] if events else []
    for req, tid in lanes.items():
        meta.append({"name": "thread_name", "ph": "M", "ts": 0, "dur": 0,
                     "pid": pid, "tid": tid, "cat": "request",
                     "args": {"name": f"request {req}"}})
    return meta + events


# -- per-request summary ---------------------------------------------------

def requests_seen(recorder=None, limit=None):
    """Distinct request ids in the span ring, oldest-first (the
    gateway's /requests listing: the ring is the one place every
    request's lifecycle already lands, live and retired alike, so the
    control plane needs no second registry). `limit` keeps the NEWEST
    n ids."""
    rec = recorder if recorder is not None else get_tracer()
    seen = {}
    for s in rec.spans():
        r = s["request"]
        if r is not None and r not in seen:
            seen[r] = True
    ids = list(seen)
    if limit is not None and len(ids) > limit:
        ids = ids[-int(limit):]
    return ids


def request_summary(request, spans=None, recorder=None):
    """`request.explain()`-style digest of one request's lifecycle from
    its spans: queue wait, TTFT, chunk grants (granted vs requested),
    stalls, decode/spec accounting, effective TPOT. Works on live rings
    and on flight-recorder dumps (pass the dump's `spans` list)."""
    if spans is None:
        spans = (recorder if recorder is not None
                 else get_tracer()).spans(request=request)
    else:
        spans = [s for s in spans if s.get("request") == request]
    out = {
        "request": request,
        "spans": len(spans),
        "queue_wait_s": None,
        "ttft_s": None,
        "tpot_s": None,
        "prefill_chunks": [],
        "prompt_tokens": None,
        "generated_tokens": None,
        "decode_steps": 0,
        "cached_prefix_tokens": 0,
        "stalls": {"budget": 0, "alloc": 0, "admit_blocked": 0,
                   "cache_pending": 0},
        "spec": {"drafted": 0, "accepted": 0, "accept_rate": None,
                 "rewinds": 0, "blocks_freed": 0},
        "preemptions": 0,
        "status": None,
        "retired": False,
    }
    first_token_us = None
    last_decode_end_us = None
    tokens_after_first = 0
    for s in spans:
        name, args = s["name"], s.get("args") or {}
        if name == "submit":
            out["prompt_tokens"] = args.get("prompt_tokens")
        elif name == "queue_wait":
            out["queue_wait_s"] = s["dur_us"] / 1e6
        elif name == "prefill_chunk":
            out["prefill_chunks"].append(
                {"granted": args.get("granted"),
                 "requested": args.get("requested")})
        elif name == "first_token":
            first_token_us = s["ts_us"]
            out["ttft_s"] = args.get("ttft_s")
        elif name == "decode":
            out["decode_steps"] += 1
            emitted = args.get("emitted", 1) or 0
            tokens_after_first += emitted
            last_decode_end_us = s["ts_us"] + s["dur_us"]
            out["spec"]["drafted"] += args.get("drafted", 0) or 0
            out["spec"]["accepted"] += args.get("accepted", 0) or 0
            if (args.get("drafted", 0) or 0) > (args.get("accepted", 0)
                                                or 0):
                out["spec"]["rewinds"] += 1
            out["spec"]["blocks_freed"] += args.get("blocks_freed", 0) or 0
        elif name == "cache_hit":
            # cumulative in the event args: the last one wins (a prefix
            # may extend across steps as the wavefront catches up)
            out["cached_prefix_tokens"] = args.get(
                "total", out["cached_prefix_tokens"])
        elif name == "stall_budget":
            out["stalls"]["budget"] += 1
        elif name == "stall_alloc":
            out["stalls"]["alloc"] += 1
        elif name == "stall_cache_pending":
            out["stalls"]["cache_pending"] += 1
        elif name == "admit_blocked":
            out["stalls"]["admit_blocked"] += 1
        elif name == "preempt":
            out["preemptions"] += 1
            out["status"] = "preempted"
        elif name in ("cancel", "shed", "reject", "deadline_exceeded",
                      "request_failed"):
            # terminal lifecycle events carry the structured status the
            # engine recorded on the request (the retire event below
            # overrides for requests that went on to finish)
            out["status"] = args.get("status", out["status"])
        elif name == "retire":
            out["retired"] = True
            out["generated_tokens"] = args.get("generated")
            out["status"] = args.get("status", "finished")
    if out["spec"]["drafted"]:
        out["spec"]["accept_rate"] = round(
            out["spec"]["accepted"] / out["spec"]["drafted"], 4)
    if (first_token_us is not None and last_decode_end_us is not None
            and tokens_after_first > 0):
        out["tpot_s"] = ((last_decode_end_us - first_token_us) / 1e6
                         / tokens_after_first)
    return out


# -- flight recorder -------------------------------------------------------

class FlightRecorder:
    """Anomaly-triggered dump of the span ring + a metrics snapshot.

    The ring records continuously and cheaply; `trigger(reason, ...)`
    writes the last `window_s` seconds of spans and the full metrics
    registry to ``<dir>/flightrec_<reason>_<ms>_<seq>.json`` — but only
    when armed (`arm(dir)`), and at most once per `min_interval_s` per
    reason, so a repeating anomaly leaves evidence without flooding the
    disk. `max_dumps`/`max_bytes` bound the dir regardless (oldest-first
    rotation + a manifest index — the long-running-server policy
    `arm_default()` turns on). Triggers wired in today:
    ``kv_alloc_failure`` (now a PER-REQUEST failure: fired only when no
    preemptible victim exists), ``preemption`` (a victim's KV went back
    to blocks and the request re-queued), ``post_warmup_recompile`` and
    ``tpot_slo_breach`` (incubate/nn/continuous_batching.py),
    ``slo_burn_rate`` (observability/slo.py burn-rate breaches),
    ``hbm_pressure`` (observability/memory.py),
    ``comm_watchdog_stall`` (distributed/comm_watchdog.py),
    ``operator_abort`` (serve entrypoints catching
    KeyboardInterrupt/SystemExit — `operator_abort_dump()`), plus
    ``manual`` via write_dump()."""

    def __init__(self, recorder=None, window_s=30.0, min_interval_s=2.0,
                 max_dumps=None, max_bytes=None):
        self.recorder = recorder    # None = the process-wide tracer
        self.window_s = float(window_s)
        self.min_interval_s = float(min_interval_s)
        self.max_dumps = max_dumps      # retention: None = unbounded
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._dir = None
        self._last = {}             # reason -> last-dump perf_counter
        self._seq = 0
        self._manifest = []         # retained-dump index (armed dir)
        self.evicted_total = 0      # dumps rotated out by retention
        self.dumps = []             # paths written this process

    @property
    def armed(self):
        return self._dir is not None

    def arm(self, out_dir, window_s=None, min_interval_s=None,
            max_dumps=None, max_bytes=None):
        """Start dumping into `out_dir` (created on first dump).
        `max_dumps`/`max_bytes` bound the dir: after every write the
        oldest dumps rotate out until both limits hold (the newest dump
        always survives), and a manifest index
        (``<dir>/flightrec_manifest.json``) lists what is retained. An
        existing manifest in the dir is adopted, so a restarted server
        keeps rotating the same evidence window instead of leaking the
        previous process's dumps."""
        # validate BEFORE mutating: a rejected arm() must leave the
        # recorder exactly as it was (a caught ValueError must not leave
        # it armed with an evict-everything quota)
        if max_dumps is not None and int(max_dumps) < 1:
            raise ValueError("max_dumps must be >= 1")
        if max_bytes is not None and int(max_bytes) < 1:
            raise ValueError("max_bytes must be >= 1")
        # the manifest ADOPTION (a disk read) happens before the lock:
        # arming must not stall a concurrent trigger/record behind file
        # IO (GL115) — only the state flip is serialized. On a re-arm of
        # the dir we are ALREADY rotating, the in-memory manifest is the
        # authority (a trigger may have retained a dump between the read
        # above and the lock below — adopting the disk copy would orphan
        # it); the disk read only seeds a dir this process isn't
        # tracking yet.
        adopted = self._adopt_manifest(str(out_dir))
        with self._lock:
            rearming_same_dir = self._dir == str(out_dir)
            self._dir = str(out_dir)
            if window_s is not None:
                self.window_s = float(window_s)
            if min_interval_s is not None:
                self.min_interval_s = float(min_interval_s)
            if max_dumps is not None:
                self.max_dumps = int(max_dumps)
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            if not rearming_same_dir:
                self._manifest = adopted
        return self

    def disarm(self):
        with self._lock:
            self._dir = None
            self._manifest = []

    # -- retention --------------------------------------------------------
    @staticmethod
    def _adopt_manifest(out_dir):
        """Entries of an existing manifest whose files still exist —
        a fresh arm() of a dir a previous process dumped into continues
        its rotation instead of orphaning the old files."""
        try:
            data = load_manifest(out_dir)
        except (OSError, ValueError):
            return []
        return [dict(e) for e in data["dumps"]
                if os.path.exists(os.path.join(out_dir, e["file"]))]

    def _retain(self, path, reason, rec):
        """Register a just-written dump in the manifest and rotate the
        oldest dumps out until max_dumps/max_bytes hold (newest always
        kept). Runs on the serving thread: any OSError is recorded, not
        raised — retention must never take down the step."""
        out_dir = os.path.dirname(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        evicted = []
        io_error = None
        # the manifest WRITE stays under the lock too: two concurrent
        # triggers (serving thread + watchdog thread, different reasons
        # so both clear the cooldown) must not interleave state-mutate
        # and write — the loser would persist a stale manifest missing
        # the winner's dump, orphaning it from rotation forever
        with self._lock:
            if self._dir is None or out_dir != self._dir:
                return              # explicit-path dump: not managed
            self._manifest.append(
                {"file": os.path.basename(path), "reason": str(reason),
                 "time": time.time(), "bytes": int(size),
                 "seq": self._seq})
            total = sum(e["bytes"] for e in self._manifest)
            while len(self._manifest) > 1 and (
                    (self.max_dumps is not None
                     and len(self._manifest) > self.max_dumps)
                    or (self.max_bytes is not None
                        and total > self.max_bytes)):
                e = self._manifest.pop(0)   # oldest-first
                total -= e["bytes"]
                evicted.append(e)
                self.evicted_total += 1
            manifest = [dict(e) for e in self._manifest]
            try:
                # deliberate GL115 exceptions: eviction + manifest write
                # stay under the lock so two concurrent triggers can't
                # interleave state-mutate and write (the loser would
                # persist a stale manifest orphaning the winner's dump
                # from rotation); _retain runs per-DUMP, not per-step
                for e in evicted:
                    try:
                        os.remove(os.path.join(out_dir, e["file"]))  # graftlint: disable=GL115 - manifest-rotation atomicity (see above)
                    except FileNotFoundError:
                        pass
                tmp = os.path.join(out_dir, MANIFEST_NAME + ".tmp")
                with open(tmp, "w") as f:  # graftlint: disable=GL115 - same manifest-atomicity exception
                    json.dump({"schema": MANIFEST_SCHEMA,  # graftlint: disable=GL115 - same manifest-atomicity exception
                               "evicted_total": self.evicted_total,
                               "dumps": manifest}, f, indent=1)
                os.replace(tmp, os.path.join(out_dir, MANIFEST_NAME))  # graftlint: disable=GL115 - same manifest-atomicity exception
            except OSError as e:
                io_error = e
        if io_error is not None:
            rec.event("flight_retention_failed", error=str(io_error))
            return
        if evicted:
            rec.event("flight_dump_evicted", count=len(evicted))
            get_registry().counter(
                "flight_recorder_dumps_evicted_total",
                help="dumps rotated out by the retention policy").inc(
                    len(evicted))

    def retained(self):
        """Manifest snapshot: the dumps retention currently keeps."""
        with self._lock:
            return [dict(e) for e in self._manifest]

    def trigger(self, reason, request=None, **context):
        """Record the anomaly; write a dump when armed + off cooldown.
        Returns the dump path, or None when nothing was written. Always
        leaves a `flight_trigger` event in the ring (cheap, so even an
        unarmed process shows the anomaly on its timeline) and counts
        dumps into flight_recorder_dumps_total{reason}."""
        # `or` would skip an EMPTY custom ring (SpanRecorder.__len__)
        rec = self.recorder if self.recorder is not None \
            else get_tracer()
        rec.event("flight_trigger", request=request, reason=str(reason),
                  **context)
        now = time.perf_counter()
        with self._lock:
            if self._dir is None:
                return None
            last = self._last.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last[reason] = now
            self._seq += 1
            seq = self._seq
            out_dir = self._dir
        path = os.path.join(
            out_dir, f"flightrec_{reason}_{int(time.time() * 1000)}_"
                     f"{seq}.json")
        try:
            self._write(path, reason, rec, request, context,
                        since_us=(now - self.window_s) * 1e6)
        except OSError as e:
            # A diagnostics dump must never take down the serving step or
            # the watchdog thread (full disk / unwritable dir). Leave the
            # failure on the timeline, give the cooldown back so the next
            # anomaly retries, and count it.
            rec.event("flight_dump_failed", request=request,
                      reason=str(reason), error=str(e))
            with self._lock:
                if self._last.get(reason) == now:
                    del self._last[reason]
            get_registry().counter(
                "flight_recorder_dump_failures_total",
                help="anomaly dumps that failed to write",
                labels=("reason",)).labels(reason=str(reason)).inc()
            return None
        with self._lock:
            self.dumps.append(path)
        self._retain(path, reason, rec)
        get_registry().counter(
            "flight_recorder_dumps_total",
            help="anomaly dumps written by the flight recorder",
            labels=("reason",)).labels(reason=str(reason)).inc()
        return path

    def _write(self, path, reason, rec, request, context, since_us=None):
        spans = rec.spans(since_us=since_us)
        requests = []
        for s in spans:
            if s["request"] is not None and s["request"] not in requests:
                requests.append(s["request"])
        payload = {
            "schema": DUMP_SCHEMA,
            "time": time.time(),
            "reason": str(reason),
            "request": request,
            "context": {k: _clean_value(v, f"dump context {k!r}")
                        for k, v in context.items()},
            "window_s": self.window_s,
            "requests": requests,
            "spans": spans,
            "metrics": get_registry().snapshot(),
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path

    def dump_to(self, path, reason="manual", request=None, **context):
        """Unconditional dump to an explicit path (no arming, no
        cooldown): the whole ring, not just the window — what
        serve_llama --trace and the bench trace leg write."""
        # `or` would skip an EMPTY custom ring (SpanRecorder.__len__)
        rec = self.recorder if self.recorder is not None \
            else get_tracer()
        out = self._write(path, reason, rec, request, context)
        with self._lock:
            self.dumps.append(out)
        # a manual dump landing INSIDE the armed dir participates in
        # retention like any trigger; explicit paths elsewhere are the
        # caller's to manage
        self._retain(out, reason, rec)
        return out


_flight = FlightRecorder()


def get_flight_recorder():
    """The process-wide flight recorder the serving/distributed anomaly
    triggers fire into."""
    return _flight


def write_dump(path, reason="manual", request=None, **context):
    """Dump the process-wide span ring + metrics snapshot to `path`."""
    return _flight.dump_to(path, reason=reason, request=request, **context)


def arm_default(out_dir=None, window_s=None,
                max_dumps=DEFAULT_MAX_DUMPS, max_bytes=DEFAULT_MAX_BYTES):
    """Server-entrypoint arming policy: the process flight recorder,
    bounded retention on. Long-running serve loops (serve_llama
    --continuous, serve_bench, serve_monitor) call this by default so a
    production p99 incident ships with its own evidence — the ROADMAP's
    "arm-by-default + dump retention" item. Dir resolution:
    `out_dir` arg > $PADDLE_TPU_FLIGHT_DIR > <tmp>/paddle_tpu_flightrec.
    Returns the armed recorder (disarm() to opt back out)."""
    if out_dir is None:
        out_dir = os.environ.get("PADDLE_TPU_FLIGHT_DIR") or os.path.join(
            tempfile.gettempdir(), "paddle_tpu_flightrec")
    return _flight.arm(out_dir, window_s=window_s, max_dumps=max_dumps,
                       max_bytes=max_bytes)


def operator_abort_dump(signal="KeyboardInterrupt", **context):
    """Final evidence write for an operator-initiated shutdown: serve
    entrypoints call this from their KeyboardInterrupt/SystemExit
    handlers so a Ctrl-C mid-incident still leaves a flight dump (the
    whole span window + a full metrics snapshot) instead of a dead
    process and no trail. When the process recorder is armed the dump
    goes through the normal trigger path (retention + manifest);
    unarmed processes get a best-effort dump in the default flight dir
    — unless NOTHING has run yet (recorder unarmed and the span ring
    empty: an argparse --help / bad-flag SystemExit has no evidence to
    preserve and must not litter dump files). Never raises: shutdown
    evidence must not turn an abort into a crash. Returns the dump
    path or None."""
    try:
        if _flight.armed:
            return _flight.trigger("operator_abort", signal=str(signal),
                                   **context)
        if len(get_tracer()) == 0:
            return None
        out_dir = os.environ.get("PADDLE_TPU_FLIGHT_DIR") or os.path.join(
            tempfile.gettempdir(), "paddle_tpu_flightrec")
        path = os.path.join(
            out_dir, f"flightrec_operator_abort_"
                     f"{int(time.time() * 1000)}_0.json")
        return _flight.dump_to(path, reason="operator_abort",
                               signal=str(signal), **context)
    except Exception:
        return None


def run_with_abort_evidence(fn):
    """Entrypoint wrapper shared by serve_llama / serve_bench /
    serve_monitor: run `fn()` and translate an operator abort
    (KeyboardInterrupt, or a SystemExit raised MID-RUN) into an
    `operator_abort` flight dump + the conventional exit code (130 for
    Ctrl-C). Returns the process exit code; one implementation so the
    three entrypoints cannot drift."""
    import sys

    try:
        rc = fn()
        return 0 if rc is None else rc
    except (KeyboardInterrupt, SystemExit) as e:
        path = operator_abort_dump(signal=type(e).__name__)
        if path:
            print(f"\noperator abort ({type(e).__name__}): flight dump "
                  f"+ metrics snapshot -> {path}", file=sys.stderr)
        if isinstance(e, KeyboardInterrupt):
            return 130
        # preserve SystemExit conventions: sys.exit() -> 0,
        # sys.exit(int) -> that code, sys.exit("msg") -> print + 1
        if e.code is None:
            return 0
        if isinstance(e.code, int):
            return e.code
        print(e.code, file=sys.stderr)
        return 1


def load_manifest(dump_dir):
    """Load + schema-validate a retention manifest
    (``<dir>/flightrec_manifest.json``; stdlib only, same contract as
    load_dump). Raises ValueError on anything that is not a v1
    manifest, OSError when the dir has none."""
    path = os.path.join(str(dump_dir), MANIFEST_NAME)
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"{path}: not a {MANIFEST_SCHEMA} manifest (schema="
            f"{data.get('schema') if isinstance(data, dict) else None!r})")
    if not isinstance(data.get("dumps"), list):
        raise ValueError(f"{path}: manifest dumps is not a list")
    for i, e in enumerate(data["dumps"]):
        if not {"file", "reason", "time", "bytes"} <= set(e):
            raise ValueError(f"{path}: manifest entry {i} malformed: "
                             f"{sorted(e)}")
    return data


def load_dump(path):
    """Load + schema-validate a flight-recorder dump (stdlib only — the
    same loader tools/request_trace.py and the --selfcheck use).
    Raises ValueError on anything that is not a v1 dump."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("schema") != DUMP_SCHEMA:
        raise ValueError(
            f"{path}: not a {DUMP_SCHEMA} dump "
            f"(schema={data.get('schema') if isinstance(data, dict) else None!r})")
    missing = {"time", "reason", "window_s", "requests", "spans",
               "metrics"} - set(data)
    if missing:
        raise ValueError(f"{path}: dump missing keys {sorted(missing)}")
    if not isinstance(data["spans"], list):
        raise ValueError(f"{path}: spans is not a list")
    for i, s in enumerate(data["spans"]):
        if not {"name", "ts_us", "dur_us", "request", "args"} <= set(s):
            raise ValueError(f"{path}: span {i} malformed: {sorted(s)}")
    return data
