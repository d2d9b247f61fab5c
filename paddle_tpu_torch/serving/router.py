"""EngineRouter — a data-parallel replica pool behind one gateway.

The PyTorch port's copy of ``paddle_tpu/serving/router.py``.

The scheduler is a single host brain over one
engine: throughput scales only by making that replica faster. This
module multiplies it by N instead: each replica is an independent
``ContinuousBatchingEngine`` owned by its own ``EngineStepper``
thread, and the router presents the stepper's exact surface (``submit`` /
``cancel`` / ``call`` / ``hold`` / ``release`` / ``error`` /
``engine``) so ``ServingGateway`` serves an N-replica pool with an
UNCHANGED /v1/generate + SSE + cancel API.

Routing is a pluggable :class:`RoutingPolicy`:

* ``round_robin`` — the baseline rotation over live replicas;
* ``least_loaded`` — fewest router-tracked in-flight requests
  (submit through terminal, so queued + active on that replica);
* ``prefix_affinity`` — match the prompt's chained block-key ladder
  (``prompt_block_keys``, the same math admission hashes into
  ``req._prompt_keys``) against each replica's published
  ``prefix_index_summary()``; the replica already holding the longest
  leading run of the prompt's blocks maps them for free and skips the
  prefill sweep — the dominant TTFT cost for shared-prefix chat
  traffic. No match falls back to least-loaded, and a load-imbalance
  cap vetoes a match that would pile ``imbalance_cap`` more requests
  on the matched replica than the idlest survivor holds — affinity
  never starves a replica.

Summaries are refreshed from terminal fanout, which runs ON the
replica's stepper thread (the one place its engine may be read), so
the router's cached copies are consistent snapshots with zero extra
cross-thread traffic.

Failure rides the stepper's structured-terminal machinery: a replica
whose ``step()`` crashes fans ``engine_error`` terminals to every
subscriber. The router intercepts them — a request that never
streamed a token is transparently resubmitted (as a fresh request,
same id) to a survivor and its client stream continues as if nothing
happened; a mid-stream request forwards the structured failure (its
partial KV died with the replica). The crashed replica is marked
drained and never routed to again; ``error`` stays None while any
replica survives, so /healthz keeps answering ok for the pool.

Replicas on one card all launch on its default stream: the ragged
attention kernel's split counters are kept per (card, stream), and
launches on one stream run in order, so the replicas' launches never
use one counter at once (``ops/paged_attention.py`` ``_counters``).

stdlib-only at import, same contract as the rest of the package —
the engine types are imported lazily at submit time.
"""
import concurrent.futures
import threading

from ..observability import instrument as _metrics
from ..observability import tracing as _tracing

__all__ = ["EngineRouter", "RoutingPolicy", "RoundRobinPolicy",
           "LeastLoadedPolicy", "PrefixAffinityPolicy", "POLICIES"]


class RoutingPolicy:
    """Strategy interface: ``choose(view)`` returns the pool index to
    route to, or ``(index, affinity)`` where ``affinity`` is "hit" /
    "miss" (only the affinity policy reports it). ``view`` is a
    :class:`RouteView` snapshot the router builds under its lock."""

    name = "policy"

    def choose(self, view):
        raise NotImplementedError


class RouteView:
    """What a policy may see: live pool slots, router-tracked
    in-flight counts, the published prefix summaries, and the
    prompt's chained block keys."""

    __slots__ = ("live", "inflight", "summaries", "keys")

    def __init__(self, live, inflight, summaries, keys):
        self.live = live            # tuple of routable pool indices
        self.inflight = inflight    # {index: submit->terminal count}
        self.summaries = summaries  # {index: frozenset of block keys}
        self.keys = keys            # the prompt's chained key ladder


def _least_loaded(view):
    return min(view.live, key=lambda i: (view.inflight[i], i))


class RoundRobinPolicy(RoutingPolicy):
    """Rotate over live replicas in pool order — the baseline every
    smarter policy is gated against."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, view):
        order = sorted(view.live)
        pick = next((i for i in order if i >= self._next), order[0])
        self._next = pick + 1
        return pick


class LeastLoadedPolicy(RoutingPolicy):
    """Fewest in-flight (queued + active) requests wins; ties break
    to the lowest pool slot."""

    name = "least_loaded"

    def choose(self, view):
        return _least_loaded(view)


class PrefixAffinityPolicy(RoutingPolicy):
    """Longest-leading-match of the prompt's block-key chain against
    the replicas' published prefix indexes, with a least-loaded
    fallback and an imbalance cap (a match more than ``imbalance_cap``
    requests busier than the idlest replica is vetoed)."""

    name = "prefix_affinity"

    def __init__(self, imbalance_cap=4):
        if imbalance_cap < 1:
            raise ValueError("imbalance_cap must be >= 1")
        self.imbalance_cap = int(imbalance_cap)

    def _match_len(self, view, i):
        summary = view.summaries.get(i, frozenset())
        n = 0
        for k in view.keys:
            if k not in summary:
                break
            n += 1
        return n

    def choose(self, view):
        best, best_len = None, 0
        for i in sorted(view.live):
            n = self._match_len(view, i)
            if n > best_len or (n == best_len and n > 0
                                and best is not None
                                and view.inflight[i]
                                < view.inflight[best]):
                best, best_len = i, n
        if best is None or best_len == 0:
            return _least_loaded(view), "miss"
        floor = min(view.inflight[i] for i in view.live)
        if view.inflight[best] - floor > self.imbalance_cap:
            return _least_loaded(view), "miss"
        return best, "hit"


POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


class _Entry:
    """Router-side record of one live request: everything needed to
    resubmit it to a survivor if its replica dies before it streams."""

    __slots__ = ("replica", "on_event", "streamed", "spec")

    def __init__(self, replica, on_event, spec):
        self.replica = replica
        self.on_event = on_event
        self.streamed = False
        self.spec = spec        # ctor kwargs for a clean resubmit clone


class _PoolEngineView:
    """The aggregate `engine` attribute the gateway reads: pool-wide
    sums for the scheduler gauges, replica 0's mesh shape for the
    /healthz mesh block (the pool is homogeneous by construction).
    Reads are the same racy-but-atomic int peeks the gateway already
    performs on a single engine from the asyncio thread."""

    def __init__(self, router):
        self._router = router

    def _engines(self):
        return [s.engine for s in self._router.steppers]

    @property
    def num_active(self):
        return sum(e.num_active for e in self._engines())

    @property
    def queue(self):
        out = []
        for e in self._engines():
            out.extend(e.queue)
        return out

    @property
    def _step_count(self):
        return sum(e._step_count for e in self._engines())

    @property
    def finished(self):
        out = {}
        for e in self._engines():
            out.update(e.finished)
        return out

    @property
    def tp(self):
        return getattr(self._engines()[0], "tp", 1)

    def device_kv_report(self):
        return self._engines()[0].device_kv_report()


class EngineRouter:
    """Stepper-compatible front over N started ``EngineStepper``s.

    ``ServingGateway(EngineRouter(steppers, policy="prefix_affinity"))``
    is the whole integration: the gateway cannot tell one replica from
    a pool. ``policy`` is a name from :data:`POLICIES` or a
    ``RoutingPolicy`` instance (bring your own).
    """

    def __init__(self, steppers, policy="round_robin", **policy_kw):
        if not steppers:
            raise ValueError("EngineRouter needs at least one replica")
        self.steppers = list(steppers)
        if isinstance(policy, str):
            try:
                policy = POLICIES[policy](**policy_kw)
            except KeyError:
                raise ValueError(
                    f"unknown routing policy {policy!r} "
                    f"(have {sorted(POLICIES)})") from None
        self.policy = policy
        self._lock = threading.Lock()
        self._entries = {}              # rid -> _Entry
        self._inflight = {i: 0 for i in range(len(self.steppers))}
        self._summaries = {i: frozenset()
                           for i in range(len(self.steppers))}
        # None until the first full walk seeds a version; slot i is
        # only ever written from replica i's stepper thread
        self._summary_versions = {i: None
                                  for i in range(len(self.steppers))}
        # pinned by tests: how the cached summaries stay fresh —
        # bounded delta replay vs full index walks
        self.summary_delta_refreshes = 0
        self.summary_full_refreshes = 0
        self.summary_keys_replayed = 0
        self._drained = set()
        self.engine = _PoolEngineView(self)
        _metrics.router_replicas_live().set(len(self.steppers))
        for i in range(len(self.steppers)):
            _metrics.router_replica_inflight().labels(
                replica=str(i)).set(0)

    # -- pool introspection -------------------------------------------------
    @property
    def num_replicas(self):
        return len(self.steppers)

    def live_replicas(self):
        with self._lock:
            return [i for i in range(len(self.steppers))
                    if i not in self._drained]

    def replica_summary(self, i):
        """The router's cached prefix summary for pool slot i (what
        the affinity policy actually matched against)."""
        with self._lock:
            return self._summaries[i]

    # -- stepper-surface lifecycle ------------------------------------------
    def start(self):
        for s in self.steppers:
            if not s._thread.is_alive():
                s.start()
        return self

    def stop(self, join=True, timeout=30.0):
        for s in self.steppers:
            s.stop(join=join, timeout=timeout)

    @property
    def running(self):
        return any(s.running for s in self.steppers)

    @property
    def error(self):
        """None while ANY replica still serves — the pool degrades,
        it does not die. All-dead reports the first replica's error so
        /healthz flips to engine_error exactly like a single stepper."""
        errors = [s.error for s in self.steppers]
        if any(e is None for e in errors):
            return None
        return errors[0]

    def hold(self):
        for s in self.steppers:
            s.hold()

    def release(self):
        for s in self.steppers:
            s.release()

    def call(self, fn):
        """Control-plane peek, serialized on replica 0's stepper (the
        monitor/report surface assumes one engine; per-replica peeks
        go through ``steppers[i].call`` directly)."""
        return self.steppers[0].call(fn)

    # -- routing ------------------------------------------------------------
    def _route_view(self, request):
        from ..incubate.nn.continuous_batching import prompt_block_keys
        live = tuple(i for i in range(len(self.steppers))
                     if i not in self._drained)
        keys = ()
        if live and getattr(self.policy, "name", "") == "prefix_affinity":
            bs = self.steppers[live[0]].engine.block_size
            keys = prompt_block_keys(request.prompt, bs)
        return RouteView(live, dict(self._inflight),
                         dict(self._summaries), keys)

    def _failed_future(self, exc):
        fut = concurrent.futures.Future()
        fut.set_exception(exc)
        return fut

    def submit(self, request, on_event=None):
        """Route and delegate. The future resolves with the chosen
        replica's admission verdict; a duplicate request id anywhere
        in the pool fails it with ValueError (the gateway's 409), same
        as one stepper refusing a duplicate stream."""
        rid = request.request_id
        spec = {"prompt": list(request.prompt),
                "max_new_tokens": request.max_new_tokens,
                "priority": request.priority,
                "deadline_steps": request.deadline_steps,
                "deadline_s": request.deadline_s,
                "spec_k": request.spec_k,
                "temperature": request.temperature}
        with self._lock:
            if rid in self._entries:
                return self._failed_future(ValueError(
                    f"request_id {rid!r} already streaming"))
            view = self._route_view(request)
            if not view.live:
                return self._failed_future(RuntimeError(
                    "no live replicas: " + repr(self.error)))
            # a rid the pool already RETIRED routes to its owner, whose
            # engine refuses the duplicate (ValueError -> the gateway's
            # 409) exactly as one engine would; any other replica never
            # saw the id and would silently re-run it
            owner = next((i for i in view.live
                          if rid in self.steppers[i].engine.finished),
                         None)
            affinity = None
            if owner is not None:
                picked = owner
            else:
                picked = self.policy.choose(view)
                if isinstance(picked, tuple):
                    picked, affinity = picked
            self._entries[rid] = _Entry(picked, on_event, spec)
            self._inflight[picked] += 1
            _metrics.router_replica_inflight().labels(
                replica=str(picked)).set(self._inflight[picked])
        pname = getattr(self.policy, "name", "custom")
        _metrics.routed_requests().labels(
            policy=pname, replica=str(picked)).inc()
        if affinity == "hit":
            _metrics.router_affinity_hits().inc()
        elif affinity == "miss":
            _metrics.router_affinity_misses().inc()
        _tracing.get_tracer().event(
            "route", request=rid, replica=picked, policy=pname,
            matched_blocks=sum(1 for k in view.keys
                               if k in view.summaries.get(picked, ()))
            if affinity else 0)
        fut = self.steppers[picked].submit(
            request, on_event=self._fanout(rid))
        fut.add_done_callback(
            lambda f: self._forget_if_failed(rid, f))
        return fut

    def _forget_if_failed(self, rid, fut):
        """A submit whose future FAILED never reached the engine (the
        stepper dropped its subscription): no terminal will ever fire,
        so the routing entry must not leak."""
        if fut.cancelled() or fut.exception() is not None:
            self._drop_entry(rid)

    def _drop_entry(self, rid):
        with self._lock:
            entry = self._entries.pop(rid, None)
            if entry is None:
                return None
            self._inflight[entry.replica] -= 1
            _metrics.router_replica_inflight().labels(
                replica=str(entry.replica)).set(
                    self._inflight[entry.replica])
        return entry

    def cancel(self, request_id):
        """Delegate to the owning replica; an unknown id resolves
        False from replica 0 (same found-live contract)."""
        with self._lock:
            entry = self._entries.get(request_id)
            target = entry.replica if entry is not None else 0
        return self.steppers[target].cancel(request_id)

    # -- fanout interception (replica stepper threads) ----------------------
    def _fanout(self, rid):
        """The subscription the router plants on the replica — ALWAYS
        planted, even for fire-and-forget submits, so the owner map
        retires exactly when the engine does."""

        def emit(ev):
            if ev["type"] == "token":
                with self._lock:
                    entry = self._entries.get(rid)
                if entry is not None:
                    entry.streamed = True
                    if entry.on_event is not None:
                        entry.on_event(ev)
                return
            # terminal: refresh this replica's published summary (we
            # are ON its stepper thread — the one safe place), then
            # either resubmit or retire + forward
            with self._lock:
                entry = self._entries.get(rid)
            if entry is None:
                return
            if ev.get("reason") == "engine_error":
                if self._resubmit(rid, entry, ev):
                    return              # stream continues elsewhere
            else:
                self._refresh_summary(entry.replica)
            self._drop_entry(rid)
            if entry.on_event is not None:
                entry.on_event(ev)

        return emit

    def _refresh_summary(self, i):
        """Refresh pool slot i's published prefix summary after a
        terminal, on that replica's stepper thread (the one safe place
        to touch its allocator). Incremental when the engine's bounded
        delta log still covers our cached version — replay only the
        keys that entered/left the index since — and a full
        ``prefix_index_summary()`` walk when the log aged out, the
        engine predates the delta API, or this is the first terminal."""
        eng = self.steppers[i].engine
        delta_fn = getattr(eng, "prefix_index_delta", None)
        # slot i's version is only written from THIS stepper thread
        # (terminal fanout is serialized per replica), so the unlocked
        # read cannot race a writer
        since = self._summary_versions[i]
        if delta_fn is not None and since is not None:
            got = delta_fn(since)
            if got is not None:
                version, ops = got
                with self._lock:
                    cur = set(self._summaries[i])
                    for added, key in ops:
                        if added:
                            cur.add(key)
                        else:
                            cur.discard(key)
                    self._summaries[i] = frozenset(cur)
                    self._summary_versions[i] = version
                    self.summary_delta_refreshes += 1
                    self.summary_keys_replayed += len(ops)
                return
        publish = getattr(eng, "prefix_index_summary", None)
        if publish is None:
            return
        summary = publish()
        version_fn = getattr(eng, "prefix_index_version", None)
        version = version_fn() if version_fn is not None else None
        with self._lock:
            self._summaries[i] = summary
            self._summary_versions[i] = version
            self.summary_full_refreshes += 1

    def _resubmit(self, rid, entry, ev):
        """A replica died under this request. Queued (never-streamed)
        requests move to a survivor transparently — a fresh request
        object (the dead engine mutated the original) under the same
        id, same subscription. Streamed ones forward the structured
        failure: their partial KV died with the replica. Returns True
        when the stream was rerouted (the terminal must be
        swallowed)."""
        with self._lock:
            self._drained.add(entry.replica)
            live = [i for i in range(len(self.steppers))
                    if i not in self._drained]
            _metrics.router_replicas_live().set(len(live))
            if entry.streamed or not live:
                return False
            target = min(live, key=lambda i: (self._inflight[i], i))
            self._inflight[entry.replica] -= 1
            _metrics.router_replica_inflight().labels(
                replica=str(entry.replica)).set(
                    self._inflight[entry.replica])
            self._inflight[target] += 1
            _metrics.router_replica_inflight().labels(
                replica=str(target)).set(self._inflight[target])
            entry.replica = target
        from ..incubate.nn import GenerationRequest
        clone = GenerationRequest(
            entry.spec["prompt"], entry.spec["max_new_tokens"],
            request_id=rid, priority=entry.spec["priority"],
            deadline_steps=entry.spec["deadline_steps"],
            deadline_s=entry.spec["deadline_s"],
            spec_k=entry.spec["spec_k"],
            temperature=entry.spec["temperature"])
        _metrics.router_resubmits().labels(replica=str(target)).inc()
        _tracing.get_tracer().event(
            "resubmit", request=rid, replica=target,
            reason="engine_error")
        fut = self.steppers[target].submit(
            clone, on_event=self._fanout(rid))
        fut.add_done_callback(
            lambda f: self._forget_if_failed(rid, f))
        return True
