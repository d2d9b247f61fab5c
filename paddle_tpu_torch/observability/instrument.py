"""Standard instrument set of the serving path.

The well-known metric families every instrumented surface shares live
here as accessor functions, not cached handles: each call re-fetches the
family through the registry (two dict lookups under the lock — noise
next to a device step), so ``registry.reset()`` in a test can never
leave an instrumented module holding an orphaned family.

A copy of ``paddle_tpu/observability/instrument.py`` (stdlib only), kept
apart so the PyTorch package imports nothing of the JAX package. The
op-dispatch counter ``watch_ops`` hooks the JAX package's dispatch point
there; the port has none, so it counts torch-function calls through a
``torch.overrides.TorchFunctionMode`` instead (torch is imported only
when it is switched on).
"""
from .metrics import DEFAULT_LATENCY_BUCKETS, get_registry

__all__ = [
    "watch_ops", "serve_ttft", "serve_tpot", "serve_queue_wait",
    "serve_step_seconds", "dispatch_seconds", "serve_tokens_total",
    "serve_requests_total",
    "serve_inflight", "serve_queue_depth", "serve_tokens_per_s",
    "kv_blocks_free", "kv_blocks_used", "kv_blocks_high_water",
    "kv_alloc_failures", "serve_bucket_recompiles",
    "spec_draft_tokens", "spec_accepted_tokens", "spec_accept_len",
    "serve_effective_tokens_per_step", "serve_prefill_chunk",
    "prefix_cache_hits", "prefix_cache_misses", "prefix_cache_evictions",
    "prefix_cache_cow", "kv_blocks_shared", "kv_blocks_prefix_resident",
    "serve_preemptions", "serve_cancelled", "serve_shed",
    "serve_deadline_exceeded", "serve_failed", "serve_rejected",
    "gateway_request_seconds", "gateway_stream_seconds",
    "gateway_responses", "gateway_live_connections",
    "gateway_live_streams", "gateway_sse_pending_events",
    "gateway_sse_events", "gateway_health_transitions",
    "routed_requests", "router_affinity_hits", "router_affinity_misses",
    "router_resubmits", "router_replica_inflight",
    "router_replicas_live",
    "train_step_seconds", "train_tokens_total", "train_steps_total",
    "train_tokens_per_s", "train_host_seconds",
    "autotune_trials", "autotune_cache_hits", "autotune_cache_misses",
    "autotune_winner",
    "serve_host_phase_seconds", "serve_work_segments",
    "serve_work_assemblies", "serve_input_copy_bytes",
]


# -- serving (continuous-batching engine) --------------------------------

def serve_ttft():
    return get_registry().histogram(
        "serve_ttft_seconds",
        help="submit -> first generated token, per request")


def serve_tpot():
    return get_registry().histogram(
        "serve_time_per_output_token_seconds",
        help="interval between consecutive generated tokens, per slot")


def serve_queue_wait():
    return get_registry().histogram(
        "serve_queue_wait_seconds",
        help="submit -> admission into a batch slot, per request")


def serve_step_seconds():
    return get_registry().histogram(
        "serve_step_seconds",
        help="one scheduler tick + compiled decode step (host wall)")


def serve_host_phase_seconds():
    return get_registry().histogram(
        "serve_host_phase_seconds",
        help="host side of one serving step, split by phase: schedule "
             "(retire/admit/chunk grants/grow), build (slab/sel/work-"
             "list assembly), dispatch (compiled-step enqueue), overlap "
             "(token-independent host work hidden under device "
             "execution), fetch (block on sampled tokens), commit "
             "(accept/rewind/emission bookkeeping)",
        labels=("phase",))     # bounded: the six phases above


def serve_work_segments():
    return get_registry().counter(
        "serve_work_segments_total",
        help="per-slot ragged work-list segments per step, by outcome: "
             "reused (buffer entry already correct) vs rebuilt (slot "
             "dirtied by admit/grow/COW/rewind/preempt/retire)",
        labels=("event",))     # bounded: reused | rebuilt


def serve_work_assemblies():
    return get_registry().counter(
        "serve_work_assemblies_total",
        help="work-list assemblies by mode: incremental (layout + "
             "bucket unchanged, only dirty segments rewritten) vs full "
             "(re-laid out into the bucket buffer)",
        labels=("mode",))      # bounded: incremental | full


def serve_input_copy_bytes():
    return get_registry().counter(
        "serve_step_input_copy_bytes_total",
        help="bytes freshly allocated/copied for compiled-step inputs "
             "(slab, sel, work list, q/attn lens) — 0 in steady state "
             "on the host fast path, nonzero only on the legacy "
             "per-step-rebuild path")


def dispatch_seconds():
    return get_registry().histogram(
        "dispatch_seconds",
        help="compiled-program dispatch (trace/lower/compile on a fresh "
             "bucket + enqueue, NOT device completion), per program",
        labels=("program",))


def serve_tokens_total():
    return get_registry().counter(
        "serve_tokens_total", help="generated tokens")


def serve_requests_total():
    return get_registry().counter(
        "serve_requests_finished_total", help="requests retired")


def serve_inflight():
    return get_registry().gauge(
        "serve_inflight_requests", help="occupied batch slots")


def serve_queue_depth():
    return get_registry().gauge(
        "serve_queue_depth", help="submitted, not yet admitted")


def serve_tokens_per_s():
    return get_registry().gauge(
        "serve_tokens_per_s",
        help="tokens emitted by the last step / its host wall time")


def kv_blocks_free():
    return get_registry().gauge(
        "kv_blocks_free", help="allocatable cache blocks on the free list")


def kv_blocks_used():
    return get_registry().gauge(
        "kv_blocks_used", help="cache blocks held by in-flight requests")


def kv_blocks_high_water():
    return get_registry().gauge(
        "kv_blocks_high_water",
        help="max cache blocks ever simultaneously in use")


def kv_alloc_failures():
    return get_registry().counter(
        "kv_alloc_failures_total",
        help="BlockAllocator.alloc() calls that found an empty free list")


def serve_bucket_recompiles():
    return get_registry().counter(
        "serve_bucket_recompiles_total",
        help="first sighting of a padded work-list length (keys one "
             "XLA compile of the decode step)", labels=("bucket",))


# -- automatic prefix caching (content-addressed paged-KV sharing) -------

def prefix_cache_hits():
    return get_registry().counter(
        "serve_prefix_cache_hits_total",
        help="full prompt blocks mapped from the shared prefix index "
             "instead of prefilled (each hit skips block_size tokens "
             "of prefill compute)")


def prefix_cache_misses():
    return get_registry().counter(
        "serve_prefix_cache_misses_total",
        help="full prompt blocks probed against the prefix index and "
             "not found (counted once per prompt position per request)")


def prefix_cache_evictions():
    return get_registry().counter(
        "serve_prefix_cache_evictions_total",
        help="pooled prefix blocks reclaimed (LRU-oldest first) because "
             "the free list could not cover an allocation")


def prefix_cache_cow():
    return get_registry().counter(
        "serve_prefix_cache_cow_copies_total",
        help="copy-on-write block duplications: a request appended into "
             "a physical block other requests still read")


def kv_blocks_shared():
    return get_registry().gauge(
        "kv_blocks_shared",
        help="physical cache blocks referenced by more than one request")


def kv_blocks_prefix_resident():
    return get_registry().gauge(
        "kv_blocks_prefix_resident",
        help="physical blocks resident in the prefix index (held by "
             "requests or parked in the LRU reuse pool)")


# -- serving resilience (preemption / cancellation / shedding) -----------
# reason labels are drawn from small FIXED sets (the engine spells them
# as literals), never from request ids or prompt content — the GL112
# bounded-cardinality contract

def serve_preemptions():
    return get_registry().counter(
        "serve_preemptions_total",
        help="requests preempted to blocks (KV freed, request re-queued "
             "for prefix-cache-assisted re-prefill)", labels=("reason",))


def serve_cancelled():
    return get_registry().counter(
        "serve_requests_cancelled_total",
        help="requests retired mid-flight (or dequeued) by cancel()")


def serve_shed():
    return get_registry().counter(
        "serve_requests_shed_total",
        help="queued low-priority requests shed by pressure-aware "
             "admission before the KV pool exhausted", labels=("reason",))


def serve_deadline_exceeded():
    return get_registry().counter(
        "serve_requests_deadline_exceeded_total",
        help="requests retired at their step/wall deadline with a "
             "partial generation")


def serve_failed():
    return get_registry().counter(
        "serve_requests_failed_total",
        help="per-request failures that used to be engine crashes "
             "(kv_alloc_failure with no preemptible victim)",
        labels=("reason",))


def serve_rejected():
    return get_registry().counter(
        "serve_requests_rejected_total",
        help="requests rejected at submit() for unsupported config "
             "combos (structured, instead of a mid-step raise)",
        labels=("reason",))


# -- serving gateway (HTTP/SSE front door) -------------------------------
# every label value below comes from a small FIXED set the gateway
# spells as literals (route names, SSE event types, health states, HTTP
# codes the gateway itself emits) — the GL112 bounded-cardinality
# contract; per-request identity lives in spans, never in labels

def gateway_request_seconds():
    return get_registry().histogram(
        "gateway_request_seconds",
        help="HTTP request handling wall time (headers-in to "
             "response-flushed; SSE streams count separately)",
        labels=("route",))


def gateway_stream_seconds():
    return get_registry().histogram(
        "gateway_stream_seconds",
        help="SSE stream lifetime: headers sent -> terminal event "
             "flushed (or client gone)")


def gateway_responses():
    return get_registry().counter(
        "gateway_responses_total",
        help="HTTP responses by route and status code (codes are the "
             "gateway's own fixed set)", labels=("route", "code"))


def gateway_live_connections():
    return get_registry().gauge(
        "gateway_live_connections",
        help="TCP connections currently open against the gateway")


def gateway_live_streams():
    return get_registry().gauge(
        "gateway_live_streams",
        help="SSE token streams currently open")


def gateway_sse_pending_events():
    return get_registry().gauge(
        "gateway_sse_pending_events",
        help="SSE events queued for delivery but not yet written — "
             "sustained growth means a slow client (backpressure)")


def gateway_sse_events():
    return get_registry().counter(
        "gateway_sse_events_total",
        help="SSE events written, by event type (fixed set: "
             "accepted/token/end)", labels=("event",))


def gateway_health_transitions():
    return get_registry().counter(
        "gateway_health_transitions_total",
        help="/healthz state changes (ok <-> degraded)",
        labels=("to",))


# -- multi-replica router (data-parallel engine pool) --------------------
# `replica` is world-bounded (one value per pool slot, like `device`)
# and `policy` is the router's fixed literal set — GL112-safe.

def routed_requests():
    return get_registry().counter(
        "routed_requests_total",
        help="requests routed to a replica, by policy and pool slot",
        labels=("policy", "replica"))


def router_affinity_hits():
    return get_registry().counter(
        "router_affinity_hits_total",
        help="prefix-affinity routes that matched a replica's "
             "published prefix index (>= 1 leading block mapped free)")


def router_affinity_misses():
    return get_registry().counter(
        "router_affinity_misses_total",
        help="prefix-affinity routes that fell back to least-loaded "
             "(no index match, or the imbalance cap vetoed the match)")


def router_resubmits():
    return get_registry().counter(
        "router_resubmits_total",
        help="queued requests resubmitted to a survivor after their "
             "replica's step() crashed, by the SURVIVOR's pool slot",
        labels=("replica",))


def router_replica_inflight():
    return get_registry().gauge(
        "router_replica_inflight",
        help="requests the router currently has routed to each "
             "replica (submit -> terminal, queued + active)",
        labels=("replica",))


def router_replicas_live():
    return get_registry().gauge(
        "router_replicas_live",
        help="replicas currently accepting routes (pool size minus "
             "drained)")


# -- speculative decode (prompt-lookup drafts + budgeted verify) ---------

def spec_draft_tokens():
    return get_registry().counter(
        "spec_draft_tokens_total",
        help="prompt-lookup draft tokens handed to the verifier")


def spec_accepted_tokens():
    return get_registry().counter(
        "spec_accepted_tokens_total",
        help="draft tokens accepted by greedy verification "
             "(rate vs spec_draft_tokens_total = acceptance rate)")


def spec_accept_len(max_len=8):
    # acceptance lengths are small ints (0..spec_k); linear buckets so
    # the histogram reads as a per-length distribution, not latency.
    # The serving engine pins the bucket range at construction by
    # calling this with its spec_k (buckets bind on FIRST creation;
    # later calls return the existing family) — a spec_k=16 engine gets
    # distinguishable 9..16 lengths instead of one +Inf blob
    return get_registry().histogram(
        "serve_spec_accept_len",
        help="accepted-prefix length per verified draft span",
        buckets=tuple(float(i) for i in range(int(max_len) + 1)))


def serve_effective_tokens_per_step():
    return get_registry().gauge(
        "serve_effective_tokens_per_step",
        help="tokens emitted by the last compiled step (speculation "
             "pushes this above the decode-slot count)")


def serve_prefill_chunk():
    return get_registry().gauge(
        "serve_prefill_chunk",
        help="current prefill chunk size (the TPOT-SLO controller "
             "shrinks it one pow2 bucket when decode latency degrades)")


# -- tensor-parallel serving (kv-head-sharded paged cache) ---------------

def serve_tp_degree():
    return get_registry().gauge(
        "serve_tp_degree",
        help="tensor-parallel width of the serving engine's device "
             "mesh (1 = single-chip)")


def kv_device_bytes_used():
    # per-device children are bounded by the mesh topology (tp <=
    # device count), not by traffic — the same contract as the
    # shard_bytes/hbm_device_* families in observability/memory.py
    return get_registry().gauge(
        "kv_device_bytes_used",
        help="paged-KV cache bytes held by in-flight requests on each "
             "device's kv-head shard (blocks_used x per-device block "
             "bytes; drops by the TP factor vs single-chip)",
        labels=("device",))


def kv_device_bytes_high_water():
    return get_registry().gauge(
        "kv_device_bytes_high_water",
        help="peak per-device paged-KV bytes ever in use (the serve_tp "
             "gate asserts 1/tp of the single-chip figure)",
        labels=("device",))


# -- training (pretrain loop) --------------------------------------------

def train_step_seconds():
    return get_registry().histogram(
        "train_step_seconds",
        help="pretrain step dispatch wall time (async dispatch: excludes "
             "device completion unless the caller blocks)")


def train_tokens_total():
    return get_registry().counter(
        "train_tokens_total", help="tokens entering the train step")


def train_steps_total():
    return get_registry().counter(
        "train_steps_total", help="train steps dispatched")


def train_tokens_per_s():
    return get_registry().gauge(
        "train_tokens_per_s",
        help="batch tokens / host wall of the last dispatched step")


# -- training health (step-phase breakdown) ------------------------------
# the step splits into data-wait (loader) vs host (python between
# dispatches) vs dispatch (train_step_seconds above). The data-pipeline
# families (train_data_wait_seconds, train_data_batches_total,
# train_data_queue_depth, train_data_stalls_total) and the per-layer-
# group telemetry gauges + breach counter are OWNED by
# train_health.py — it needs per-test registries, which these
# process-registry accessors can't take

def train_host_seconds():
    return get_registry().histogram(
        "train_host_seconds",
        help="host wall between dispatches not spent waiting on data "
             "(optimizer bookkeeping, logging, sharding the batch)")


# -- kernel autotuning (ops/autotune.py) ---------------------------------

def autotune_trials():
    # the kernel label is the family prefix of the tune key (flash_bshd,
    # ragged_paged_attention, ...), never the shape-bearing key itself —
    # a handful of Pallas kernels exist, so the child set stays bounded
    return get_registry().counter(
        "autotune_trials_total",
        help="candidate kernel configs timed (device) or scored "
             "(analytic model) by the autotuner",
        labels=("kernel",))


def autotune_cache_hits():
    return get_registry().counter(
        "autotune_cache_hits_total",
        help="autotune winner-cache lookups that found an entry "
             "(engine-construction time only: the zero-per-step-cost "
             "contract)")


def autotune_cache_misses():
    return get_registry().counter(
        "autotune_cache_misses_total",
        help="autotune winner-cache lookups that fell back to defaults")


def autotune_winner():
    return get_registry().gauge(
        "autotune_winner_config",
        help="last swept winner's tunable values, one child per "
             "(kernel, param): pack / prefill_chunk / split_waves",
        labels=("kernel", "param"))


# -- op dispatch ----------------------------------------------------------

_op_mode = None


def watch_ops(enable=True):
    """Count every torch-function call of this thread into
    ``op_calls_total{op=...}``, the op named as
    ``torch.overrides.resolve_name`` names it ("torch.matmul",
    "torch.Tensor.add", ...): torch's names, not the JAX package's.
    Switching it on twice changes nothing; switching it off pops the mode
    and leaves the mode stack as it was before. The mode stack is
    thread-local, so the count covers the calling thread."""
    global _op_mode
    if enable:
        if _op_mode is not None:
            return
        from torch.overrides import TorchFunctionMode, resolve_name

        class _CountOps(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(),
                                   kwargs=None):
                name = resolve_name(func) or getattr(func, "__name__",
                                                     repr(func))
                get_registry().counter(
                    "op_calls_total", help="torch-function calls",
                    labels=("op",)).labels(op=name).inc()
                return func(*args, **(kwargs or {}))

        mode = _CountOps()
        mode.__enter__()
        _op_mode = mode
    elif _op_mode is not None:
        from torch.overrides import _get_current_function_mode_stack
        stack = _get_current_function_mode_stack()
        if not stack or stack[-1] is not _op_mode:
            raise RuntimeError("watch_ops(False): another torch function "
                               "mode was entered after watch_ops() and is "
                               "still active")
        _op_mode.__exit__(None, None, None)
        _op_mode = None
