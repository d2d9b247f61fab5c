"""Continuous-batching serving over the paged KV cache (PyTorch port;
copied from ``paddle_tpu/incubate/nn/continuous_batching.py`` and pointed
at the port's ``FusedMultiTransformerEngine``).

The scheduler is host code and unchanged. What differs from the JAX
module: one ``torch.Generator`` seeded from ``seed`` replaces the PRNG
key chain (the step draws from it when sampling); the step's tokens come
back as a device tensor and are read with ``.cpu()``; the engine's paged
programs run eagerly and update the caches in place; under
tensor-parallel serving (an engine built with ``tp > 1`` over a
``torch.distributed`` group) this scheduler runs on rank 0 alone and the
engine broadcasts each program to the other ranks (inference/tp_worker);
the autotune cache is the port's own (``ops.autotune``: ``pack`` and
``prefill_chunk`` as in JAX, read once at construction).

The vLLM-style serving loop the ROADMAP's "heavy traffic from millions of
users" regime needs: requests of wildly different lengths share one fixed
pool of cache blocks; a host-side free-list allocator hands blocks to
sequences as they grow and reclaims them the step a request finishes, and
every step runs ALL in-flight requests — some consuming whole CHUNKS of
their prompt (Sarathi-style chunked prefill under a per-step token
budget, so TTFT costs ceil(prompt/chunk) steps instead of prompt steps),
some mid-generation, some slots idle — as ONE step program
(FusedMultiTransformerEngine._paged_step over the ragged paged-attention
kernel, ops/paged_attention.py).

Speculative multi-token decode rides the same query-span work list: a
model-free prompt-lookup proposer (`propose_draft_tokens` — match the
generated suffix's last n-gram against the prompt + everything emitted
so far, zero extra model passes) drafts up to `spec_k` continuation
tokens per decode slot; the scheduler grants those slots a 1+K span as
OPTIONAL FILLER after the mandatory decode-1 and prefill chunks, the
compiled step verifies the whole span in one pass (the ragged kernel's
intra-chunk causal mask makes position j's sample exactly the
sequential decode's choice), and the host accepts the longest matching
prefix — token-exact vs non-speculative greedy decoding by
construction. Rejected suffixes roll back through a paged-KV rewind
(host block free + `truncate_paged_kv_cache` zeroing), so the cache
stays bit-identical to a never-speculated one.

Host/device split: the allocator, block tables, lengths, and scheduling
live on the host (tiny int arrays, zero device round trips beyond the
step itself); the device program's shape is keyed only by the bucketed
work-list length, so admission and retirement never trigger recompiles
past the first few power-of-two buckets.

Resilience (ISSUE 11): the engine degrades instead of crashing.
Requests carry a priority class, optional step/wall deadlines, and can
be cancelled mid-flight; when an allocation or admission cannot be
satisfied the scheduler preempts the lowest-priority victim TO BLOCKS
(KV pages freed, request re-queued — with the prefix cache on, its
published blocks make re-prefill mostly a block-table copy) and
`kv_alloc_failure` is a per-request failure only when no victim
exists; pressure-aware admission sheds the lowest-priority queued work
when the SLO engine is burning budget or HBM headroom collapses. Every
request ends with a structured terminal status (`RequestResult`) in
`engine.finished`; survivors stay token-exact by construction (each
slot's tokens depend only on its own KV under greedy decoding).

Reference bar: vLLM's continuous batching scheduler + "Ragged Paged
Attention" (PAPERS.md); the reference framework's analogue is the
block_multihead_attention serving stack.
"""
import collections
import os
import time

import numpy as np

from ...core.random import make_generator
from ...observability import instrument as _metrics
from ...observability import tracing as _tracing
from ...ops.paged_attention import (RaggedWorkBuilder, build_ragged_work,
                                    default_pack, next_pow2)

__all__ = ["BlockAllocator", "GenerationRequest", "RequestResult",
           "KVAllocFailure", "ContinuousBatchingEngine",
           "propose_draft_tokens", "block_key", "prompt_block_keys"]


class KVAllocFailure(RuntimeError):
    """The KV pool (free list AND reuse pool) could not produce a
    block. A RuntimeError subclass so pre-existing `except
    RuntimeError` / pytest.raises(RuntimeError) callers keep working,
    but the engine's preemption/degradation backstop catches THIS type
    only — a device-side RuntimeError (CUDA OOM, a failed kernel
    launch) escaping a step call must surface, not be misread as an
    allocation failure and silently demoted to a per-request error."""


def block_key(parent, tokens):
    """Chained content identity of one FULL cache block: structurally
    `(parent_key, tuple(token ids))`, root parent None. Nested tuples
    share structure with the parent key (O(1) extra memory per block)
    and compare by VALUE, so two requests that filled a block with the
    same tokens after the same prefix get the same key with zero
    hash-collision risk — the chain makes position implicit, so an
    identical token window at a different prefix depth gets a different
    key (its KV really is different: rope positions and attention
    context differ)."""
    return (parent, tuple(int(t) for t in tokens))


def prompt_block_keys(prompt_ids, block_size):
    """The chained key ladder of a prompt's FULL blocks — the same
    math admission hashes into ``req._prompt_keys``, exposed as a pure
    host-side function so a routing layer can compute a request's
    prefix identity WITHOUT an engine (the router matches this chain
    against each replica's published ``prefix_index_summary()``).
    Returns [] when the prompt doesn't cover one full block."""
    ks, k = [], None
    src = [int(t) for t in prompt_ids]
    for b in range(len(src) // block_size):
        k = block_key(k, src[b * block_size:(b + 1) * block_size])
        ks.append(k)
    return ks


def propose_draft_tokens(tokens, max_k, ngram=2):
    """Prompt-lookup (n-gram) draft proposal — the model-free speculative
    drafter: match the suffix's last `n` tokens (n = ngram down to 1)
    against every EARLIER position in `tokens` (prompt + generated), and
    propose the up-to-`max_k` tokens that followed the MOST RECENT match.
    Repetitive contexts (code, JSON, extraction, self-repeating greedy
    loops) hit constantly; zero model passes, zero state to shard.

    Host-side by design: pure python over the request's token list, the
    same place the scheduler already lives. Returns [] when nothing
    matches (the slot falls back to plain decode-1)."""
    if max_k <= 0:
        return []
    toks = list(tokens)
    n_tok = len(toks)
    for n in range(min(int(ngram), n_tok - 1), 0, -1):
        suffix = toks[n_tok - n:]
        # right-to-left: recency beats distance (the generated suffix is
        # a better predictor than a stale prompt occurrence)
        for start in range(n_tok - n - 1, -1, -1):
            if toks[start:start + n] == suffix:
                cont = toks[start + n:start + n + int(max_k)]
                if cont:
                    return cont
    return []


class BlockAllocator:
    """Refcounted free-list + content-addressed prefix index over the
    paged KV cache's physical blocks.

    Block ids [reserved, num_blocks) are allocatable; ids below `reserved`
    are parking space (idle batch slots point their table row at block 0
    so the one compiled step program can write SOMEWHERE harmless).

    Every held block carries a refcount: `alloc()` hands out rc=1,
    `share()`/`acquire()` bump it, `free()` decrements, and the block
    only leaves a request's hands when rc hits 0. A FULL, immutable
    block can be `register()`ed under its chained content key
    (`block_key`) into the hash->block index; a registered block whose
    refcount drops to 0 parks in an LRU reuse pool instead of the free
    list — still indexed, resurrectable by `acquire()` — and is only
    reclaimed (evicted from the index, oldest first) when the free list
    can't cover an `alloc()`. Allocation fails only when free list AND
    pool are both empty.

    Invariants (unit-tested directly): freeing a block nobody holds
    raises instead of corrupting the free list; `num_used` counts
    PHYSICAL blocks held by requests (pooled blocks are reusable cache,
    not in use) and is structurally non-negative; `high_water` tracks
    peak physical use — a block shared by 8 requests counts once."""

    # the exhaustion type, reachable from an allocator handle (fault
    # injectors raise `type(cb.allocator).OutOfBlocks` without an
    # import; the engine's degradation backstop catches exactly this)
    OutOfBlocks = KVAllocFailure

    # bounded prefix-index delta log: long enough to absorb every
    # register/evict between two consecutive summary refreshes on a
    # realistic workload; overflow just costs one full-walk rebuild
    INDEX_LOG = 128

    def __init__(self, num_blocks, reserved=1):
        if num_blocks <= reserved:
            raise ValueError(
                f"need more than {reserved} blocks (got {num_blocks})")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free = list(range(num_blocks - 1, reserved - 1, -1))
        self._free_set = set(self._free)  # O(1) double-free check
        self._ref = {}          # block -> refcount, held blocks only
        self._index = {}        # block_key -> physical block (full blocks)
        self._key_of = {}       # registered block -> its key
        self._pool = collections.OrderedDict()  # rc==0 but reusable, LRU
        self.high_water = 0     # max PHYSICAL blocks ever in use at once
        self.evictions = 0      # pooled blocks reclaimed for fresh allocs
        self.index_epoch = 0    # bumps on every index add/remove
        self._index_log = collections.deque(maxlen=self.INDEX_LOG)

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_pooled(self):
        return len(self._pool)

    @property
    def num_available(self):
        """Blocks an alloc() can still produce: free list + reclaimable
        pool — what admission reservations must check against."""
        return len(self._free) + len(self._pool)

    @property
    def num_used(self):
        """PHYSICAL blocks held by requests (rc >= 1). Pooled blocks are
        cache, not use; a block shared by N requests counts once."""
        return (self.num_blocks - self.reserved) - len(self._free) \
            - len(self._pool)

    @property
    def num_shared(self):
        """Physical blocks referenced by more than one request."""
        return sum(1 for rc in self._ref.values() if rc > 1)

    @property
    def num_registered(self):
        """Blocks resident in the prefix index (held or pooled)."""
        return len(self._index)

    def refcount(self, b):
        return self._ref.get(b, 0)

    def _bump_high_water(self):
        if self.num_used > self.high_water:
            self.high_water = self.num_used

    def alloc(self):
        if self._free:
            b = self._free.pop()
            self._free_set.discard(b)
        elif self._pool:
            # reclaim the LRU-oldest reusable prefix block BEFORE
            # failing: cached history is worth strictly less than a
            # live request's next token
            b, key = self._pool.popitem(last=False)
            del self._index[key]
            del self._key_of[b]
            self.index_epoch += 1
            self._index_log.append((False, key))
            self.evictions += 1
            _metrics.prefix_cache_evictions().inc()
        else:
            _metrics.kv_alloc_failures().inc()
            raise KVAllocFailure("BlockAllocator: out of cache blocks")
        self._ref[b] = 1
        self._bump_high_water()
        return b

    def free(self, blocks):
        for b in blocks:
            if not (self.reserved <= b < self.num_blocks):
                raise ValueError(f"freeing out-of-pool block {b}")
            rc = self._ref.get(b, 0)
            if rc < 1:
                where = ("already on the free list"
                         if b in self._free_set else
                         "parked in the reuse pool" if b in self._pool
                         else "never allocated")
                raise ValueError(
                    f"freeing unallocated block {b} ({where})")
            if rc > 1:
                self._ref[b] = rc - 1
                continue
            del self._ref[b]
            key = self._key_of.get(b)
            if key is not None:
                # registered: park, newest at the LRU tail, still
                # indexed — acquire() resurrects, alloc() reclaims
                self._pool[b] = key
            else:
                self._free.append(b)
                self._free_set.add(b)

    def share(self, b):
        """One more holder of a live block (copy-on-write bookkeeping)."""
        if self._ref.get(b, 0) < 1:
            raise ValueError(f"sharing unallocated block {b}")
        self._ref[b] += 1
        return b

    def register(self, b, key):
        """Publish a held, FULL, immutable block under its content key.
        First writer wins: returns False (no-op) when the key is already
        indexed by another block or the block already carries a key."""
        if self._ref.get(b, 0) < 1:
            raise ValueError(f"registering unallocated block {b}")
        if key in self._index or b in self._key_of:
            return False
        self._index[key] = b
        self._key_of[b] = key
        self.index_epoch += 1
        self._index_log.append((True, key))
        return True

    def lookup(self, key):
        """Index probe without side effects: block id or None."""
        return self._index.get(key)

    def index_keys(self):
        """Snapshot of every content key currently resolvable by
        ``acquire()`` — held blocks AND pooled (freed-but-registered)
        ones. This is the prefix-index summary a routing layer
        publishes: a router matching a prompt's block-key chain against
        it knows exactly which leading blocks this allocator can map
        without a prefill sweep."""
        return frozenset(self._index)

    def index_delta_since(self, epoch):
        """Ordered ``(added, key)`` ops replaying the prefix index from
        `epoch` to ``index_epoch``, or None when the bounded log no
        longer reaches back that far (caller rebuilds from
        ``index_keys()``). Replay is order-sensitive: a key can leave
        the index (LRU reclaim) and re-enter under a new block."""
        n = self.index_epoch - epoch
        if n < 0 or n > len(self._index_log):
            return None
        if n == 0:
            return self.index_epoch, ()
        log = list(self._index_log)
        return self.index_epoch, tuple(log[len(log) - n:])

    def acquire(self, key):
        """Index hit -> the physical block with its refcount bumped
        (resurrected from the reuse pool when no request holds it);
        miss -> None."""
        b = self._index.get(key)
        if b is None:
            return None
        rc = self._ref.get(b, 0)
        if rc == 0:
            del self._pool[b]
            self._ref[b] = 1
            self._bump_high_water()
        else:
            self._ref[b] = rc + 1
        return b


class RequestResult(list):
    """Terminal record of one request in ``engine.finished``: the
    generated token list (it IS a list, so everything that compares
    ``finished[rid]`` against plain token lists keeps working) plus the
    structured status the resilience layer records. ``status`` is one
    of STATUSES; ``reason`` the machine-readable cause (e.g.
    ``kv_alloc_failure``, ``slo_burn``); ``preemptions`` how many times
    the request was preempted-and-resumed on the way here. A live
    request additionally passes through the transient ``preempted``
    status while it waits in the queue for re-admission."""

    STATUSES = ("finished", "cancelled", "deadline_exceeded", "failed",
                "shed", "rejected")

    def __init__(self, tokens=(), status="finished", reason=None,
                 preemptions=0):
        super().__init__(int(t) for t in tokens)
        if status not in self.STATUSES:
            raise ValueError(f"unknown terminal status {status!r} "
                             f"(have {self.STATUSES})")
        self.status = status
        self.reason = reason
        self.preemptions = int(preemptions)

    def __repr__(self):
        extra = f", reason={self.reason!r}" if self.reason else ""
        return (f"RequestResult({list.__repr__(self)}, "
                f"status={self.status!r}{extra})")


class GenerationRequest:
    """One serving request: prompt ids in, up to max_new_tokens out.

    Resilience knobs (all optional):

    * ``priority`` — scheduling class, 0 = most important (the
      default). Admission runs in (priority, arrival) order; when the
      KV pool can't satisfy an allocation or a higher-priority
      admission, the NEWEST request of the strictly-lowest priority is
      preempted to blocks; pressure shedding removes the lowest class
      first (never below the engine's ``shed_priority_min``).
    * ``deadline_steps`` / ``deadline_s`` — retire the request (status
      ``deadline_exceeded``, partial tokens kept) once that many engine
      steps / monotonic seconds have passed since submit, whether it is
      queued or mid-flight.
    * ``spec_k`` — per-request cap on speculative draft length, at most
      the engine's own ``spec_k`` (a larger value is a structured
      rejection at submit: the sample-gather width is engine-static).
    * ``temperature`` — must match the engine's temperature when given;
      per-request sampling is not supported and is rejected at submit
      instead of corrupting the batch mid-step.
    """

    _next_id = 0

    def __init__(self, prompt_ids, max_new_tokens, request_id=None,
                 priority=0, deadline_steps=None, deadline_s=None,
                 spec_k=None, temperature=None):
        self.prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not self.prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        if request_id is None:
            request_id = GenerationRequest._next_id
            GenerationRequest._next_id += 1
        elif isinstance(request_id, int) and not isinstance(request_id, bool) \
                and request_id >= GenerationRequest._next_id:
            # a user-supplied int id RESERVES the auto counter past it, so
            # a later auto-assigned id can never silently collide with it
            GenerationRequest._next_id = request_id + 1
        self.request_id = request_id
        self.priority = int(priority)
        if self.priority < 0:
            raise ValueError("priority must be >= 0 (0 = most important)")
        self.deadline_steps = None if deadline_steps is None \
            else int(deadline_steps)
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError("deadline_steps must be >= 1")
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.spec_k = None if spec_k is None else int(spec_k)
        if self.spec_k is not None and self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.temperature = None if temperature is None \
            else float(temperature)
        if self.temperature is not None and self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        # lifecycle status: new -> queued -> running -> terminal
        # (RequestResult.STATUSES), with the transient `preempted`
        # between running and re-queued
        self.status = "new"
        self.status_reason = None
        self.preemptions = 0
        self._cancel = False    # processed at the next retire pass
        self._seq = None        # submission order (admission tie-break)
        self._admit_seq = None  # admission order (victim tie-break)
        self._submit_step = None
        # runtime state (owned by the engine)
        self.blocks = []        # physical cache blocks, in table order
        self.progress = 0       # prompt tokens consumed so far
        self.generated = []
        # prefill source/target: for a fresh request the prompt itself;
        # a preempted-and-resumed request re-prefills prompt + every
        # token it already emitted (the KV it lost), then decodes on
        self._prefill_src = self.prompt
        self._resume_len = len(self.prompt)
        # speculative-decode acceptance bookkeeping (engine-owned):
        # drafts proposed for / accepted by this request's verification
        self.spec_drafted = 0
        self.spec_accepted = 0
        # prefix-cache bookkeeping (engine-owned): prompt tokens whose KV
        # was MAPPED from shared blocks instead of prefilled, the chain
        # key after the blocks registered/matched so far, and how many
        # leading blocks that chain covers
        self.cached_prefix = 0
        self._prefix_key = None
        self._prompt_keys = None    # chained key per full prompt block
        self._registered = 0
        self._miss_frontier = -1    # last prompt position a miss counted at
        self._cow_reserve = 0       # shared blocks this request may yet COW
        # latency bookkeeping (host monotonic clock; set by the engine)
        self.submit_time = None
        self.admit_time = None
        self.first_token_time = None
        self._last_token_time = None
        # span timebase (perf_counter — the tracing/profiler clock, a
        # DIFFERENT epoch from time.monotonic above)
        self._submit_pc = None

    @property
    def done(self):
        return len(self.generated) >= self.max_new_tokens

    def total_tokens(self):
        return len(self.prompt) + self.max_new_tokens

    def blocks_needed(self, block_size):
        return -(-self.total_tokens() // block_size)


class ContinuousBatchingEngine:
    """Per-step admission / retirement scheduler over a
    FusedMultiTransformerEngine's paged decode mode.

    Each step():
      1. retire finished requests (free their blocks — eviction),
      2. admit queued requests into idle slots (FIFO; a request is only
         admitted when the free list can cover its WORST-CASE footprint,
         so no in-flight request can ever starve mid-generation),
      3. fill the per-step TOKEN BUDGET (Sarathi-style chunked prefill):
         decode-phase slots are mandatory at one token each, then the
         remaining budget is spent on prompt CHUNKS of up to
         `prefill_chunk` tokens from prefill-phase slots in slot order —
         a 512-token prompt costs ceil(512/chunk) steps, not 512,
      4. grow each active sequence's block list to cover the tokens the
         step appends (a chunk may cross several block boundaries),
      5. run one step over all slots: the whole mixed prefill+decode
         batch advances in ONE engine call over the ragged paged-
         attention kernel, and each slot samples from its chunk's last
         valid position.

    Greedy sampling (temperature 0) by default; temperature/top_p thread
    straight through to the engine's fused sampler.

    `prefill_chunk=1` reproduces the PR-1 one-token-per-step prefill
    exactly; `token_budget=None` means unthrottled (every prefill slot
    gets a full chunk each step). Chunking is token-exact either way.

    `spec_k > 0` turns on speculative multi-token decode (greedy only):
    each decode slot may be granted up to `spec_k` prompt-lookup draft
    tokens on top of its mandatory decode-1 — drafts are optional
    FILLER, granted only after every decode token and prompt chunk fit
    the budget — and the compiled step verifies the whole 1+K span in
    one pass. Accepted prefixes emit several tokens per step; rejected
    suffixes rewind the paged cache (block free + device-side zeroing),
    so generations stay token-exact vs `spec_k=0` and vs
    `engine.generate()`.

    `tpot_slo` (seconds, optional) arms the latency-SLO chunk
    controller: when the rolling mean of decode time-per-output-token
    exceeds the SLO, `prefill_chunk` shrinks one power-of-two bucket
    (never below `min_prefill_chunk`) — trading TTFT headroom for
    decode latency under load, the ROADMAP's "next scheduler lever".

    `prefix_cache=True` turns on automatic prefix caching: every FULL
    block a request commits (prompt or generated tokens) is published
    into a content-addressed index (`block_key` chains), and an
    incoming request's prompt is matched against it block by block —
    hits map the shared physical block straight into the block table
    and the scheduler only grants prefill chunks for the uncached
    suffix, so N requests sharing a system prompt pay ONE chunk sweep
    over it. Matching re-runs each step while a slot is mid-prefill
    (wavefront: a follower maps each block the step after its leader
    registers it) and the scheduler defers a slot whose next block an
    earlier slot is computing THIS step, so even concurrently-submitted
    duplicates dedup. Writes into a block other requests still read
    trigger copy-on-write (`_cow_block`); retired requests' registered
    blocks park in an LRU reuse pool that serves conversation-resume
    hits until the free list runs dry. Token-exact by construction:
    mapped KV is the same KV the request would have computed. Block-
    table contents are data, not shape — the bucketed (work-list,
    chunk-width) compile keys are untouched. Default OFF: the committed
    serving baselines predate the reuse pool's effect on the free-list
    gauges.

    `monitor` (optional, observability/slo.SLOMonitor) attaches the
    serving SLO engine: every step() ends with a host-side
    `monitor.tick()` — on the monitor's cadence that samples the
    metrics registry into windowed time-series rings and evaluates the
    declared objectives' multi-window burn rates (a breach counts into
    slo_breaches_total, lands on the timeline, and fires the flight
    recorder's `slo_burn_rate` trigger). Pure host math: token-exact-
    neutral with zero effect on the compile-bucket keyspace.

    `memory_watch` (optional, observability/memory.MemoryMonitor) is
    the device-resource counterpart: the same end-of-step tick()
    cadence drives HBM/census accounting gauges and the `hbm_pressure`
    flight trigger when headroom drops below the monitor's threshold —
    the OOM black box, armed next to the SLO engine. Host-side only,
    token-exact-neutral by the same construction.

    Resilience (ISSUE 11): requests carry a priority class and optional
    deadlines, `cancel()` retires them mid-flight through the normal
    block-free path, and allocation/admission pressure preempts the
    newest strictly-lower-priority victim TO BLOCKS (KV freed, request
    re-queued; with the prefix cache on its published blocks make
    re-prefill mostly a block-table copy, and resumption is token-exact
    under greedy decoding because each slot's tokens depend only on its
    own KV). `kv_alloc_failure` is a per-request failure — dump,
    structured `failed` status, serving continues — only when no victim
    exists. `shed_on_pressure=True` additionally lets the admission
    gate shed the lowest-priority queued class (priority >=
    `shed_priority_min`) while the attached SLO monitor reports burn-
    rate breaches or the memory watch reports HBM pressure. Every
    terminal path records a `RequestResult` (a list of the generated
    tokens + `status`/`reason`/`preemptions`) in `engine.finished`.
    All of it is host-side scheduling: work-list/slab shapes stay on
    the same bucketed compile treadmill, and default-config behavior
    (priority 0, no deadlines, shedding off) is bit-identical to the
    pre-resilience engine.

    Tensor-parallel serving: hand in an engine built with ``tp > 1``
    (on rank 0 of its group) and the SAME scheduler drives every rank —
    admission, chunk budgeting, spec accept/rewind, prefix matching, and
    preemption all compute once on rank 0, whose engine broadcasts each
    paged program to the followers (the paged KV cache and the ragged
    kernel shard over kv-heads; inference/tp_layout.py). The
    (work-list length, chunk width) bucket keys are untouched — zero new
    buckets after warmup holds per tp — and the scheduler additionally
    records the step's collective payload
    (``collective_bytes_total{op="all_reduce",axis="tp"}`` + a
    ``collective`` timeline span) and per-device KV-bytes gauges (1/tp of
    the single-device figure by construction). Token-exact vs the tp=1
    engine in every mode, pinned by tests/test_torch_tp_serving.py and
    the ``tp`` leg of tools/torch_serve_gates.py.
    """

    SLO_WINDOW = 8      # decode-TPOT samples per controller decision

    def __init__(self, engine, num_blocks, block_size, max_batch=8,
                 temperature=0.0, top_p=1.0, seed=0, prefill_chunk=64,
                 token_budget=None, spec_k=0, spec_ngram=2,
                 tpot_slo=None, min_prefill_chunk=64, prefix_cache=False,
                 monitor=None, memory_watch=None, shed_on_pressure=False,
                 shed_priority_min=1, autotune_cache=None,
                 host_fastpath=True, host_debug_check=False,
                 overlap_fetch=False):
        self.engine = engine
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.token_budget = None if token_budget is None \
            else int(token_budget)
        if self.token_budget is not None and self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.spec_k and float(temperature) > 0.0:
            # greedy verification accepts drafts that MATCH the argmax;
            # sampled decoding needs rejection sampling to stay unbiased
            # — not implemented, so refuse loudly instead of skewing the
            # output distribution
            raise ValueError(
                "speculative decoding (spec_k > 0) is greedy-only: "
                "temperature must be 0")
        self.spec_ngram = int(spec_ngram)
        if self.spec_k and self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if self.spec_k:
            # pin the acceptance-length histogram's bucket range to this
            # engine's spec_k (buckets bind on first creation)
            _metrics.spec_accept_len(max(8, self.spec_k))
        self.tpot_slo = None if tpot_slo is None else float(tpot_slo)
        if self.tpot_slo is not None and self.tpot_slo <= 0:
            raise ValueError("tpot_slo must be > 0 seconds")
        self.min_prefill_chunk = int(min_prefill_chunk)
        self._tpot_window = collections.deque(maxlen=self.SLO_WINDOW)
        self.max_blocks = engine.max_seq_len // self.block_size
        if self.max_blocks < 1:
            raise ValueError("block_size larger than engine.max_seq_len")
        self.allocator = BlockAllocator(num_blocks)
        self.caches = engine.new_paged_caches(num_blocks, self.block_size)
        self.tables = np.zeros((self.max_batch, self.max_blocks), np.int32)
        self.lens = np.zeros(self.max_batch, np.int32)
        self.slots = [None] * self.max_batch
        self.queue = collections.deque()
        self.finished = {}
        self._ids = set()       # queued + active ids: O(1) duplicate check
        self._temp = float(temperature)
        self._topp = float(top_p)
        self._gen = make_generator(int(seed), engine.device)
        self._step_count = 0
        # (padded work-list length, slab width) buckets seen so far: the
        # JAX engine compiles one step program per bucket, and the port
        # keeps the same host-deterministic keyspace and counter so the
        # two schedulers stay comparable step for step. A bucket outside
        # this set after warmup is the anomaly the contract forbids.
        self._seen_buckets = set()
        # declare_warm() flips this: a fresh bucket AFTER that is the
        # anomaly the flight recorder dumps on (admission recompiled)
        self._warm = False
        self._sched_info = {}
        # automatic prefix caching: content-addressed COW sharing of
        # full prompt/generation blocks across requests. OFF by default:
        # the committed serving baselines (step counts, free-pool
        # gauges) predate the reuse pool and must stay byte-stable.
        self._prefix_on = bool(prefix_cache)
        self._pending_stalls = set()
        # engine-local mirror of the prefix-cache counters (the process
        # registry aggregates across engines; tests and the bench want
        # THIS engine's numbers)
        self.cache_stats = {"hit_blocks": 0, "miss_blocks": 0,
                            "cow_copies": 0}
        # SLO monitor (observability/slo.SLOMonitor or anything with a
        # host-side tick()): sampled on a cadence from the end of every
        # step — pure host math over the registry, so it is token-exact-
        # neutral and touches no compile key by construction
        self.monitor = monitor
        # HBM/census accounting on the same tick cadence (memory.py
        # MemoryMonitor): gauges + the hbm_pressure flight trigger
        self.memory_watch = memory_watch
        # pressure-aware admission (OFF by default: the committed serve
        # baselines predate shedding): when the attached SLO monitor's
        # last evaluation breached, or the memory watch reported HBM
        # pressure, the admission gate sheds the lowest-priority queued
        # class (never below shed_priority_min — priority-0 work is not
        # sheddable by default) as a STRUCTURED rejection, before the
        # pool exhausts and preemption has to do it the hard way
        self.shed_on_pressure = bool(shed_on_pressure)
        self.shed_priority_min = int(shed_priority_min)
        if self.shed_priority_min < 0:
            raise ValueError("shed_priority_min must be >= 0")
        self._submit_counter = 0
        self._admit_counter = 0
        # tensor-parallel serving (engine built with tp > 1): the
        # scheduler stays on rank 0 alone — every decision above computes
        # once and the engine broadcasts each program to the followers —
        # but the step dispatch gains collective telemetry (the two
        # row-parallel all_reduces per layer, attributed analytically
        # through the comm-task path) and the pool gauges gain a
        # per-device bytes view (each rank holds 1/tp of every block's kv
        # heads). tp == 1 leaves ALL of it dormant.
        self._tp = int(getattr(engine, "tp", 1) or 1)
        self._comm_seconds = {}     # request id -> comm-window seconds
        self._comm_tasks = None
        if self._tp > 1:
            from ...distributed.comm_watchdog import comm_task_manager
            self._comm_tasks = comm_task_manager
            self._kv_dev_block_bytes = engine.kv_device_block_bytes(
                self.block_size)
            _metrics.serve_tp_degree().set(self._tp)
        # streaming fanout (ISSUE 12, the serving gateway's engine-side
        # half): host-side emission hooks, fired on the stepper thread.
        # `on_token(request_id, tokens, step)` fires for every committed
        # emission — the first token a finished prefill samples, and each
        # verified decode span (token + accepted drafts) — AFTER the
        # accept/rewind settled, so a hooked consumer never sees a token
        # the engine later takes back. `on_terminal(request_id, result)`
        # fires exactly once per request, whenever a RequestResult lands
        # in `finished` (finish/cancel/deadline/failure/shed/reject).
        # Pure host callbacks on host data: token-exact-neutral with
        # zero effect on the compile-bucket keyspace by construction.
        # Hooks must not raise — an exception propagates into step() (or
        # submit()) like any scheduler bug would.
        self.on_token = None
        self.on_terminal = None
        kvh = self.caches[0].shape[1]
        num_q = engine.num_heads
        self._pack = default_pack(self.max_batch, num_q // kvh)
        # the serving autotuner's winners (ops/autotune.py): a cache (path
        # or dict) opts the scheduler into the swept (pack, prefill_chunk)
        # of this EXACT shape class, resolved once here (no per-step host
        # work). The tuned chunk comes from the sweep's pow2 candidates, so
        # warm-up covers the same (t_total, c) buckets as ever; a missing,
        # broken, foreign or other-card cache leaves the values above.
        if autotune_cache is not None:
            from ...ops import autotune as _autotune
            cache_d = _autotune.load_serve_cache(
                autotune_cache, _autotune.card_of(engine.device))
            cfg = None
            if cache_d is not None:
                # the shape class of the whole engine: under tp the caches
                # hold each rank's kv-head shard
                kvh_all = kvh * self._tp
                cfg = _autotune.serve_winner(
                    cache_d, _autotune.serve_shape_class(
                        kvh_all, num_q // kvh_all, self.block_size,
                        engine.head_dim,
                        getattr(engine, "_dtype", "float32")))
            if cfg is not None:
                self._pack = max(1, min(int(cfg["pack"]), self.max_batch))
                self.prefill_chunk = max(1, int(cfg["prefill_chunk"]))
        # host fast path (ISSUE 20): incremental work lists + in-place
        # step inputs. Built AFTER autotune so the builder bakes in the
        # final pack. ON by default — every array it hands the compiled
        # step is elementwise identical to the from-scratch build (the
        # committed serving baselines stay byte-stable); OFF keeps the
        # legacy per-step-rebuild path alive as the reference the debug
        # cross-check and the host bench leg compare against.
        self._host_fastpath = bool(host_fastpath)
        self._host_debug = bool(host_debug_check) or bool(
            os.environ.get("PADDLE_TPU_HOST_DEBUG_CHECK"))
        # overlap is OPT-IN: it reorders token-independent host
        # bookkeeping (non-completing prefill advancement, stall
        # events, monitor/memory ticks) to before the token fetch, so
        # tick cadence sees last step's samples — token-exact (pinned
        # by serve_bench --host in every mode), but not span/metric-
        # order-identical, hence not the default
        self._overlap_fetch = bool(overlap_fetch)
        self._work_builder = RaggedWorkBuilder(
            self.max_batch, self.max_blocks, self.block_size,
            self._pack) if self._host_fastpath else None
        # persistent step-input buffers, keyed by the same bucketed
        # widths that key the compiles — steady state allocates nothing
        self._slab_bufs = {}        # c -> [B, c] int32
        self._sel_bufs = {}         # w_sel -> [B, w_sel] int32
        self._q_arr_buf = np.zeros(self.max_batch, np.int32)
        self._attn_buf = np.zeros(self.max_batch, np.int32)
        self._rw_old_buf = np.zeros(self.max_batch, np.int32)
        self._ztab_buf = None       # lazily: only prefix-on rewinds
        self._input_copy_bytes = 0  # engine-local mirror of the counter
        self._overlap_steps = 0
        self._last_host_phases = {}
        self._wb_last = (0, 0, 0, 0)    # registry-mirrored builder state

    def host_stats(self):
        """Engine-local host-fast-path accounting (the process registry
        aggregates across engines; tests and serve_bench want THIS
        engine's numbers): work-segment reuse/rebuild and assembly-mode
        counts from the work-list builder, step-input copy bytes,
        overlap-mode step count, and the last step's host-phase split
        in seconds."""
        wb = self._work_builder
        return {
            "fastpath": self._host_fastpath,
            "overlap": self._overlap_fetch,
            "segments_reused": wb.segments_reused if wb else 0,
            "segments_rebuilt": wb.segments_rebuilt if wb else 0,
            "assemblies_full": wb.assemblies_full if wb else 0,
            "assemblies_incremental":
                wb.assemblies_incremental if wb else 0,
            "input_copy_bytes": self._input_copy_bytes,
            "overlap_steps": self._overlap_steps,
            "phases": dict(self._last_host_phases),
        }

    # -- scheduling ---------------------------------------------------------

    def submit(self, request):
        # table capacity, NOT max_seq_len: when max_seq_len is not a
        # block multiple the table floor-divides down and the last
        # partial block's tokens are unreachable
        capacity = self.max_blocks * self.block_size
        if request.total_tokens() > capacity:
            raise ValueError(
                f"request {request.request_id}: {request.total_tokens()} "
                f"tokens exceeds the block-table capacity {capacity} "
                f"({self.max_blocks} blocks x {self.block_size})")
        if request.blocks_needed(self.block_size) > \
                self.allocator.num_blocks - self.allocator.reserved:
            raise ValueError(
                f"request {request.request_id} can never fit: needs "
                f"{request.blocks_needed(self.block_size)} blocks, pool "
                f"has {self.allocator.num_blocks - self.allocator.reserved}")
        rid = request.request_id
        # O(1): the live-id set tracks queued + active, `finished` keeps
        # the retired ones — no linear scan per submit
        if rid in self._ids or rid in self.finished:
            raise ValueError(f"duplicate request_id {rid}")
        # unsupported CONFIG combos are a structured per-request
        # rejection, not an exception: the caller that would have hit a
        # mid-step raise (or a silently skewed output distribution)
        # gets a terminal record instead, and the serve loop never sees
        # the bad request at all
        reason = self._reject_reason(request)
        if reason is not None:
            request.status = "rejected"
            request.status_reason = reason
            res = RequestResult((), status="rejected", reason=reason)
            self.finished[rid] = res
            _metrics.serve_rejected().labels(reason=reason).inc()
            _tracing.get_tracer().event(
                "reject", request=rid, status="rejected", reason=reason)
            if self.on_terminal is not None:
                self.on_terminal(rid, res)
            return "rejected"
        request.submit_time = time.monotonic()
        request._submit_pc = time.perf_counter()
        request._submit_step = self._step_count
        request._seq = self._submit_counter
        self._submit_counter += 1
        request.status = "queued"
        self.queue.append(request)
        self._ids.add(rid)
        _metrics.serve_queue_depth().set(len(self.queue))
        _tracing.get_tracer().event(
            "submit", request=rid, prompt_tokens=len(request.prompt),
            max_new_tokens=request.max_new_tokens,
            priority=request.priority)
        return "queued"

    def _reject_reason(self, request):
        """Submission-time screen for per-request knobs the engine
        cannot honor mid-flight. Reasons are a small FIXED label set
        (they feed a labeled counter — the GL112 contract)."""
        if request.temperature is not None \
                and request.temperature != self._temp:
            # the fused sampler takes ONE batch temperature; honoring a
            # different per-request value would re-key the compiled
            # step or skew every other slot's sampling stream
            return "temperature_override"
        # past this point any per-request temperature EQUALS the
        # engine's, so the speculation check reads the engine's
        k_req = request.spec_k
        if (k_req or 0) > 0 and self._temp > 0.0:
            # greedy verification only (engine-level spec_k>0 + temp>0
            # is already refused at construction; this is the
            # per-request echo of the same contract: speculation asked
            # of a sampling engine)
            return "spec_sampled"
        if k_req is not None and k_req > self.spec_k:
            # the sample-gather width W = 1 + engine.spec_k is static
            # per compiled bucket: a wider per-request span cannot be
            # verified without a fresh compile keyspace
            return "spec_k_exceeds_engine"
        return None

    @property
    def num_active(self):
        return sum(r is not None for r in self.slots)

    @property
    def tp(self):
        """Tensor-parallel width of the underlying engine's mesh."""
        return self._tp

    def device_kv_report(self):
        """Per-device paged-KV accounting for the mesh-aware health
        surfaces (gateway /healthz, serve_monitor --scrape): one row
        per device with its kv-head-shard byte figures. Single-chip
        engines report one device whose block bytes cover ALL kv
        heads, so the shape is uniform for consumers."""
        if self._tp > 1:
            per_block = self._kv_dev_block_bytes
        else:
            fn = getattr(self.engine, "kv_device_block_bytes", None)
            per_block = fn(self.block_size) if fn is not None else 0
        return [{
            "device": d,
            "kv_bytes_used": self.allocator.num_used * per_block,
            "kv_bytes_high_water": self.allocator.high_water * per_block,
            "kv_blocks_used": self.allocator.num_used,
        } for d in range(self._tp)]

    def prefix_index_summary(self):
        """The prefix-routing summary this replica publishes: the
        frozenset of chained block keys its allocator can currently
        map without a prefill sweep (empty when prefix caching is
        off). Read on the stepper thread that owns the engine — the
        router refreshes its cached copy from terminal fanout, which
        runs on exactly that thread."""
        if not self._prefix_on:
            return frozenset()
        return self.allocator.index_keys()

    def prefix_index_version(self):
        """Monotonic version of :meth:`prefix_index_summary`: bumps on
        every index add/evict. Pinned at 0 when prefix caching is off
        (the summary is the constant empty set)."""
        return self.allocator.index_epoch if self._prefix_on else 0

    def prefix_index_delta(self, since_version):
        """Incremental complement to :meth:`prefix_index_summary`: the
        new version plus the ordered ``(added, key)`` ops since
        `since_version`, or None when the allocator's bounded delta
        log has aged out (the caller falls back to the full summary
        walk). Same thread contract as the summary."""
        if not self._prefix_on:
            return 0, ()
        return self.allocator.index_delta_since(since_version)

    def _deadline_passed(self, req, now=None):
        if req.deadline_steps is not None \
                and req._submit_step is not None \
                and self._step_count - req._submit_step \
                >= req.deadline_steps:
            return True
        if req.deadline_s is not None and req.submit_time is not None:
            now = time.monotonic() if now is None else now
            if now - req.submit_time >= req.deadline_s:
                return True
        return False

    def _count_input_bytes(self, n):
        # the legacy per-step-rebuild path's copy bill: bytes freshly
        # allocated for compiled-step inputs. The fast path never calls
        # this — the "copy bytes drop to 0" half of the ISSUE-20 gate.
        self._input_copy_bytes += int(n)
        _metrics.serve_input_copy_bytes().inc(int(n))

    def _check_host_state(self, attn_lens, q_arr, work, t_total, pack):
        """Debug cross-check (host_debug_check=True, or the
        PADDLE_TPU_HOST_DEBUG_CHECK env var): the incremental work list
        must equal a from-scratch `build_ragged_work` over the same
        persistent tables/lens, elementwise including padding. A
        mismatch means a table-writing site forgot `_dirty_slot` — fail
        the step loudly instead of serving a stale block mapping."""
        ref, _, rtot, rpack = build_ragged_work(
            self.tables, attn_lens, self.block_size, self._pack,
            bucket_to=next_pow2, q_lens=q_arr)
        if rtot != t_total or rpack != pack or not all(
                np.array_equal(a, b) for a, b in zip(ref, work)):
            raise AssertionError(
                "host fast path diverged from the from-scratch "
                f"work-list rebuild at step {self._step_count}: a "
                "block-table mutation site is missing its _dirty_slot "
                "mark")

    def _dirty_slot(self, i):
        # slot i's block-table row just changed: its cached work-list
        # segment is stale. Every table-writing site funnels through
        # here (admit / prefix match / COW / grow / rewind / preempt /
        # retire) — the dirty-slot schedule the host bench leg pins.
        if self._work_builder is not None:
            self._work_builder.mark_dirty(i)

    def _finish_slot(self, i, status, reason=None):
        """Terminal retirement of slot i, whatever the cause: free its
        KV (registered blocks park in the prefix pool — the ISSUE-5
        rewind/free discipline; shared blocks just decref), clear the
        table row, and record the structured RequestResult. Every
        terminal path funnels through here so the allocator bookkeeping
        can't diverge between finish/cancel/deadline/failure."""
        req = self.slots[i]
        self.allocator.free(req.blocks)
        req.blocks = []
        self.slots[i] = None
        self.tables[i] = 0
        self.lens[i] = 0
        self._dirty_slot(i)
        req.status = status
        req.status_reason = reason
        res = RequestResult(
            req.generated, status=status, reason=reason,
            preemptions=req.preemptions)
        # comm attribution moves onto the terminal record: the live
        # dict must not grow one entry per request forever (explain()
        # falls back to the RequestResult after retirement)
        res.comm_s = self._comm_seconds.pop(req.request_id, 0.0)
        self.finished[req.request_id] = res
        self._ids.discard(req.request_id)
        _tracing.get_tracer().event(
            "retire", request=req.request_id, status=status,
            generated=len(req.generated),
            spec_drafted=req.spec_drafted,
            spec_accepted=req.spec_accepted)
        if self.on_terminal is not None:
            self.on_terminal(req.request_id, res)

    def _terminal_queued(self, req, status, reason=None):
        """Terminal record for a request that never (re)entered a slot
        this round: queued cancel/deadline/shed. Holds no blocks by
        construction (a preempted request gave its blocks back when it
        left its slot), so this is pure bookkeeping."""
        req.status = status
        req.status_reason = reason
        res = RequestResult(
            req.generated, status=status, reason=reason,
            preemptions=req.preemptions)
        res.comm_s = self._comm_seconds.pop(req.request_id, 0.0)
        self.finished[req.request_id] = res
        self._ids.discard(req.request_id)
        _metrics.serve_queue_depth().set(len(self.queue))
        if self.on_terminal is not None:
            self.on_terminal(req.request_id, res)

    def _retire(self):
        retired = 0
        now = time.monotonic()
        tr = _tracing.get_tracer()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.done:
                self._finish_slot(i, "finished")
                _metrics.serve_requests_total().inc()
                retired += 1
            elif req._cancel:
                _metrics.serve_cancelled().inc()
                tr.event("cancel", request=req.request_id,
                         status="cancelled",
                         generated=len(req.generated))
                self._finish_slot(i, "cancelled")
                retired += 1
            elif self._deadline_passed(req, now):
                _metrics.serve_deadline_exceeded().inc()
                tr.event("deadline_exceeded", request=req.request_id,
                         status="deadline_exceeded",
                         generated=len(req.generated),
                         deadline_steps=req.deadline_steps)
                self._finish_slot(i, "deadline_exceeded", "in_flight")
                retired += 1
        if retired:
            self._update_pool_gauges()

    def cancel(self, request_id):
        """Retire a request mid-flight. A queued request (including a
        preempted one awaiting re-admission) leaves immediately; an
        active request is flagged and retired at the top of the next
        step — its KV blocks go back to the pool through the same free
        path as normal retirement, so mid-speculation or mid-prefill
        state is reclaimed exactly. Terminal status `cancelled`, with
        whatever tokens were already generated. Returns True when the
        request was found live, False when it is unknown or already
        terminal. Host-thread API: call between steps, like submit()."""
        for req in self.queue:
            if req.request_id == request_id:
                self.queue.remove(req)
                _metrics.serve_cancelled().inc()
                _tracing.get_tracer().event(
                    "cancel", request=request_id, status="cancelled",
                    generated=len(req.generated))
                self._terminal_queued(req, "cancelled")
                return True
        for req in self.slots:
            if req is not None and req.request_id == request_id:
                req._cancel = True
                return True
        return False

    def _update_pool_gauges(self):
        _metrics.kv_blocks_free().set(self.allocator.num_free)
        _metrics.kv_blocks_used().set(self.allocator.num_used)
        _metrics.kv_blocks_high_water().set(self.allocator.high_water)
        _metrics.serve_inflight().set(self.num_active)
        _metrics.serve_queue_depth().set(len(self.queue))
        if self._prefix_on:
            _metrics.kv_blocks_shared().set(self.allocator.num_shared)
            _metrics.kv_blocks_prefix_resident().set(
                self.allocator.num_registered)
        if self._tp > 1:
            # per-device bytes view of the same pool: the allocator is
            # one flat host-side block-id space, every rank holds the
            # kv-head shard of every block, so the per-device figures are
            # symmetric by construction — surfaced per device so the
            # dashboard (/metrics, /healthz) shows every rank, not a
            # silently-device-0 number
            used = _metrics.kv_device_bytes_used()
            hw = _metrics.kv_device_bytes_high_water()
            used_b = self.allocator.num_used * self._kv_dev_block_bytes
            hw_b = self.allocator.high_water * self._kv_dev_block_bytes
            for d in range(self._tp):   # bounded by the group's size
                used.labels(device=str(d)).set(used_b)
                hw.labels(device=str(d)).set(hw_b)

    def _admission_pressure(self):
        """Shed signal for the admission gate: the attached SLO
        monitor's last burn-rate evaluation breached (PR 8), or the
        memory watch reported HBM pressure (PR 9). Returns the fixed
        reason label, or None when admission should run normally."""
        if not self.shed_on_pressure:
            return None
        rep = getattr(self.monitor, "last_report", None) \
            if self.monitor is not None else None
        if rep and rep.get("breaches", 0) > 0:
            return "slo_burn"
        mrep = getattr(self.memory_watch, "last_report", None) \
            if self.memory_watch is not None else None
        if mrep and mrep.get("pressure"):
            return "hbm_pressure"
        return None

    def _cull_queue(self):
        """Queued-side lifecycle pass before admission: drop requests
        whose deadline already passed (structured terminal record, not
        a wasted admission) and — under pressure — shed the lowest
        sheddable priority class."""
        if not self.queue:
            return
        now = time.monotonic()
        tr = _tracing.get_tracer()
        for req in [r for r in self.queue
                    if self._deadline_passed(r, now)]:
            self.queue.remove(req)
            _metrics.serve_deadline_exceeded().inc()
            # a preempted request can expire while re-queued: it still
            # carries the tokens it generated before eviction
            tr.event("deadline_exceeded", request=req.request_id,
                     status="deadline_exceeded",
                     generated=len(req.generated),
                     deadline_steps=req.deadline_steps)
            self._terminal_queued(req, "deadline_exceeded", "queued")
        reason = self._admission_pressure()
        if reason is None:
            return
        sheddable = [r for r in self.queue
                     if r.priority >= self.shed_priority_min]
        if not sheddable:
            return
        # one class per admission pass: shedding is a relief valve, not
        # a queue flush — the worst class goes first, the next only if
        # pressure persists into the next step
        worst = max(r.priority for r in sheddable)
        for req in [r for r in sheddable if r.priority == worst]:
            self.queue.remove(req)
            _metrics.serve_shed().labels(reason=reason).inc()
            tr.event("shed", request=req.request_id, status="shed",
                     reason=reason, priority=req.priority)
            self._terminal_queued(req, "shed", reason)

    def _pick_victim(self, below, exclude=None):
        """Preemption victim: the NEWEST-admitted active request of the
        strictly-lowest priority class below `below` (priority value
        strictly greater — equal classes never preempt each other, so
        two requests can't thrash swapping the same blocks). Returns
        the slot index or None."""
        best = None
        for j, r in enumerate(self.slots):
            if r is None or j == exclude or r.priority <= below:
                continue
            key = (r.priority, r._admit_seq or 0)
            if best is None or key > best[0]:
                best = (key, j)
        return None if best is None else best[1]

    def _preempt_slot(self, i, reason, q_lens=None, drafts=None):
        """Preempt slot i TO BLOCKS: free its KV pages (registered
        blocks park in the prefix reuse pool, so with the cache on its
        re-prefill is mostly a block-table copy), re-queue the request
        with its original arrival order (it sorts back to the front of
        its class), and cancel any work the current step had scheduled
        for it. The request keeps every token it generated; resumption
        re-prefills prompt + generated and decodes on, token-exact
        under greedy verification by construction."""
        req = self.slots[i]
        freed = len(req.blocks)
        self.allocator.free(req.blocks)
        req.blocks = []
        self.slots[i] = None
        self.tables[i] = 0
        self.lens[i] = 0
        self._dirty_slot(i)
        req.status = "preempted"
        req.preemptions += 1
        req.progress = 0
        req._cow_reserve = 0
        self.queue.append(req)
        if q_lens is not None:
            q_lens[i] = 0
        if drafts is not None:
            drafts.pop(i, None)
        self._sched_info.pop(i, None)
        _metrics.serve_preemptions().labels(reason=reason).inc()
        _tracing.get_tracer().event(
            "preempt", request=req.request_id, reason=reason,
            priority=req.priority, generated=len(req.generated),
            blocks_freed=freed)
        _tracing.get_flight_recorder().trigger(
            "preemption", request=req.request_id, preempt_reason=reason,
            step=self._step_count, priority=req.priority,
            blocks_freed=freed, generated=len(req.generated))
        self._update_pool_gauges()

    def _admit(self):
        # Priority admission with worst-case reservation: candidates in
        # (priority, arrival) order — all-default-priority traffic is
        # exactly the old FIFO — and a candidate is only admitted when
        # the pool covers its FULL footprint, so admitted requests
        # always finish. Matched shared blocks count as held
        # (len(r.blocks)), a mapped shared tail block keeps one COW
        # block reserved on top, and the pool side is num_available
        # because alloc() reclaims the LRU reuse pool before failing.
        # A blocked candidate first tries to preempt strictly-lower-
        # priority victims; if still blocked it blocks the line (no
        # lower-priority request may slip past and starve it).
        self._cull_queue()
        if not self.queue:
            return
        reserved = sum(
            r.blocks_needed(self.block_size) - len(r.blocks)
            + r._cow_reserve
            for r in self.slots if r is not None)
        for req in sorted(self.queue,
                          key=lambda r: (r.priority, r._seq or 0)):
            need = req.blocks_needed(self.block_size)
            slot_free = any(s is None for s in self.slots)
            # feasibility FIRST: preempting victim v raises admission
            # slack by exactly v.blocks_needed + v._cow_reserve (its
            # outstanding reservation returns AND its held blocks free)
            # — if even evicting every strictly-lower-priority victim
            # cannot cover the candidate, preempt NOBODY: destroying
            # in-flight work to still end up blocked buys nothing
            victims_gain = sum(
                r.blocks_needed(self.block_size) + r._cow_reserve
                for r in self.slots
                if r is not None and r.priority > req.priority)
            if reserved + need > self.allocator.num_available \
                    + victims_gain:
                # KV starvation no preemption can fix: the candidate is
                # blocked on pool capacity — the queue-wait outlier the
                # flight recorder's timeline should explain
                _tracing.get_tracer().event(
                    "admit_blocked", request=req.request_id,
                    blocks_needed=need, blocks_reserved=reserved,
                    blocks_free=self.allocator.num_free,
                    blocks_available=self.allocator.num_available)
                break
            if not slot_free:
                # every slot busy: a strictly-lower-priority victim
                # yields its SLOT (and its blocks) to the candidate —
                # otherwise a full batch of background work would
                # head-of-line-block front-door traffic forever
                victim = self._pick_victim(below=req.priority)
                if victim is None:
                    break
                vr = self.slots[victim]
                reserved -= (vr.blocks_needed(self.block_size)
                             - len(vr.blocks) + vr._cow_reserve)
                self._preempt_slot(victim, "admission")
            while reserved + need > self.allocator.num_available:
                # feasible by the check above: evict newest-lowest
                # until the candidate fits
                victim = self._pick_victim(below=req.priority)
                if victim is None:
                    break
                vr = self.slots[victim]
                reserved -= (vr.blocks_needed(self.block_size)
                             - len(vr.blocks) + vr._cow_reserve)
                self._preempt_slot(victim, "admission")
            if reserved + need > self.allocator.num_available:
                _tracing.get_tracer().event(
                    "admit_blocked", request=req.request_id,
                    blocks_needed=need, blocks_reserved=reserved,
                    blocks_free=self.allocator.num_free,
                    blocks_available=self.allocator.num_available)
                break
            i = min(i for i in range(self.max_batch)
                    if self.slots[i] is None)
            self.queue.remove(req)
            reserved += need
            req.blocks = []
            req.progress = 0
            req.cached_prefix = 0
            req._prefix_key = None
            req._registered = 0
            # resumption source: a fresh request prefills its prompt; a
            # preempted one re-prefills prompt + everything it already
            # emitted (the KV it gave back), then decode continues from
            # the exact token it was preempted at
            req._prefill_src = req.prompt if not req.generated \
                else req.prompt + [int(t) for t in req.generated]
            req._resume_len = len(req._prefill_src)
            if self._prefix_on:
                # the chained key ladder is a pure function of the
                # prefill source: hash it ONCE here so the per-step
                # scheduler dedup and wavefront probes index into it
                # instead of rehashing up to a chunk of tokens per slot
                # per step
                req._prompt_keys = prompt_block_keys(
                    req._prefill_src, self.block_size)
            req._miss_frontier = -1
            req._cow_reserve = 0
            req.status = "running"
            req._admit_seq = self._admit_counter
            self._admit_counter += 1
            req.admit_time = time.monotonic()
            if req.submit_time is not None:
                _metrics.serve_queue_wait().observe(
                    req.admit_time - req.submit_time)
            adm_pc = time.perf_counter()
            start_pc = req._submit_pc if req._submit_pc is not None \
                else adm_pc
            _tracing.get_tracer().record_span(
                "queue_wait", start_pc * 1e6, (adm_pc - start_pc) * 1e6,
                request=req.request_id, blocks_reserved=need)
            if req.preemptions:
                _tracing.get_tracer().event(
                    "resume", request=req.request_id,
                    generated=len(req.generated),
                    preemptions=req.preemptions)
            self.slots[i] = req
            self.tables[i] = 0
            self.lens[i] = 0
            self._dirty_slot(i)

    # -- automatic prefix caching -------------------------------------------

    def _extend_match(self, i):
        """Map full prompt blocks already in the prefix index straight
        into slot i's block table: those tokens' KV exists on some
        shared physical block, so the scheduler never grants them a
        prefill chunk. Runs at admission AND every step while the slot
        is block-aligned mid-prefill — the wavefront case: a follower
        whose prefix a leader is computing one chunk ahead maps each
        block the step after the leader registers it, paying zero model
        passes for the whole shared prefix.

        When the ENTIRE prompt is covered by index hits, the last token
        is handed back to the prefill scheduler anyway (its forward pass
        produces the first output token's logits); that one-token write
        lands INSIDE the shared tail block, which is exactly the
        copy-on-write trigger `_cow_block` resolves before the step
        writes. Returns the number of tokens newly mapped."""
        req = self.slots[i]
        bs = self.block_size
        src = req._prefill_src
        mapped = 0
        while True:
            p = req.progress
            if p % bs != 0 or p + bs > len(src):
                break
            key = req._prompt_keys[p // bs]
            blk = self.allocator.acquire(key)
            if blk is None:
                if p > req._miss_frontier:
                    # one miss per prompt position per request: the
                    # wavefront re-probes the same position every step
                    # until the leader registers it, which is not N
                    # misses
                    req._miss_frontier = p
                    self.cache_stats["miss_blocks"] += 1
                    _metrics.prefix_cache_misses().inc()
                break
            idx = len(req.blocks)
            req.blocks.append(blk)
            self.tables[i, idx] = blk
            self._dirty_slot(i)
            req._prefix_key = key
            req._registered += 1
            req.progress += bs
            self.lens[i] += bs
            mapped += bs
            self.cache_stats["hit_blocks"] += 1
            _metrics.prefix_cache_hits().inc()
        if mapped:
            if req.progress == req._resume_len:
                # whole prefill source cached: leave the LAST token to
                # the scheduler — sampling the next output token needs
                # its forward pass. progress stays mid-block, so the
                # write goes through COW on the shared tail block.
                req.progress -= 1
                self.lens[i] -= 1
                mapped -= 1
                req._cow_reserve = 1
            req.cached_prefix += mapped
            _tracing.get_tracer().event(
                "cache_hit", request=req.request_id, tokens=mapped,
                total=req.cached_prefix)
        return mapped

    def _cow_block(self, i, idx):
        """Copy-on-write: slot i must append into block-table entry
        `idx` but other holders still read the physical block there —
        duplicate it (one all-layer copy call on the engine) and
        retarget the slot at the private copy. The old block keeps its
        index registration and remaining holders; the copy is
        unregistered (its content is about to diverge)."""
        req = self.slots[i]
        old = req.blocks[idx]
        try:
            new = self.allocator.alloc()
        except KVAllocFailure:
            # admission reserved the COW footprint (_cow_reserve), so
            # this alloc cannot fail — if it does (a reservation bug,
            # an injected fault), leave the COW-specific evidence on
            # the timeline and re-raise to the step's grow guard, which
            # preempts a lower-priority victim or (with no victim)
            # demotes this to a per-request failure with a dump
            _tracing.get_tracer().event(
                "stall_alloc", request=req.request_id,
                blocks_held=len(req.blocks),
                blocks_free=self.allocator.num_free,
                cow_block_index=idx)
            raise
        self.caches = self.engine._paged_copy(
            self.caches, np.int32(old), np.int32(new))
        self.allocator.free([old])      # decref; other holders keep it
        req.blocks[idx] = new
        self.tables[i, idx] = new
        self._dirty_slot(i)
        req._cow_reserve = 0
        self.cache_stats["cow_copies"] += 1
        _metrics.prefix_cache_cow().inc()
        _tracing.get_tracer().event(
            "cow_copy", request=req.request_id, block_index=idx,
            src_block=old, dst_block=new)
        return new

    def _register_full_blocks(self, i):
        """Publish slot i's newly FULL blocks into the prefix index.
        Runs after the step's accept/rewind settled lens, so every
        registered block is immutable: its tokens are committed prompt
        or committed generations (a rejected speculative span can never
        have been registered). Generated tokens register too — that is
        the conversation-resume path: a follow-up request whose prompt
        embeds this reply maps these blocks straight from the index."""
        req = self.slots[i]
        bs = self.block_size
        full = int(self.lens[i]) // bs
        if full <= req._registered:
            return
        # token at position p is seq[p]: the prompt, then every
        # generated token except the newest (which has not been fed —
        # and so not appended — yet); lens never covers it
        seq = req.prompt + req.generated
        key = req._prefix_key
        for k in range(req._registered, full):
            key = block_key(key, seq[k * bs:(k + 1) * bs])
            self.allocator.register(req.blocks[k], key)
        req._prefix_key = key
        req._registered = full

    def _schedule_tokens(self, active):
        """Fill this step's token budget: decode-phase slots are
        MANDATORY (one token each — a decode can't be deferred without
        stalling its request and holding its blocks hostage), then the
        remaining budget is spent on prompt chunks of up to
        `prefill_chunk` tokens, slot order, and ONLY THEN — budget
        permitting — decode slots are topped up with speculative draft
        spans (up to `spec_k` prompt-lookup tokens each, capped so a
        fully-accepted span can never overshoot max_new_tokens — which
        also keeps the step inside the admission reservation's
        worst-case block footprint). Drafts being last keeps the
        bucketed (work-list length, chunk-width) compile keys warm:
        speculation never displaces mandatory work, it only fills slack.
        A prefill slot the budget can't reach gets 0 tokens and simply
        stalls this step (it costs zero work-list entries).

        Returns (q_lens [max_batch] int64, drafts {slot: token list})."""
        q_lens = np.zeros(self.max_batch, np.int64)
        drafts = {}
        used = 0
        decode_slots = []
        for i in active:
            req = self.slots[i]
            if req.progress >= req._resume_len:
                q_lens[i] = 1
                used += 1
                decode_slots.append(i)
        budget = self.token_budget
        self._sched_info = {}   # prefill slot -> (requested, granted)
        self._pending_stalls = set()
        pending = set()     # block keys being computed by a slot THIS step
        for i in active:
            req = self.slots[i]
            rem = req._resume_len - req.progress
            if rem <= 0:
                continue
            keys = []
            if self._prefix_on:
                # concurrent-duplicate dedup: the full blocks this
                # slot's chunk would complete, by content key. If an
                # earlier slot is already computing this slot's NEXT
                # block this very step, defer — next step's wavefront
                # match maps it for free instead of computing it twice.
                p = req.progress
                if p % self.block_size == 0:
                    lo = p // self.block_size
                    n_full = min(self.prefill_chunk, rem) \
                        // self.block_size
                    keys = req._prompt_keys[lo:lo + n_full]
                if keys and keys[0] in pending:
                    self._pending_stalls.add(i)
                    continue
            room = rem if budget is None else min(rem, max(0, budget - used))
            take = min(self.prefill_chunk, room)
            if keys and take:
                # publish only the blocks THIS grant completes: a
                # budget-truncated (or zero) chunk must not claim keys
                # it will not compute, or a follower would defer on a
                # block nobody fills this step (a budget stall would be
                # misreported as cache-pending dedup)
                pending.update(keys[:take // self.block_size])
            q_lens[i] = take
            used += take
            # requested = what an unthrottled budget would have granted;
            # the delta IS budget starvation, span-visible per chunk
            self._sched_info[i] = (min(self.prefill_chunk, rem), take)
        if self.spec_k:
            for i in decode_slots:
                req = self.slots[i]
                # per-request spec cap: a request may ask for SHORTER
                # draft spans than the engine's spec_k (submit()
                # rejected anything wider)
                k_cap = self.spec_k if req.spec_k is None \
                    else min(req.spec_k, self.spec_k)
                if k_cap <= 0:
                    continue
                # a span of 1+k emits at most k+1 tokens: cap k at
                # rem_gen-1 so acceptance can never exceed the request
                rem_gen = req.max_new_tokens - len(req.generated)
                room = rem_gen - 1 if budget is None \
                    else min(rem_gen - 1, budget - used)
                if room <= 0:
                    continue
                d = propose_draft_tokens(req.prompt + req.generated,
                                         min(k_cap, room),
                                         self.spec_ngram)
                if d:
                    drafts[i] = d
                    q_lens[i] += len(d)
                    used += len(d)
        return q_lens, drafts

    def _fail_slot(self, i, reason, q_lens, drafts):
        """Demote an unsatisfiable allocation from an engine crash to a
        per-request failure: dump the timeline (the kv_alloc_failure
        flight trigger — same evidence the old re-raise left, minus the
        dead process), record the structured terminal status, and hand
        the slot's blocks back. Only reached when no preemptible victim
        exists."""
        req = self.slots[i]
        tr = _tracing.get_tracer()
        tr.event("stall_alloc", request=req.request_id,
                 blocks_held=len(req.blocks),
                 blocks_free=self.allocator.num_free,
                 tokens_wanted=int(q_lens[i]))
        tr.event("request_failed", request=req.request_id,
                 status="failed", reason=reason)
        _tracing.get_flight_recorder().trigger(
            "kv_alloc_failure", request=req.request_id,
            step=self._step_count, blocks_free=self.allocator.num_free)
        _metrics.serve_failed().labels(reason=reason).inc()
        self._finish_slot(i, "failed", reason)
        q_lens[i] = 0
        drafts.pop(i, None)
        self._sched_info.pop(i, None)
        self._update_pool_gauges()

    def _grow_slot(self, i, q_lens, drafts):
        """COW + block-grow for the span slot i computes this step.
        Admission reserved the worst-case footprint, so the allocs here
        cannot fail in normal flow; when one DOES (a reservation bug,
        an injected fault), the scheduler preempts the newest strictly-
        lower-priority victim to blocks and retries — the step loses
        the victim's work this tick, nobody crashes — and only with no
        victim left does the request itself fail (per-request, with a
        kv_alloc_failure dump)."""
        while self.slots[i] is not None:
            req = self.slots[i]
            try:
                end = int(self.lens[i] + q_lens[i])
                if self._prefix_on and q_lens[i]:
                    # copy-on-write BEFORE the step writes: any
                    # existing block this step's span appends into that
                    # other holders still read gets a private copy (the
                    # whole-prompt-cached tail block is the natural
                    # case)
                    lo = int(self.lens[i]) // self.block_size
                    hi = (end - 1) // self.block_size
                    for idx in range(lo, min(hi + 1, len(req.blocks))):
                        if self.allocator.refcount(req.blocks[idx]) > 1:
                            self._cow_block(i, idx)
                    # the first write settled every sharing conflict
                    # this request can ever have (it only appends at
                    # its tail): release the admission-side COW
                    # reservation even when the other holder retired
                    # first and no copy was needed
                    req._cow_reserve = 0
                while len(req.blocks) * self.block_size < end:
                    blk = self.allocator.alloc()
                    req.blocks.append(blk)
                    self.tables[i, len(req.blocks) - 1] = blk
                    self._dirty_slot(i)
                return
            except KVAllocFailure:
                # the allocator's exhaustion type ONLY: a device-side
                # RuntimeError out of the COW copy dispatch must
                # propagate, not be demoted to a per-request failure
                victim = self._pick_victim(below=req.priority, exclude=i)
                if victim is None:
                    self._fail_slot(i, "kv_alloc_failure", q_lens,
                                    drafts)
                    return
                self._preempt_slot(victim, "kv_alloc", q_lens=q_lens,
                                   drafts=drafts)

    def step(self):
        """One scheduler tick + one compiled mixed prefill/decode step.
        Returns the number of requests still in flight (active +
        queued)."""
        t_begin = time.monotonic()
        pc_begin = time.perf_counter()
        tr = _tracing.get_tracer()
        self._retire()
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        self._update_pool_gauges()
        if not active:
            if self.monitor is not None:
                self.monitor.tick()     # keep sampling through idle ticks
            if self.memory_watch is not None:
                self.memory_watch.tick()
            return len(self.queue)
        if self._prefix_on:
            # admission + wavefront prefix matching: map every full
            # prompt block the index already holds before the scheduler
            # spends budget on it (a just-admitted slot matches its
            # whole resident prefix; a mid-prefill follower picks up
            # the block its leader registered last step)
            for i in active:
                req = self.slots[i]
                if req.progress < req._resume_len:
                    self._extend_match(i)
        q_lens, drafts = self._schedule_tokens(active)
        for i in active:
            self._grow_slot(i, q_lens, drafts)
        # preemption/failure may have vacated slots mid-grow: the rest
        # of the step only sees the survivors (their q_lens are zeroed,
        # their table rows parked)
        active = [i for i in active if self.slots[i] is not None]
        if not active:
            if self.monitor is not None:
                self.monitor.tick()
            if self.memory_watch is not None:
                self.memory_watch.tick()
            return len(self.queue) + self.num_active
        pc_sched = time.perf_counter()
        # token slab [B, C]: C is the widest span this step, bucketed to
        # a power of two (1 for an all-decode step) so slab shapes — and
        # the programs they key — stay off the per-prompt-length
        # treadmill. Idle slots and budget-starved prefill slots have
        # q_len 0: zero slab tokens, zero work entries, output ignored.
        # Fast path: per-width persistent buffers zero-filled in place —
        # a steady-state step allocates nothing (a fresh width keys a
        # fresh compile anyway, so buffer creation rides warmup).
        c = int(next_pow2(int(q_lens.max())))
        if self._host_fastpath:
            slab = self._slab_bufs.get(c)
            if slab is None:
                slab = np.zeros((self.max_batch, c), np.int32)
                self._slab_bufs[c] = slab
            else:
                slab.fill(0)
        else:
            slab = np.zeros((self.max_batch, c), np.int32)
            self._count_input_bytes(slab.nbytes)
        for i in active:
            req = self.slots[i]
            n = int(q_lens[i])
            if req.progress < req._resume_len:
                slab[i, :n] = \
                    req._prefill_src[req.progress:req.progress + n]
            elif n:
                # decode: last real token, then the speculative drafts
                # (if granted) — the step verifies the whole span
                slab[i, 0] = req.generated[-1]
                d = drafts.get(i)
                if d:
                    slab[i, 1:1 + len(d)] = d
        # sample-position gather [B, W]: the device projects/samples only
        # these slab columns, so lm_head cost is bounded by 1 + spec_k
        # per slot, not the chunk width. Prefill slots read one column
        # (the chunk-final position), decode slots their whole 1+K span;
        # padding repeats column 0 (computed, ignored). W is a pure
        # function of c and the engine-static spec_k, so the (t_total,
        # c) bucket pair still keys every compile.
        w_sel = min(c, 1 + self.spec_k)
        if self._host_fastpath:
            sel = self._sel_bufs.get(w_sel)
            if sel is None:
                sel = np.zeros((self.max_batch, w_sel), np.int32)
                self._sel_bufs[w_sel] = sel
            else:
                sel.fill(0)
        else:
            sel = np.zeros((self.max_batch, w_sel), np.int32)
            self._count_input_bytes(sel.nbytes)
        for i in active:
            req = self.slots[i]
            n = int(q_lens[i])
            if n == 0:
                continue
            if req.progress < req._resume_len:
                sel[i, 0] = n - 1
            else:
                sel[i, :n] = np.arange(n)
        if self._host_fastpath:
            # in-place step inputs: the persistent int32 views mutate
            # under np.copyto/np.add, and the work list assembles
            # incrementally — only slots the dirty schedule touched
            # rebuild their segments (RaggedWorkBuilder)
            q_arr = self._q_arr_buf
            q_arr[:] = q_lens
            attn_lens = self._attn_buf
            np.add(self.lens, q_arr, out=attn_lens)
            work, _, t_total, pack = self._work_builder.build(
                self.tables, attn_lens, q_arr)
            if self._host_debug:
                self._check_host_state(attn_lens, q_arr, work, t_total,
                                       pack)
        else:
            q_arr = q_lens.astype(np.int32)
            attn_lens = (self.lens + q_arr).astype(np.int32)
            work, _, t_total, pack = build_ragged_work(
                self.tables, attn_lens, self.block_size, self._pack,
                bucket_to=next_pow2, q_lens=q_arr)
            self._count_input_bytes(q_arr.nbytes + attn_lens.nbytes
                                    + sum(a.nbytes for a in work))
        # the (padded work-list length, slab width) pair is the ONLY
        # shape the scheduler varies step to step — a pair not seen
        # before keys a fresh compile of the step program
        # (host-deterministic, so tests can assert this counter stays
        # flat after warmup)
        if (t_total, c) not in self._seen_buckets:
            self._seen_buckets.add((t_total, c))
            _metrics.serve_bucket_recompiles().labels(
                bucket=f"{t_total}x{c}").inc()
            tr.event("bucket_compile", bucket=f"{t_total}x{c}",
                     warm=self._warm)
            if self._warm:
                # post-warmup recompile: admission leaked a new shape
                # into the compiled-step keyspace — the silent
                # multi-second stall PR 3 made a counter, now a dump
                _tracing.get_flight_recorder().trigger(
                    "post_warmup_recompile", bucket=f"{t_total}x{c}",
                    step=self._step_count)
        comm_task = None
        if self._comm_tasks is not None:
            # the TP step's per-layer all_reduces, attributed through the
            # comm-task path: payload bytes are pure shape math
            # (tp_step_comm_bytes — 2 all_reduces/layer over the [B, C, E]
            # partial activations), the window is the dispatch-to-fetch
            # span that CONTAINS the reduces, so the (all_reduce, tp)
            # bandwidth gauge is a floor and collective_bytes_total
            # attributes the comms cost exactly
            comm_task = self._comm_tasks.start_task(
                "all_reduce", group="tp",
                nbytes=self.engine.tp_step_comm_bytes(self.max_batch, c))
        pc_step = time.perf_counter()
        # tables/lens go in as the persistent scheduler arrays
        # themselves: the engine copies what it needs to the device
        # before it returns, so host mutation AFTER this call (the
        # overlap window below, next step's bookkeeping) can never race
        # the device read
        toks2, self.caches = self.engine._paged_step(
            self.engine._w, self.caches, slab, q_arr, sel,
            self.tables, self.lens, tuple(work),
            pack, np.float32(self._temp), np.float32(self._topp),
            self._gen)
        pc_disp = time.perf_counter()
        pc_ovl = pc_disp
        ticked = False
        emitted = 0
        rewinds = []    # (slot, new_end, old_end): rejected draft spans
        slot_spans = []  # (slot, request_id, span name, args) this step
        pre_done = set()    # slots the overlap window fully handled
        if self._overlap_fetch:
            # overlap window: host work that cannot depend on this
            # step's sampled tokens runs while the device executes —
            # starved-slot stall bookkeeping, prefill-chunk advancement
            # for chunks that do NOT complete their prompt (the prompt
            # is immutable; only the completing chunk samples a token),
            # and the monitor/memory tick cadence (which consequently
            # evaluates the PREVIOUS step's samples — the eager path
            # ticks after commit). Token-exact in every scheduler mode
            # (pinned by serve_bench --host): nothing here feeds the
            # accept/rewind loop.
            for i in active:
                req = self.slots[i]
                n = int(q_lens[i])
                if n == 0:
                    if req.progress < req._resume_len:
                        if i in self._pending_stalls:
                            tr.event("stall_cache_pending",
                                     request=req.request_id,
                                     prompt_remaining=req._resume_len
                                     - req.progress)
                        else:
                            tr.event("stall_budget",
                                     request=req.request_id,
                                     prompt_remaining=req._resume_len
                                     - req.progress,
                                     token_budget=self.token_budget)
                    pre_done.add(i)
                elif req.progress < req._resume_len \
                        and req.progress + n < req._resume_len:
                    requested, granted = self._sched_info.get(i, (n, n))
                    slot_spans.append(
                        (i, req.request_id, "prefill_chunk",
                         {"width": n, "granted": granted,
                          "requested": requested,
                          "progress": req.progress + n}))
                    self.lens[i] += n
                    req.progress += n
                    pre_done.add(i)
            if self.monitor is not None:
                self.monitor.tick()
            if self.memory_watch is not None:
                self.memory_watch.tick()
            ticked = True
            self._overlap_steps += 1
            pc_ovl = time.perf_counter()
        toks2 = toks2.cpu().numpy()    # [B, W]: a sample per sel column
        t_done = time.monotonic()
        pc_done = time.perf_counter()
        if comm_task is not None:
            # end AFTER the host read above synced the step: the
            # collective span covers real execution, not async enqueue
            self._comm_tasks.end_task(comm_task)
            comm_dur = comm_task.elapsed
            for i in active:
                if q_lens[i]:
                    rid = self.slots[i].request_id
                    self._comm_seconds[rid] = self._comm_seconds.get(
                        rid, 0.0) + comm_dur
        for i in active:
            if i in pre_done:
                continue        # settled in the overlap window above
            req = self.slots[i]
            n = int(q_lens[i])
            if n == 0:
                if req.progress < req._resume_len:
                    if i in self._pending_stalls:
                        # deferred on purpose: another slot is computing
                        # this slot's next block THIS step — next step's
                        # wavefront match maps it for free
                        tr.event("stall_cache_pending",
                                 request=req.request_id,
                                 prompt_remaining=req._resume_len
                                 - req.progress)
                    else:
                        # budget starvation: the prompt wanted a chunk
                        # and got zero work-list entries this step
                        tr.event("stall_budget", request=req.request_id,
                                 prompt_remaining=req._resume_len
                                 - req.progress,
                                 token_budget=self.token_budget)
                continue        # starved prefill slot: stalled this step
            if req.progress < req._resume_len:
                requested, granted = self._sched_info.get(i, (n, n))
                slot_spans.append((i, req.request_id, "prefill_chunk",
                                   {"width": n, "granted": granted,
                                    "requested": requested,
                                    "progress": req.progress + n}))
                self.lens[i] += n
                req.progress += n
                if req.progress == req._resume_len:
                    # the chunk ended the prompt: sel column 0 carried
                    # its last valid position — that sample is the
                    # request's FIRST output token
                    self._append_token(req, toks2[i, 0], t_done)
                    emitted += 1
            else:
                # decode: greedy-verify the drafted span (sel columns
                # 0..n-1 are slab positions 0..n-1). Column j's sample
                # is the model's choice after slab column j, so draft
                # d[a] (at slab column a+1) is accepted iff it EQUALS
                # sample a; the sample after the last accepted draft is
                # emitted too (it was computed against a fully-valid
                # prefix) — a+1 tokens out of one compiled step.
                d = drafts.get(i, [])
                k = len(d)               # n == 1 + k
                span = toks2[i, :n]
                a = 0
                while a < k and d[a] == int(span[a]):
                    a += 1
                self._append_span(req, span[:a + 1], t_done)
                emitted += a + 1
                slot_spans.append((i, req.request_id, "decode",
                                   {"emitted": a + 1, "drafted": k,
                                    "accepted": a}))
                old_end = int(self.lens[i]) + n
                new_end = int(self.lens[i]) + a + 1
                self.lens[i] = new_end
                if k:
                    req.spec_drafted += k
                    req.spec_accepted += a
                    _metrics.spec_draft_tokens().inc(k)
                    _metrics.spec_accepted_tokens().inc(a)
                    _metrics.spec_accept_len().observe(a)
                if new_end < old_end:
                    rewinds.append((i, new_end, old_end))
        blocks_freed = {}
        if rewinds:
            # device-side zeroing FIRST (it reads the table rows that
            # still point at the rejected positions), host block
            # rollback after; one engine call covers every slot,
            # spanning the same bucketed slab width as the step.
            #
            # Shared-block discipline: a rewound position inside a
            # block other requests still read must be COPIED, never
            # zeroed — a retained shared block gets a private COW copy
            # (the copy absorbs the zeroing), and a shared block the
            # rollback drops from this slot's table is merely
            # deref'd: its zero-write is retargeted at the reserved
            # parking block. The engine's append discipline makes both
            # cases unreachable in normal flow (drafts only ever land
            # in exclusively-held blocks), but the rewind must stay
            # safe against ANY sharing topology.
            ztab = self.tables
            if self._prefix_on:
                shared_drops = []
                for i, ne, oe in rewinds:
                    req = self.slots[i]
                    keep = -(-ne // self.block_size) if ne > 0 else 0
                    lo = ne // self.block_size
                    hi = (oe - 1) // self.block_size
                    for idx in range(lo, min(hi + 1, len(req.blocks))):
                        if self.allocator.refcount(req.blocks[idx]) > 1:
                            if idx < keep:
                                self._cow_block(i, idx)
                            else:
                                shared_drops.append((i, idx))
                if shared_drops:
                    if self._host_fastpath:
                        # persistent retarget scratch (lazy: only
                        # prefix-on rewinds with shared drops ever
                        # need a diverging table view)
                        if self._ztab_buf is None:
                            self._ztab_buf = self.tables.copy()
                        else:
                            np.copyto(self._ztab_buf, self.tables)
                        ztab = self._ztab_buf
                    else:
                        ztab = self.tables.copy()
                        self._count_input_bytes(ztab.nbytes)
                    for i, idx in shared_drops:
                        ztab[i, idx] = 0
            if self._host_fastpath:
                # persistent-buffer discipline (GL109 family): new_l IS
                # the settled lens array — the rewind reads it on the
                # host before returning — and old_l reuses one
                # preallocated scratch row
                new_l = self.lens
                old_l = self._rw_old_buf
                np.copyto(old_l, self.lens)
            else:
                new_l = self.lens.copy()
                old_l = self.lens.copy()
                self._count_input_bytes(new_l.nbytes + old_l.nbytes)
            for i, _, oe in rewinds:
                old_l[i] = oe
            self.caches = self.engine._paged_rewind(
                self.caches, ztab, new_l, old_l, c)
            for i, ne, _ in rewinds:
                blocks_freed[i] = self._rewind_blocks(i, ne)
            self._update_pool_gauges()
        if self._prefix_on:
            # AFTER accept/rewind settled lens: every newly-full block
            # is immutable now, publish it for other requests to map
            for i in active:
                self._register_full_blocks(i)
        # per-request lanes: every slot's work this step as one span
        # over the compiled-step window (the chunk widths, spec
        # accounting, and rewind block frees ride as args) — recorded
        # AFTER the rewind so blocks_freed is known
        for i, rid, name, args in slot_spans:
            if blocks_freed.get(i):
                args["blocks_freed"] = blocks_freed[i]
            tr.record_span(name, pc_step * 1e6,
                           (pc_done - pc_step) * 1e6, request=rid, **args)
        # span BEFORE the increment: its step label must match the
        # step= the flight-recorder triggers above stamped, so a dump's
        # context cross-references the right serve_step on the timeline
        dur = t_done - t_begin
        tr.record_span("serve_step", pc_begin * 1e6,
                       (pc_done - pc_begin) * 1e6, step=self._step_count,
                       work=t_total, chunk=c, emitted=emitted,
                       host_sched_us=int((pc_sched - pc_begin) * 1e6),
                       host_build_us=int((pc_step - pc_sched) * 1e6),
                       host_dispatch_us=int((pc_disp - pc_step) * 1e6),
                       host_overlap_us=int((pc_ovl - pc_disp) * 1e6),
                       host_fetch_us=int((pc_done - pc_ovl) * 1e6))
        self._step_count += 1
        _metrics.serve_step_seconds().observe(dur)
        if emitted:
            _metrics.serve_tokens_total().inc(emitted)
            _metrics.serve_tokens_per_s().set(
                emitted / dur if dur > 0 else 0.0)
        # set even at 0 (a prefill-bound step emits nothing): a stale
        # nonzero reading would overstate throughput exactly when the
        # engine is prompt-bound
        _metrics.serve_effective_tokens_per_step().set(emitted)
        self._maybe_shrink_chunk()
        if not ticked:
            # host-side cadence hooks: registry sample + burn-rate pass
            # when the monitor's cadence elapsed, a monotonic compare
            # otherwise — AFTER the step's own metrics landed, so a
            # breach evaluation always sees this step's samples (the
            # overlap window already ticked, one step behind, when
            # overlap_fetch is on)
            if self.monitor is not None:
                self.monitor.tick()
            if self.memory_watch is not None:
                # same cadence contract: HBM/census + hbm_pressure
                self.memory_watch.tick()
        pc_end = time.perf_counter()
        phases = {"schedule": pc_sched - pc_begin,
                  "build": pc_step - pc_sched,
                  "dispatch": pc_disp - pc_step,
                  "overlap": pc_ovl - pc_disp,
                  "fetch": pc_done - pc_ovl,
                  "commit": pc_end - pc_done}
        self._last_host_phases = phases
        hp = _metrics.serve_host_phase_seconds()
        hp.labels(phase="schedule").observe(phases["schedule"])
        hp.labels(phase="build").observe(phases["build"])
        hp.labels(phase="dispatch").observe(phases["dispatch"])
        hp.labels(phase="overlap").observe(phases["overlap"])
        hp.labels(phase="fetch").observe(phases["fetch"])
        hp.labels(phase="commit").observe(phases["commit"])
        wb = self._work_builder
        if wb is not None:
            # registry mirror of the builder's monotonic counters: inc
            # by this step's delta so the process-wide families stay
            # exact sums across engines
            last = self._wb_last
            cur = (wb.segments_reused, wb.segments_rebuilt,
                   wb.assemblies_incremental, wb.assemblies_full)
            segs = _metrics.serve_work_segments()
            if cur[0] > last[0]:
                segs.labels(event="reused").inc(cur[0] - last[0])
            if cur[1] > last[1]:
                segs.labels(event="rebuilt").inc(cur[1] - last[1])
            asm = _metrics.serve_work_assemblies()
            if cur[2] > last[2]:
                asm.labels(mode="incremental").inc(cur[2] - last[2])
            if cur[3] > last[3]:
                asm.labels(mode="full").inc(cur[3] - last[3])
            self._wb_last = cur
        return len(self.queue) + self.num_active

    def _rewind_blocks(self, i, new_end):
        """Host half of the speculative rewind: shrink slot i's block
        list to cover `new_end` tokens, freeing (and zeroing out of the
        table) every block past that — the block-boundary case where a
        rejection hands cache capacity straight back to the pool. The
        device half (`truncate_paged_kv_cache`) already zeroed the
        rejected positions, so a freed-then-reallocated block carries no
        stale KV (a SHARED dropped block is the exception: its
        zero-write was retargeted at the parking block, because the
        remaining holders still read the content — freeing here just
        drops this slot's reference). Returns the number of blocks
        handed back."""
        req = self.slots[i]
        need = -(-new_end // self.block_size) if new_end > 0 else 0
        freed = 0
        while len(req.blocks) > need:
            blk = req.blocks.pop()
            self.tables[i, len(req.blocks)] = 0
            self._dirty_slot(i)
            self.allocator.free([blk])
            freed += 1
        return freed

    def _maybe_shrink_chunk(self):
        """Latency-SLO chunk controller: when the rolling mean of decode
        TPOT exceeds the SLO, shrink `prefill_chunk` one power-of-two
        bucket (256 -> 128 -> 64 -> ... -> min_prefill_chunk) — prefill
        chunks are the schedulable knob, decode-1 is mandatory. The
        window clears on every shrink so each decision sees only
        post-shrink samples (a cooldown, not a ratchet)."""
        if self.tpot_slo is None:
            return
        if len(self._tpot_window) < self.SLO_WINDOW:
            return
        mean = sum(self._tpot_window) / len(self._tpot_window)
        if mean > self.tpot_slo:
            # the breach itself is flight-recorder-worthy even when the
            # controller has no chunk left to give back
            _tracing.get_flight_recorder().trigger(
                "tpot_slo_breach", tpot_mean_s=mean, slo_s=self.tpot_slo,
                prefill_chunk=self.prefill_chunk)
            if self.prefill_chunk > self.min_prefill_chunk:
                self.prefill_chunk = max(self.min_prefill_chunk,
                                         self.prefill_chunk // 2)
                _metrics.serve_prefill_chunk().set(self.prefill_chunk)
            # clear on EVERY breach, not just shrinks: each decision
            # sees only fresh samples, and a sustained breach at
            # min_prefill_chunk re-triggers once per full window (plus
            # the recorder's per-reason cooldown) instead of every step
            # — spamming flight_trigger events would evict the very
            # request spans a dump exists to keep
            self._tpot_window.clear()

    def _append_token(self, req, tok, now):
        """Record one generated token + its latency sample: the first
        token of a request closes its TTFT window (submit -> token),
        every later one is a time-per-output-token interval."""
        req.generated.append(int(tok))
        if req.first_token_time is None:
            req.first_token_time = now
            if req.submit_time is not None:
                _metrics.serve_ttft().observe(now - req.submit_time)
                _tracing.get_tracer().event(
                    "first_token", request=req.request_id,
                    ttft_s=now - req.submit_time)
        elif req._last_token_time is not None:
            _metrics.serve_tpot().observe(now - req._last_token_time)
        req._last_token_time = now
        if self.on_token is not None:
            self.on_token(req.request_id, [int(tok)], self._step_count)

    def _append_span(self, req, toks, now):
        """Record a verified decode span (the mandatory token + accepted
        drafts) with ONE latency interval: serve_tpot observes the
        span's effective per-token latency (interval / span length — a
        per-token loop would flood the histogram with zeros, every
        accepted draft landing at the same host timestamp), and the SLO
        controller window gets the FULL interval once, because the
        controller tracks step latency, which speculation does not
        shrink."""
        for t in toks:
            req.generated.append(int(t))
        if req.first_token_time is None:
            req.first_token_time = now
            if req.submit_time is not None:
                _metrics.serve_ttft().observe(now - req.submit_time)
                _tracing.get_tracer().event(
                    "first_token", request=req.request_id,
                    ttft_s=now - req.submit_time)
        elif req._last_token_time is not None:
            interval = now - req._last_token_time
            _metrics.serve_tpot().observe(interval / len(toks))
            self._tpot_window.append(interval)
        req._last_token_time = now
        if self.on_token is not None:
            self.on_token(req.request_id, [int(t) for t in toks],
                          self._step_count)

    def declare_warm(self):
        """Mark the compile-bucket warmup phase over: from here on, any
        FIRST SIGHTING of a (work-list length, chunk width) bucket is an
        anomaly — admission caused a recompile in steady state — and
        fires the flight recorder (`post_warmup_recompile`). Call after
        a representative warmup workload (the bench legs do) or once a
        production deployment has seen its traffic shapes."""
        self._warm = True

    def explain(self, request_id):
        """Per-request lifecycle digest from the span ring (TTFT, queue
        wait, chunk grants, stalls, spec accept rate) — the
        `request.explain()` view tools/request_trace.py renders from
        flight dumps, here served live. Spans are a bounded ring: a
        long-retired request may have aged out.

        Under tensor-parallel serving the digest additionally reports
        ``comm_s`` — the summed collective-bearing step windows this
        request was active in (the host-side attribution the per-step
        `collective` span records) — and the mesh width ``tp``."""
        out = _tracing.request_summary(request_id)
        # ISSUE 20: the engine's last-step host-phase split (seconds,
        # schedule/build/dispatch/overlap/fetch/commit) rides on every
        # digest — the live counterpart of the per-step `host` args the
        # serve_step spans carry into flight dumps
        out["host_phases"] = dict(self._last_host_phases)
        if self._tp > 1:
            out["tp"] = self._tp
            # live requests accumulate in the dict; terminal ones carry
            # their figure on the RequestResult (the dict entry is
            # popped at retirement so it cannot grow unboundedly)
            if request_id in self._comm_seconds:
                out["comm_s"] = self._comm_seconds[request_id]
            else:
                out["comm_s"] = getattr(
                    self.finished.get(request_id), "comm_s", 0.0)
        return out

    def run(self, max_steps=100000):
        """Drive step() until every submitted request has finished.
        Returns {request_id: generated token list}.

        step() already retires at the top of every tick, so the loop
        doesn't re-retire after each step; the one final _retire() flushes
        the requests the LAST step finished, so `finished` is complete
        when the queue drains."""
        steps = 0
        while self.queue or self.num_active:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("continuous batching did not converge "
                                   f"within {max_steps} steps")
        self._retire()
        return dict(self.finished)
