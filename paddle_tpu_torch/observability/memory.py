"""Live-tensor census, device-memory accounting and the HBM-pressure trigger
of the PyTorch port (counterpart of ``paddle_tpu/observability/memory.py``).

The memory half of the cost / memory layer (``costs.py`` is the compute
half): WHERE the bytes are, not just how many the programs touch.

* ``live_array_census()`` — every live ``torch.Tensor`` the garbage
  collector tracks, grouped by ``dtype[shape]`` (or an owner tag
  registered via ``tag_arrays()``): {group: {count, bytes}}. The serving
  engine's leak contract rides on it: after submit / retire churn the
  census must return to its pre-admission state, because a leaked KV slab
  is invisible to the allocator's own block accounting. Views count their
  own shape's bytes (a view keeps its base alive).
* ``record_census()`` — a census into ``live_arrays{group}`` /
  ``live_array_bytes{group}`` gauges plus process totals with a
  high-water mark.
* ``device_memory()`` — on the card, per device from the allocator's
  statistics (``torch.cuda.memory_stats_as_nested_dict()``) and
  ``torch.cuda.mem_get_info()`` (read once):
  ``bytes_in_use`` is ``reserved_bytes.all.current`` (a block in
  PyTorch's caching allocator is memory no other process can have, so
  reserved, not allocated, is what runs the card out),
  ``peak_bytes_in_use`` ``reserved_bytes.all.peak``, ``bytes_limit`` the
  card's total. ``{}`` on the CPU (no device reports stats), where the
  census is the fallback, as on JAX's CPU.
* ``MemoryMonitor`` — per-device in-use / limit gauges and the
  ``hbm_pressure`` flight-recorder trigger: when headroom drops below
  ``min_headroom_frac`` of the budget, the span window + metrics
  snapshot dump fires, BEFORE the allocator starts failing. ``tick()``
  is cadence-gated so a serving engine can call it every step; on the
  card an accounting pass reads the allocator's counters and takes no
  census (microseconds, not a ``gc`` pass).
* ``shard_skew()`` — bytes per ``tensor.device`` of a pytree of tensors
  and the max / mean skew ratio (1.0 on one device).

Stdlib only at import (torch is touched lazily and its absence degrades
to empty censuses, so the bare-container selfcheck can exercise the
monitor with injected numbers), host-side only.
"""
import threading
import time
import weakref

from .metrics import get_registry
from .tracing import get_flight_recorder

__all__ = [
    "live_array_census", "census_diff", "record_census", "tag_arrays",
    "device_memory", "MemoryMonitor", "shard_skew",
]

# id(tensor) -> (weakref, owner tag): tags survive exactly as long as the
# tensor; a dead weakref drops out of the census grouping automatically
_tags = {}
_tags_lock = threading.Lock()


def tag_arrays(owner, arrays):
    """Attribute tensors to an owner for census grouping (weakrefs; the
    tag dies with the tensor)."""
    with _tags_lock:
        for a in arrays:
            try:
                ref = weakref.ref(a)
            except TypeError:
                continue
            _tags[id(a)] = (ref, str(owner))


def _tag_of(arr):
    with _tags_lock:
        ent = _tags.get(id(arr))
        if ent is None:
            return None
        ref, owner = ent
        live = ref()
        if live is None or live is not arr:
            del _tags[id(arr)]      # id reused by a different object
            return None
        return owner


def _gc_tags():
    with _tags_lock:
        dead = [k for k, (ref, _) in _tags.items() if ref() is None]
        for k in dead:
            del _tags[k]


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def live_array_census(collect=True):
    """{group: {"count": n, "bytes": b}} over the live tensors ``gc``
    tracks; group is the owner tag when registered, else
    ``dtype[shape]``. Returns {} without torch. ``collect=True`` runs a gc
    pass first so droppable references don't read as leaks."""
    try:
        import torch
    except Exception:
        return {}
    import gc
    if collect:
        gc.collect()
    _gc_tags()
    out = {}
    tensor = torch.Tensor
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which a
        # deprecated module attribute answers with a warning
        if not issubclass(type(obj), tensor):
            continue
        try:
            if obj.is_meta:
                continue
            key = _tag_of(obj) or f"{_dtype_name(obj)}{list(obj.shape)}"
            nbytes = int(obj.numel() * obj.element_size())
        except Exception:
            continue
        ent = out.setdefault(key, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += nbytes
    return out


def census_diff(before, after):
    """{group: {"count": delta, "bytes": delta}} for groups that
    changed — empty dict == no leak (the step-boundary contract)."""
    out = {}
    for key in set(before) | set(after):
        b = before.get(key, {"count": 0, "bytes": 0})
        a = after.get(key, {"count": 0, "bytes": 0})
        dc, db = a["count"] - b["count"], a["bytes"] - b["bytes"]
        if dc or db:
            out[key] = {"count": dc, "bytes": db}
    return out


def record_census(census=None, registry=None):
    """Land a census in the registry: per-group count / bytes gauges plus
    process totals with a high-water mark. ``census=None`` takes a live
    one (pass a dict to replay a synthetic census: the selfcheck path).
    Returns the census."""
    if census is None:
        census = live_array_census()
    reg = registry if registry is not None else get_registry()
    counts = reg.gauge("live_arrays",
                       help="live tensors by census group",
                       labels=("group",))
    sizes = reg.gauge("live_array_bytes",
                      help="bytes held by live tensors, by group",
                      labels=("group",))
    total_c = total_b = 0
    # census groups are dtype[shape] / owner-tag strings: bounded by the
    # program's own shape set (and stale groups are zeroed below)
    for key, ent in census.items():
        counts.labels(group=key).set(ent["count"])
        sizes.labels(group=key).set(ent["bytes"])
        total_c += ent["count"]
        total_b += ent["bytes"]
    # groups that vanished since the last census read 0, not their last
    # value (a freed KV cache must not look resident on every scrape)
    for fam in (counts, sizes):
        for key in list(fam._children):
            if key and key[0] not in census:
                fam.labels(group=key[0]).set(0)
    reg.gauge("live_arrays_total",
              help="live tensors in the process").set(total_c)
    reg.gauge("live_array_bytes_total",
              help="bytes held by all live tensors").set(total_b)
    reg.gauge("live_array_bytes_high_water",
              help="peak bytes ever held by live tensors "
                   "(census-time high-water)").set_max(total_b)
    return census


_card_total = {}      # device index -> total bytes (read once)


def device_memory():
    """Per-device memory of the card: {device: {"bytes_in_use":,
    "bytes_limit":, "peak_bytes_in_use":}} from PyTorch's allocator
    (reserved bytes, current and peak) and the card's total. {} without
    a card."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        n = torch.cuda.device_count()
    except Exception:
        return {}
    out = {}
    for i in range(n):
        try:
            # the nested form: memory_stats() flattens ~100 entries in
            # Python on every call, the bulk of a tick's cost
            reserved = torch.cuda.memory_stats_as_nested_dict(i).get(
                "reserved_bytes", {}).get("all", {})
            total = _card_total.get(i)
            if total is None:
                total = _card_total[i] = torch.cuda.mem_get_info(i)[1]
        except Exception:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(reserved.get("current", 0)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(reserved.get("peak", 0)),
        }
    return out


def shard_skew(tree, registry=None, group=None):
    """Bytes per device of a pytree of tensors (dicts, lists, tuples):
    sets ``shard_bytes{device}`` gauges and the ``shard_skew`` ratio (max
    device bytes / mean device bytes; 1.0 == balanced, and on one device).
    With ``group`` (a training mesh's world group; a collective, which
    every rank calls) each rank's bytes of its own tree are all_gathered
    over it and the devices are the ranks ("rank0", "rank1", ...): the
    mesh's bytes at rest per rank. Returns {"devices": {...}, "skew": r},
    or {} without torch or on an empty tree."""
    try:
        import torch
    except Exception:
        return {}

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        elif isinstance(x, torch.Tensor):
            yield x

    per_device = {}
    for t in leaves(tree):
        dev = str(t.device)
        per_device[dev] = per_device.get(dev, 0) + \
            int(t.numel() * t.element_size())
    if group is not None:
        from ..distributed import collective
        mine = torch.tensor([sum(per_device.values())], dtype=torch.int64,
                            device="cuda" if group.name() == "nccl"
                            else "cpu")
        parts = collective.all_gather([], mine, group=group)
        per_device = {f"rank{r}": int(p.item())
                      for r, p in enumerate(parts)}
    if not per_device:
        return {}
    reg = registry if registry is not None else get_registry()
    g = reg.gauge("shard_bytes",
                  help="bytes of the last skew-checked pytree resident "
                       "per device", labels=("device",))
    # device ids are the fixed hardware set, not traffic-scoped
    for dev, b in per_device.items():
        g.labels(device=dev).set(b)
    # devices absent from THIS pytree read 0, not their previous value
    for key in list(g._children):
        if key and key[0] not in per_device:
            g.labels(device=key[0]).set(0)
    mean = sum(per_device.values()) / len(per_device)
    skew = max(per_device.values()) / mean if mean > 0 else 0.0
    reg.gauge("shard_skew",
              help="max/mean per-device bytes of the last skew-checked "
                   "pytree (1.0 = balanced)").set(skew)
    return {"devices": per_device, "skew": skew}


class MemoryMonitor:
    """Cadence-gated device-memory accounting + pressure trigger (the
    SLOMonitor shape: construct once, ``tick()`` from the serve / train
    loop).

    ``budget_bytes`` is the accounting ceiling: the card's total when the
    device reports one, else whatever the caller declares (a CPU test
    budget, a share of host RAM, ...). When in-use bytes leave less than
    ``min_headroom_frac`` of the budget free, the flight recorder fires
    ``hbm_pressure``, once per recorder cooldown, with the in-use /
    budget / headroom context in the dump. No budget -> gauges only,
    never a trigger.

    ``interval_s`` defaults to 1 s (the SLOMonitor cadence): off the card
    an accounting pass is a full census, gc pass included, and running
    THAT per decode step would inflate the very latencies the SLO engine
    next to it measures. ``interval_s=0`` opts into per-tick accounting
    (tests; on the card a pass reads the allocator's counters only)."""

    def __init__(self, budget_bytes=None, min_headroom_frac=0.1,
                 interval_s=1.0, registry=None, flight_recorder=None):
        self.budget_bytes = None if budget_bytes is None \
            else float(budget_bytes)
        self.min_headroom_frac = float(min_headroom_frac)
        if not 0.0 <= self.min_headroom_frac < 1.0:
            raise ValueError("min_headroom_frac must be in [0, 1)")
        self.interval_s = float(interval_s)
        self._registry = registry
        self._flight = flight_recorder
        self._last_tick = None
        self.pressure_events = 0
        self.last_report = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def tick(self, now=None):
        """Cadence gate around update(): cheap monotonic compare when
        the interval has not elapsed (the per-step serving hook)."""
        now = time.monotonic() if now is None else now
        if self._last_tick is not None \
                and now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now
        return self.update()

    def update(self, in_use_bytes=None, budget_bytes=None):
        """One accounting pass: device stats (or a census off the card) ->
        gauges, then the pressure check. ``in_use_bytes`` overrides the
        measured value (synthetic numbers: the selfcheck path)."""
        reg = self._reg()
        budget = budget_bytes if budget_bytes is not None \
            else self.budget_bytes
        devs = device_memory() if in_use_bytes is None else {}
        census_bytes = None
        if in_use_bytes is None:
            if devs:
                in_use = reg.gauge(
                    "hbm_device_bytes_in_use",
                    help="per-device memory in use (allocator reserved "
                         "bytes)", labels=("device",))
                limit_g = reg.gauge(
                    "hbm_device_bytes_limit",
                    help="per-device memory capacity",
                    labels=("device",))
                peak_g = reg.gauge(
                    "hbm_device_bytes_peak",
                    help="per-device peak memory in use (allocator "
                         "reserved bytes)", labels=("device",))
                # device ids: fixed hardware set, bounded by topology
                for dev, st in devs.items():
                    in_use.labels(device=dev).set(st["bytes_in_use"])
                    if st["bytes_limit"]:
                        limit_g.labels(device=dev).set(st["bytes_limit"])
                    if st["peak_bytes_in_use"]:
                        peak_g.labels(device=dev).set(
                            st["peak_bytes_in_use"])
                in_use_bytes = sum(d["bytes_in_use"] for d in devs.values())
                limits = sum(d["bytes_limit"] for d in devs.values())
                if budget is None and limits:
                    budget = float(limits)
            else:
                census = record_census(registry=reg)
                census_bytes = sum(e["bytes"] for e in census.values())
                in_use_bytes = census_bytes
        # pressure is PER DEVICE where the devices report limits: the
        # trigger below uses the worst device's headroom
        worst_dev = None
        for dev, st in devs.items():
            if st["bytes_limit"]:
                h = max(0.0, (st["bytes_limit"] - st["bytes_in_use"])
                        / st["bytes_limit"])
                if worst_dev is None or h < worst_dev[1]:
                    worst_dev = (dev, h)
        in_use_bytes = float(in_use_bytes)
        g = reg.gauge("hbm_bytes_in_use",
                      help="device memory in use (allocator reserved "
                           "bytes, or live-tensor census bytes off the "
                           "card)")
        g.set(in_use_bytes)
        reg.gauge("hbm_bytes_high_water",
                  help="peak observed hbm_bytes_in_use").set_max(
                      in_use_bytes)
        headroom = None
        if budget:
            headroom = max(0.0, (budget - in_use_bytes) / budget)
            reg.gauge("hbm_bytes_budget",
                      help="accounting ceiling for the pressure check "
                           "(the card's total, or a declared "
                           "budget)").set(budget)
            reg.gauge("hbm_headroom_frac",
                      help="(budget - in_use) / budget; the hbm_pressure"
                           " trigger fires below min_headroom_frac").set(
                          headroom)
        # the trigger evaluates the TIGHTEST headroom it can see: the
        # worst single device when per-device limits exist, the declared
        # budget otherwise
        eff_headroom = headroom
        if worst_dev is not None and (eff_headroom is None
                                      or worst_dev[1] < eff_headroom):
            eff_headroom = worst_dev[1]
        pressure = eff_headroom is not None \
            and eff_headroom < self.min_headroom_frac
        report = {"in_use_bytes": in_use_bytes,
                  "budget_bytes": budget,
                  "headroom_frac": headroom,
                  "worst_device": None if worst_dev is None
                  else {"device": worst_dev[0],
                        "headroom_frac": worst_dev[1]},
                  "census_bytes": census_bytes,
                  "devices": devs,
                  "pressure": pressure}
        self.last_report = report
        if pressure:
            self.pressure_events += 1
            fr = self._flight if self._flight is not None \
                else get_flight_recorder()
            ctx = {"in_use_bytes": in_use_bytes,
                   "budget_bytes": budget,
                   "headroom_frac": eff_headroom,
                   "min_headroom_frac": self.min_headroom_frac}
            if worst_dev is not None:
                ctx["worst_device"] = worst_dev[0]
            fr.trigger("hbm_pressure", **ctx)
        return report
