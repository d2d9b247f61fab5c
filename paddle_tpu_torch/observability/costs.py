"""Per-program cost catalog of the PyTorch port: where the flops, bytes and
device memory go (counterpart of ``paddle_tpu/observability/costs.py``).

The JAX catalog reads XLA's cost and memory analyses off the compiled
program. Eager PyTorch has no compiled program to ask, so the port counts
the work while the program runs:

* ``count_call(program, fn, args, kwargs)`` runs ``fn`` ONCE under two
  dispatch modes: ``torch.utils.flop_counter.FlopCounterMode`` counts the
  flops of the aten products (matmuls, convolutions, attention; an
  element-wise op counts none), and a byte counter adds each aten op's
  tensor inputs plus outputs at their dtypes (views and allocations move
  nothing). Like XLA's unfused count this is an upper bound of the bytes
  the program moves. The port's own kernels are launched through
  ``ctypes``, where no dispatch mode sees them: each wrapper reports its
  kernel's bytes and flops from its shapes (``ops.work``, the formulas of
  the smoke's bounds) to the active counter, and the entry keeps them per
  kernel under ``kernels``. The counted call IS the program's call: it is
  never run twice, because a paged step writes the KV cache and a
  training step steps the optimizer.
* ``peak_hbm`` on the card is the argument bytes plus the rise of
  ``max_memory_allocated`` over the counted call (its temporaries and
  outputs: XLA's argument + output + temp), for which the call resets the
  card's peak-memory statistic. On the CPU it is the argument bytes
  plus the most bytes of the storages that the call's aten ops made
  alive at once (each counted until its storage is freed; per thread, as
  the dispatch modes are).
* ``program_flops{program}`` / ``program_bytes{program}`` /
  ``program_peak_hbm_bytes{program}`` and the argument / output / temp
  gauges, ``program_arithmetic_intensity{program}`` (flops per byte, the
  roofline x-coordinate), ``program_mfu{program}`` and
  ``program_roofline_frac{program}``.

``derive()`` divides by ``program_device_seconds{program}``: the time
from the program's first device work to its last. On the card the
dispatch wrappers record a CUDA event pair on the stream around each
call and read it on a later call (``poll``), never synchronizing the hot
path; on the CPU the call blocks, so its host wall is that time. The
counted call is left out of the series. A wrapper's host dispatch span
(``dispatch_seconds``) ends when the kernels are enqueued, not when they
finish, and would read an MFU no card can give.

Attribution is OPT-IN (``get_cost_catalog().enabled = True``): the
dispatch wrappers count at the first call of each argument signature and
time calls only while enabled; disabled, they test one flag. Peaks: an
NVIDIA H100 (from ``torch.cuda.get_device_name``) reads 989e12 flop/s
(dense bf16 tensor cores) and 3.35e12 B/s; anything else the nominal pair,
so that the ratios stay defined on the CPU. ``PADDLE_TPU_PEAK_FLOPS`` /
``PADDLE_TPU_PEAK_BYTES_PER_S`` override either.

Stdlib only at import: torch is touched lazily, and ``record()`` with
host numbers works without it (the selfcheck path).
"""
import collections
import os
import threading
import time

from .metrics import exponential_buckets, get_registry

__all__ = [
    "CostCatalog", "get_cost_catalog", "peak_flops", "peak_bandwidth",
    "program_flops", "program_bytes", "program_peak_hbm",
    "program_arg_bytes", "program_out_bytes", "program_temp_bytes",
    "program_intensity", "program_mfu", "program_roofline_frac",
    "program_device_seconds", "cost_analyses_total", "arg_signature",
]


# -- gauge accessors (re-fetched through the registry per record, the
#    instrument.py convention: reset() can never orphan a handle) ---------

def program_flops():
    return get_registry().gauge(
        "program_flops",
        help="flops counted over the program's first call of its last "
             "counted signature (aten products + the port's kernels)",
        labels=("program",))


def program_bytes():
    return get_registry().gauge(
        "program_bytes",
        help="bytes each op of the counted call reads and writes (an "
             "upper bound of the device traffic)", labels=("program",))


def program_peak_hbm():
    return get_registry().gauge(
        "program_peak_hbm_bytes",
        help="argument bytes + the rise of max_memory_allocated over the "
             "counted call", labels=("program",))


def program_arg_bytes():
    return get_registry().gauge(
        "program_argument_bytes",
        help="tensor bytes of the counted call's arguments",
        labels=("program",))


def program_out_bytes():
    return get_registry().gauge(
        "program_output_bytes",
        help="tensor bytes of the counted call's outputs",
        labels=("program",))


def program_temp_bytes():
    return get_registry().gauge(
        "program_temp_bytes",
        help="peak temporaries of the counted call (the rise of "
             "max_memory_allocated less the outputs)", labels=("program",))


def program_intensity():
    return get_registry().gauge(
        "program_arithmetic_intensity",
        help="flops per byte accessed: the roofline x-coordinate (below "
             "the ridge point = bandwidth-bound)", labels=("program",))


def program_mfu():
    return get_registry().gauge(
        "program_mfu",
        help="achieved model-flops-utilization: counted flops / device-"
             "complete program time / device peak flops",
        labels=("program",))


def program_roofline_frac():
    return get_registry().gauge(
        "program_roofline_frac",
        help="achieved flops rate / roofline-attainable rate "
             "min(peak_flops, intensity * peak_bandwidth)",
        labels=("program",))


# 1 us .. ~190 s in steps of 1.5x
_DEVICE_BUCKETS = exponential_buckets(1e-6, 1.5, 48)


def program_device_seconds():
    return get_registry().histogram(
        "program_device_seconds",
        help="program time from its first device work to its last (CUDA "
             "events on the card, the blocking call's wall on the CPU)",
        labels=("program",), buckets=_DEVICE_BUCKETS)


def cost_analyses_total():
    return get_registry().counter(
        "cost_analyses_total",
        help="counted program calls (the first call of each argument "
             "signature while the catalog is enabled)",
        labels=("program",))


# -- device peaks for MFU / roofline ---------------------------------------
# (device-name substring, peak flops/s, peak bytes/s); first match wins.
# Anything unrecognized (the CPU) gets a NOMINAL pair so MFU stays a
# well-defined ratio a CPU gate can bounds-check: coverage evidence, not a
# speed claim.
_GPU_PEAKS = (
    ("H100", 989e12, 3.35e12),      # SXM: dense bf16 tensor cores, HBM3
)
_NOMINAL_PEAK = (1e11, 2e10)        # 100 GFLOP/s, 20 GB/s

_peak_cache = None
_peak_lock = threading.Lock()


def _resolve_peaks():
    """(peak_flops/s, peak_bytes/s) for the current device. Env overrides
    (PADDLE_TPU_PEAK_FLOPS / PADDLE_TPU_PEAK_BYTES_PER_S) win; without
    torch or a card the nominal pair comes back."""
    flops = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    bw = os.environ.get("PADDLE_TPU_PEAK_BYTES_PER_S")
    if flops and bw:
        return float(flops), float(bw)
    f, b = _NOMINAL_PEAK
    try:
        import torch
        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            for sub, pf, pb in _GPU_PEAKS:
                if sub in name:
                    f, b = pf, pb
                    break
    except Exception:
        pass
    return (float(flops) if flops else f, float(bw) if bw else b)


def peak_flops():
    return _peaks()[0]


def peak_bandwidth():
    return _peaks()[1]


def _peaks():
    global _peak_cache
    with _peak_lock:
        if _peak_cache is None:
            _peak_cache = _resolve_peaks()
        return _peak_cache


# -- the counted call (torch, lazily) ----------------------------------------

def _leaves(x, depth=0):
    """Tensors and numpy arrays in nested args (lists, tuples, dicts)."""
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y, depth + 1)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y, depth + 1)
    else:
        yield x


def arg_signature(args, kwargs=None):
    """The call's bucket key: shape and dtype of every tensor and array,
    the type of anything else (the JAX wrapper's executable-cache key;
    every value that picks a bucket here is an array's length)."""
    def key(x):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return (tuple(shape), str(dtype))
        return ("py", type(x).__name__)
    return (tuple(key(x) for x in _leaves(args)),
            tuple((k, key(x)) for k, v in sorted((kwargs or {}).items())
                  for x in _leaves(v)))


def _tensor_bytes(x):
    import torch
    return sum(t.numel() * t.element_size() for t in _leaves(x)
               if isinstance(t, torch.Tensor))


def device_of(args, kwargs=None):
    """The device of the call's first tensor, or None."""
    import torch
    for x in _leaves((args, kwargs or {})):
        if isinstance(x, torch.Tensor):
            return x.device
    return None


_counter_cls = None


def _work_counter(track_host_peak=False):
    """A dispatch mode that adds each aten op's tensor input and output
    bytes, and takes the port's kernels' own reports (``add_kernel``).
    ``track_host_peak`` (a call on the CPU): also the most bytes of the
    CPU storages its ops made alive at once (``peak``)."""
    global _counter_cls
    if _counter_cls is None:
        import weakref

        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        aten = torch.ops.aten
        free = {aten.empty, aten.empty_like, aten.empty_strided,
                aten.new_empty, aten.new_empty_strided, aten.detach,
                aten.alias, aten.lift_fresh, aten.set_, aten.resize_}

        class WorkCounter(TorchDispatchMode):
            def __init__(self, track=False):
                super().__init__()
                self.bytes = 0
                self.kernels = {}
                self.track = track
                self.live, self.peak = {}, 0
                self.cur = 0
                self._lock = threading.Lock()

            def _free(self, ptr):
                with self._lock:
                    self.cur -= self.live.pop(ptr, 0)

            def _made(self, args, out):
                """Count the new CPU storages among an op's outputs."""
                seen = {t.untyped_storage().data_ptr()
                        for t in _leaves(args) if isinstance(t, torch.Tensor)}
                for t in _leaves(out):
                    if not isinstance(t, torch.Tensor) or t.is_cuda:
                        continue
                    st = t.untyped_storage()
                    ptr, nbytes = st.data_ptr(), st.nbytes()
                    if not nbytes or ptr in seen or ptr in self.live:
                        continue
                    with self._lock:
                        self.live[ptr] = nbytes
                        self.cur += nbytes
                        self.peak = max(self.peak, self.cur)
                    weakref.finalize(st, self._free, ptr)

            def add_kernel(self, kernel, nbytes, flops):
                k = self.kernels.setdefault(
                    kernel, {"launches": 0, "bytes": 0, "flops": 0})
                k["launches"] += 1
                k["bytes"] += int(nbytes)
                k["flops"] += int(flops)

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view and func.overloadpacket not in free:
                    self.bytes += _tensor_bytes((args, kwargs or {})) + \
                        _tensor_bytes(out)
                if self.track and not func.is_view:
                    self._made((args, kwargs or {}), out)
                return out

        _counter_cls = WorkCounter
    return _counter_cls(track_host_peak)


def _sample_quantile(values, q):
    s = sorted(values)
    if not s:
        return None
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class CostCatalog:
    """Host-side catalog of per-program cost / memory entries.

    ``record()`` takes plain numbers (works without torch: the selfcheck
    path); ``count_call()`` counts a program's call as it runs. One entry
    per program name; a new signature of the same program updates the
    entry and adds to its per-signature history, so the gauges show the
    LAST counted signature while ``entries()`` keeps every bucket seen.
    ``start_timer`` / ``stop_timer`` / ``poll`` feed
    ``program_device_seconds``, which ``derive()`` divides by."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._programs = {}
        self._registry = registry
        self.enabled = False        # dispatch wrappers consult this
        # bumped by reset(): the wrappers key their seen-signature sets on
        # it, so a reset re-counts warm programs
        self.generation = 0
        self._pending = collections.deque()     # (program, start, end)
        self._samples = {}                      # program -> recent seconds

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    # -- recording --------------------------------------------------------
    def record(self, program, flops=None, bytes_accessed=None,
               arg_bytes=None, out_bytes=None, temp_bytes=None,
               peak_hbm=None, signature=None, source="manual",
               kernels=None):
        """Record one program's cost/memory numbers and set the gauges.
        ``peak_hbm`` defaults to arg + out + temp. ``kernels``: the port's
        kernels' own counts ({name: {launches, bytes, flops}}). Returns
        the catalog entry."""
        program = str(program)
        if peak_hbm is None and None not in (arg_bytes, out_bytes,
                                             temp_bytes):
            peak_hbm = float(arg_bytes) + float(out_bytes) \
                + float(temp_bytes)
        intensity = None
        if flops and bytes_accessed:
            intensity = float(flops) / float(bytes_accessed)
        entry = {
            "program": program,
            "flops": None if flops is None else float(flops),
            "bytes_accessed": None if bytes_accessed is None
            else float(bytes_accessed),
            "arg_bytes": None if arg_bytes is None else float(arg_bytes),
            "out_bytes": None if out_bytes is None else float(out_bytes),
            "temp_bytes": None if temp_bytes is None else float(temp_bytes),
            "peak_hbm": None if peak_hbm is None else float(peak_hbm),
            "intensity": intensity,
            "kernels": dict(kernels or {}),
            "source": str(source),
        }
        with self._lock:
            prev = self._programs.get(program)
            sigs = dict(prev["signatures"]) if prev else {}
            if signature is not None:
                sigs[str(signature)] = {
                    k: entry[k] for k in ("flops", "bytes_accessed",
                                          "peak_hbm")}
            entry["signatures"] = sigs
            entry["analyses"] = (prev["analyses"] if prev else 0) + 1
            self._programs[program] = entry
        gauges = (
            (program_flops, "program_flops", entry["flops"]),
            (program_bytes, "program_bytes", entry["bytes_accessed"]),
            (program_peak_hbm, "program_peak_hbm_bytes",
             entry["peak_hbm"]),
            (program_arg_bytes, "program_argument_bytes",
             entry["arg_bytes"]),
            (program_out_bytes, "program_output_bytes",
             entry["out_bytes"]),
            (program_temp_bytes, "program_temp_bytes",
             entry["temp_bytes"]),
            (program_intensity, "program_arithmetic_intensity",
             entry["intensity"]),
        )
        for accessor, name, value in gauges:
            if value is not None:
                self._family(accessor, name).labels(
                    program=program).set(value)
        self._family(cost_analyses_total, "cost_analyses_total",
                     kind="counter").labels(program=program).inc()
        return dict(entry)

    def _family(self, accessor, name, kind="gauge"):
        """The named family on this catalog's registry: the module
        accessor (full help text) on the process registry, a bare
        same-named family on a private one (tests/selfcheck)."""
        if self._registry is None:
            return accessor()
        if kind == "counter":
            return self._registry.counter(name, labels=("program",))
        if kind == "histogram":
            return self._registry.histogram(name, labels=("program",),
                                            buckets=_DEVICE_BUCKETS)
        return self._registry.gauge(name, labels=("program",))

    def count_call(self, program, fn, args=(), kwargs=None, signature=None):
        """Run ``fn(*args, **kwargs)`` once, counting its work, and record
        it under ``program``. Returns (fn's output, the entry)."""
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        from ..ops import work as _work
        kwargs = kwargs or {}
        dev = device_of(args, kwargs)
        cuda = dev is not None and dev.type == "cuda"
        arg_bytes = _tensor_bytes((args, kwargs))
        if cuda:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        flop_mode = FlopCounterMode(display=False)
        counter = _work_counter(not cuda)
        _work._counting[0] += 1
        try:
            with flop_mode, counter:
                out = fn(*args, **kwargs)
        finally:
            _work._counting[0] -= 1
        out_bytes = _tensor_bytes(out)
        if cuda:
            torch.cuda.synchronize(dev)
            rise = torch.cuda.max_memory_allocated(dev) - base
        else:
            rise = counter.peak
        peak, temp = arg_bytes + rise, max(0, rise - out_bytes)
        kflops = sum(k["flops"] for k in counter.kernels.values())
        kbytes = sum(k["bytes"] for k in counter.kernels.values())
        entry = self.record(
            program, flops=flop_mode.get_total_flops() + kflops,
            bytes_accessed=counter.bytes + kbytes, arg_bytes=arg_bytes,
            out_bytes=out_bytes, temp_bytes=temp, peak_hbm=peak,
            signature=signature, source="counted", kernels=counter.kernels)
        return out, entry

    # -- the device-complete time -----------------------------------------
    def start_timer(self, device):
        """A token for one program call on ``device``: a CUDA event
        recorded on its current stream, or the host clock off the card."""
        if device is not None and device.type == "cuda":
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            return ev
        return time.perf_counter()

    def stop_timer(self, program, token):
        """End the call begun at ``token``: on the card record the end
        event and read it later (``poll``); off the card observe now."""
        if isinstance(token, float):
            self.observe_seconds(program, time.perf_counter() - token)
            return
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.append((program, token, end))
        self.poll()

    def poll(self, block=False):
        """Observe every finished call's event time, oldest first; with
        ``block`` wait for the pending ones (report time, not the hot
        path)."""
        while self._pending:
            program, start, end = self._pending[0]
            if block:
                end.synchronize()
            elif not end.query():
                break
            self._pending.popleft()
            self.observe_seconds(program, start.elapsed_time(end) / 1e3)

    def observe_seconds(self, program, seconds):
        with self._lock:
            self._samples.setdefault(
                program, collections.deque(maxlen=1024)).append(seconds)
        self._family(program_device_seconds, "program_device_seconds",
                     kind="histogram").labels(program=program).observe(
                         seconds)

    # -- derived MFU / roofline -------------------------------------------
    def derive(self, dispatch_q=0.5, registry=None,
               peak_flops_override=None, peak_bw_override=None):
        """Achieved MFU and roofline fraction of every cataloged program
        against the q-quantile of its device-complete time (the exact
        samples this catalog observed, else the
        ``program_device_seconds{program}`` histogram); sets the gauges
        and returns {program: {...}}."""
        self.poll(block=True)
        reg = registry if registry is not None else self._reg()
        pf = peak_flops_override if peak_flops_override is not None \
            else peak_flops()
        pb = peak_bw_override if peak_bw_override is not None \
            else peak_bandwidth()
        hist = reg.get("program_device_seconds")
        out = {}
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            samples = {k: list(v) for k, v in self._samples.items()}
        for name, entry in programs.items():
            if not entry.get("flops"):
                continue
            lat = _sample_quantile(samples.get(name, ()), dispatch_q)
            if lat is None and hist is not None:
                child = hist._children.get((name,))
                if child is not None and child.count:
                    lat = child.quantile(dispatch_q)
            if not lat or lat <= 0:
                continue
            achieved = entry["flops"] / lat
            mfu = achieved / pf if pf > 0 else None
            frac = None
            if entry.get("intensity"):
                attainable = min(pf, entry["intensity"] * pb)
                frac = achieved / attainable if attainable > 0 else None
            row = {"device_s": lat,
                   "achieved_flops_per_s": achieved, "mfu": mfu,
                   "roofline_frac": frac,
                   "samples": len(samples.get(name, ()))}
            out[name] = row
            # program names are the code's own fixed set (paged_step,
            # pretrain_step, ...), bounded by the source, not by traffic
            if mfu is not None:
                self._family(program_mfu, "program_mfu").labels(
                    program=name).set(mfu)
            if frac is not None:
                self._family(program_roofline_frac,
                             "program_roofline_frac").labels(
                                 program=name).set(frac)
        return out

    # -- reading ----------------------------------------------------------
    def entries(self):
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    def table(self, dispatch_q=0.5, registry=None):
        """Report rows, one per program: the cost report's surface."""
        derived = self.derive(dispatch_q=dispatch_q, registry=registry)
        rows = []
        for name, e in sorted(self.entries().items()):
            d = derived.get(name, {})
            rows.append({
                "program": name,
                "flops": e["flops"],
                "bytes_accessed": e["bytes_accessed"],
                "peak_hbm": e["peak_hbm"],
                "arg_bytes": e["arg_bytes"],
                "out_bytes": e["out_bytes"],
                "temp_bytes": e["temp_bytes"],
                "intensity": e["intensity"],
                "kernels": e["kernels"],
                "signatures": len(e["signatures"]),
                "analyses": e["analyses"],
                "device_s": d.get("device_s"),
                "mfu": d.get("mfu"),
                "roofline_frac": d.get("roofline_frac"),
            })
        return rows

    # every gauge family record()/derive() writes; reset() zeroes their
    # children so a cleared program never keeps exporting stale numbers
    _FAMILIES = ("program_flops", "program_bytes",
                 "program_peak_hbm_bytes", "program_argument_bytes",
                 "program_output_bytes", "program_temp_bytes",
                 "program_arithmetic_intensity", "program_mfu",
                 "program_roofline_frac")

    def reset(self):
        with self._lock:
            self._programs.clear()
            self._samples.clear()
            self._pending.clear()
            self.generation += 1
        reg = self._reg()
        for fam_name in self._FAMILIES:
            fam = reg.get(fam_name)
            if fam is None:
                continue
            for key in list(fam._children):
                fam.labels(program=key[0]).set(0)


_catalog = CostCatalog()


def get_cost_catalog():
    """The process-wide catalog the dispatch wrappers and the pretrain
    step attribute into (opt-in: set ``.enabled = True`` first)."""
    return _catalog
