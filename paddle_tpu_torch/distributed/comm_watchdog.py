"""Collective watchdog of the PyTorch port (counterpart of
``paddle_tpu/distributed/comm_watchdog.py``; reference: CommTask /
CommTaskManager — paddle/phi/core/distributed/comm_task_manager.h:37 +
nccl_comm_task.cc: per-collective start/end events, async timeout
polling, task dump for hang post-mortems; enabled by
FLAGS_enable_async_trace).

The observable boundary is the host: a task starts where a collective
(or a step that contains collectives, as tensor-parallel serving's paged
step with its two all_reduces a layer) is dispatched and ends where the
host has its result. A daemon thread polls outstanding tasks; one that
stays incomplete past `timeout` means a peer died or a link stalled and
triggers the hang report: outstanding task table + per-group sequence
numbers (mismatched sequence numbers across ranks are the classic desync
signature the reference dumps). The group's own timeout still bounds
every operation (distributed/collective.py); the watchdog reports what
was in flight. Dumps go to ``PADDLE_COMM_DUMP_DIR``, else a directory
under the temporary directory."""
import json
import logging
import os
import tempfile
import threading
import time

from ..observability import get_registry as _registry
from ..observability import tracing as _tracing

log = logging.getLogger("paddle_tpu_torch.distributed.watchdog")


def _stall_counter():
    return _registry().counter(
        "comm_watchdog_stalls_total",
        help="collectives that exceeded the watchdog timeout",
        labels=("op",))


def _inflight_gauge():
    return _registry().gauge(
        "comm_inflight_collectives",
        help="collectives (or collective-bearing steps) dispatched but not "
             "yet completed")


def _collective_seconds():
    return _registry().histogram(
        "collective_seconds",
        help="host wall time of collective dispatches, to their result",
        labels=("op", "axis"))


def _collective_bytes():
    return _registry().counter(
        "collective_bytes_total",
        help="payload bytes moved by collectives",
        labels=("op", "axis"))


def _collective_bandwidth():
    return _registry().gauge(
        "collective_bandwidth_bytes_per_s",
        help="algorithmic bandwidth of the last completed collective "
             "(payload bytes / host wall; ring-algorithm bus bandwidth "
             "is a fixed multiple per op)",
        labels=("op", "axis"))

__all__ = ["CommTask", "CommTaskManager", "enable_comm_watchdog",
           "disable_comm_watchdog", "comm_task_manager", "task_scope"]


class CommTask:
    __slots__ = ("task_id", "op", "group", "seq", "start", "start_pc",
                 "end", "nbytes", "reported")

    def __init__(self, task_id, op, group, seq, nbytes=0):
        self.task_id = task_id
        self.op = op
        self.group = group
        self.seq = seq
        self.start = time.monotonic()
        # span timebase (perf_counter — the tracing/profiler clock, a
        # different epoch from the monotonic interval clock above)
        self.start_pc = time.perf_counter()
        self.end = None
        self.nbytes = int(nbytes or 0)
        self.reported = False

    @property
    def done(self):
        return self.end is not None

    @property
    def elapsed(self):
        return (self.end or time.monotonic()) - self.start

    @property
    def bandwidth(self):
        """Algorithmic bytes/s so far (a hung task's figure is the
        FLOOR its payload has been moving at); None without a payload
        size or before any time has passed."""
        el = self.elapsed
        if not self.nbytes or el <= 0:
            return None
        return self.nbytes / el

    def as_dict(self):
        bw = self.bandwidth
        return {"task_id": self.task_id, "op": self.op,
                "group": str(self.group), "seq": self.seq,
                "elapsed_s": round(self.elapsed, 3), "done": self.done,
                "nbytes": self.nbytes,
                "bandwidth_bytes_per_s":
                    None if bw is None else round(bw, 1)}


class CommTaskManager:
    """Tracks in-flight collectives; a daemon poller flags hangs."""

    def __init__(self, timeout=1800.0, poll_interval=10.0, dump_dir=None):
        self.timeout = timeout
        self.poll_interval = poll_interval
        self.dump_dir = dump_dir or os.environ.get(
            "PADDLE_COMM_DUMP_DIR") or os.path.join(
                tempfile.gettempdir(), "paddle_tpu_torch_comm_dump")
        self._tasks = {}
        self._seq = {}           # group name -> sequence counter
        self._next_id = 0
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self._hang_hooks = []
        self.hang_detected = False

    # -- task lifecycle ---------------------------------------------------
    def start_task(self, op, group=None, nbytes=0):
        # None = the default flat communicator: label it 'world' so the
        # (op, axis) metric children read as an axis, not a repr
        gname = getattr(group, "axis_name", None) or (
            "world" if group is None else str(group))
        with self._lock:
            self._next_id += 1
            seq = self._seq.get(gname, 0) + 1
            self._seq[gname] = seq
            t = CommTask(self._next_id, op, gname, seq, nbytes)
            self._tasks[t.task_id] = t
            n = len(self._tasks)
        _inflight_gauge().set(n)
        # the payload is counted at dispatch, as the collective's call
        # count is: a peer's bytes are on the counter by the time any
        # rank's call of the same collective returns
        if t.nbytes:
            _collective_bytes().labels(op=t.op, axis=t.group).inc(t.nbytes)
        return t

    def end_task(self, task):
        task.end = time.monotonic()
        with self._lock:
            self._tasks.pop(task.task_id, None)
            n = len(self._tasks)
        _inflight_gauge().set(n)
        # latency and bandwidth per (op, axis): what tensor-parallel
        # serving sizes its collectives against
        el = task.elapsed
        _collective_seconds().labels(op=task.op,
                                     axis=task.group).observe(el)
        if task.nbytes and el > 0:
            _collective_bandwidth().labels(
                op=task.op, axis=task.group).set(task.nbytes / el)
        # timeline span on the profiler clock: collectives line up
        # against the serve/train host ranges in one chrome view
        _tracing.get_tracer().record_span(
            "collective", task.start_pc * 1e6, el * 1e6,
            op=task.op, axis=str(task.group), seq=task.seq,
            nbytes=task.nbytes)

    # -- watchdog ------------------------------------------------------
    def register_hang_hook(self, fn):
        """fn(list-of-task-dicts) runs when a hang is detected."""
        self._hang_hooks.append(fn)

    def outstanding(self):
        with self._lock:
            return [t.as_dict() for t in self._tasks.values()]

    def group_sequences(self):
        with self._lock:
            return dict(self._seq)

    def _poll(self):
        while not self._stop.wait(self.poll_interval):
            now = time.monotonic()
            with self._lock:
                hung = [t for t in self._tasks.values()
                        if now - t.start > self.timeout and not t.reported]
                for t in hung:
                    t.reported = True  # one report per task
            if hung:
                self.hang_detected = True
                counter = _stall_counter()
                for t in hung:
                    counter.labels(op=t.op).inc()
                # the flight recorder captures what the SERVING/TRAINING
                # side was doing while the collective hung — the span
                # window plus a metrics snapshot, complementing the
                # watchdog's own task-table dump below
                _tracing.get_flight_recorder().trigger(
                    "comm_watchdog_stall",
                    ops=",".join(sorted({t.op for t in hung})),
                    hung=len(hung), timeout_s=self.timeout)
                self._dump(hung)

    def _dump(self, hung):
        outstanding = self.outstanding()
        # what the collectives were MOVING, not just how long they sat:
        # payload totals plus each task's bandwidth floor (as_dict
        # carries the per-task figure) — a hang at 0 bytes/s is a dead
        # link, a hang at a trickle is congestion/slow-peer
        report = {
            "time": time.time(),
            "hung_tasks": [t.as_dict() for t in hung],
            "outstanding": outstanding,
            "group_sequences": self.group_sequences(),
            "nbytes": {
                "hung_total": sum(t.nbytes for t in hung),
                "outstanding_total": sum(t["nbytes"]
                                         for t in outstanding),
            },
            "bandwidth": self._bandwidth_snapshot(),
        }
        log.error("comm watchdog: %d collective(s) exceeded %.0fs timeout: %s",
                  len(hung), self.timeout,
                  ", ".join(f"{t.op}@{t.group}#{t.seq}" for t in hung))
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"comm_hang_{int(time.time())}.json")
            with open(path, "w") as f:
                json.dump(report, f, indent=2)
            log.error("comm watchdog: task dump written to %s", path)
        except OSError:
            pass
        for fn in self._hang_hooks:
            try:
                fn(report)
            except Exception:
                pass

    @staticmethod
    def _bandwidth_snapshot():
        """Last-completed bandwidth per (op, axis) from the registry —
        the healthy baseline the hung tasks' floors compare against."""
        g = _registry().get("collective_bandwidth_bytes_per_s")
        if g is None:
            return {}
        return {",".join(k): round(c.value, 1)
                for k, c in list(g._children.items())}

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll, daemon=True,
                                            name="comm-watchdog")
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


comm_task_manager = CommTaskManager()
_enabled = False


def enable_comm_watchdog(timeout=None, poll_interval=None):
    """Turn on hang detection (reference FLAGS_enable_async_trace)."""
    global _enabled
    if timeout is not None:
        comm_task_manager.timeout = timeout
    if poll_interval is not None:
        comm_task_manager.poll_interval = poll_interval
    comm_task_manager.start()
    _enabled = True


def disable_comm_watchdog():
    global _enabled
    comm_task_manager.stop()
    _enabled = False


def is_enabled():
    return _enabled


class task_scope:
    """Context manager wrapping one collective dispatch."""

    def __init__(self, op, group=None, nbytes=0):
        self.op = op
        self.group = group
        self.nbytes = nbytes
        self._task = None

    def __enter__(self):
        if _enabled:
            self._task = comm_task_manager.start_task(self.op, self.group,
                                                      self.nbytes)
        return self._task

    def __exit__(self, *exc):
        if self._task is not None:
            comm_task_manager.end_task(self._task)
        return False
