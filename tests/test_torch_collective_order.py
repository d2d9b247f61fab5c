"""The port's collectives count a call before they dispatch it.

Ranks that are threads of one process share the counters
(``collective.all_reduce.calls``, the comm watchdog's
``collective_bytes_total``). A peer that has dispatched its part of a
collective but not yet counted it would leave rank 0 reading a short
count as soon as its own call returns. The follower here dispatches and
then stalls for 50 ms before it returns to the wrapper, which puts that
window wide open: the counts must already hold both calls.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.distributed import collective  # noqa: E402
from paddle_tpu_torch.distributed import comm_watchdog  # noqa: E402
from paddle_tpu_torch.testing import ThreadRankSet  # noqa: E402

STALL_S = 0.05


class _StallAfterDispatch:
    """A gloo group whose collectives return STALL_S after they were
    dispatched (the work itself runs on gloo's threads meanwhile)."""

    def __init__(self, group, dispatched):
        self._g, self._dispatched = group, dispatched

    def _stall(self, work):
        self._dispatched.set()
        time.sleep(STALL_S)
        return work

    def allreduce(self, *a):
        return self._stall(self._g.allreduce(*a))

    def allgather(self, *a):
        return self._stall(self._g.allgather(*a))

    def reduce_scatter(self, *a):
        return self._stall(self._g.reduce_scatter(*a))

    def broadcast(self, *a):
        return self._stall(self._g.broadcast(*a))

    def __getattr__(self, name):
        return getattr(self._g, name)


def _bytes(op, axis):
    fam = obs.get_registry().get("collective_bytes_total")
    if fam is None:
        return 0.0
    return sum(c.value for k, c in fam._children.items()
               if op in k and axis in k)


def _calls(n):
    return {"all_reduce": collective.all_reduce.calls,
            "all_gather": collective.all_gather.calls,
            "reduce_scatter": collective.reduce_scatter.calls,
            "broadcast": collective.broadcast.calls}[n]


def _run(op, t, stats, group, axis):
    if op == "all_reduce":
        collective.all_reduce(t, group=group, axis=axis, stats=stats)
    elif op == "all_gather":
        collective.all_gather([], t, group=group, axis=axis, stats=stats)
    elif op == "reduce_scatter":
        collective.reduce_scatter(torch.empty(2), [t[:2], t[2:]],
                                  group=group, axis=axis, stats=stats)
    else:
        collective.broadcast(t, src=0, group=group)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather",
                                "reduce_scatter", "broadcast"])
def test_a_peers_call_is_counted_when_rank_0_returns(op):
    axis = f"pin_{op}"
    nbytes = {"all_reduce": 16, "all_gather": 32, "reduce_scatter": 16,
              "broadcast": 0}[op]
    stats = {0: {}, 1: {}}
    dispatched = threading.Event()
    go = threading.Event()
    comm_watchdog.enable_comm_watchdog(timeout=60, poll_interval=60)
    try:
        def follower(rank, group):
            go.wait(30)
            _run(op, torch.ones(4), stats[rank],
                 _StallAfterDispatch(group, dispatched), axis)
            return True

        ranks = ThreadRankSet(2, follower, timeout=30, ranks=[1])
        g0 = ranks.group(0)
        calls0, bytes0 = _calls(op), _bytes(op, axis)
        go.set()
        _run(op, torch.ones(4), stats[0], g0, axis)
        # read at once: the follower is still inside its stall
        got_calls, got_bytes = _calls(op), _bytes(op, axis)
        got_stats = {r: dict(s) for r, s in stats.items()}
        assert dispatched.is_set()
        assert ranks.join(30) == {1: True}
    finally:
        comm_watchdog.disable_comm_watchdog()
    assert got_calls - calls0 == 2
    if op != "broadcast":
        assert got_bytes - bytes0 == 2 * nbytes
        want = {f"{op},{axis}": {"calls": 1, "bytes": nbytes}}
        assert got_stats == {0: want, 1: want}
