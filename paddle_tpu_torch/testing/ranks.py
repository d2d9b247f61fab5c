"""Ranks that are threads of one process: the CPU test bed of the port's
mesh and of tensor-parallel serving (every rank a thread with a gloo
group over one ``HashStore``).

A real deployment runs one process a rank (``examples/
torch_llama_pretrain_sharded.py`` over a ``FileStore``); threads let a
test hold eight ranks in one interpreter. Each rank needs its own model
instance: the training step's ``functional_call`` patches the module's
attributes while it runs. Each rank runs its torch operations on one
intra-op thread (the count is restored at ``join``): ranks that share a
process's intra-op pool would otherwise reduce in an order that depends
on what the other ranks run at the same time, where a rank that is a
process of its own does not.

Each rank's group lives until ``join``: gloo's constructor returns on a
rank once its own pairs are connected, while a peer may still be in its
handshake with it, and a rank whose ``fn`` returns at once would
otherwise drop its group and close those pairs under the peer (the peer
then fails in ``connectFullMesh`` with "Connection closed by peer", or
hangs in it)."""
import threading

__all__ = ["ThreadRankSet", "run_thread_ranks"]


class ThreadRankSet:
    """``fn(rank, group)`` started on a thread for each rank of `ranks`
    (default all) of a world of `world`, each with a gloo group of
    `world` ranks over one store (every operation bounded by `timeout`
    seconds). A rank left out is the caller's own: ``group(rank)`` gives
    it its group. ``join(wait)`` returns {rank: result}."""

    def __init__(self, world, fn, timeout=60.0, ranks=None):
        import torch.distributed as dist
        import torch
        self.world, self.timeout = world, timeout
        self.store = dist.HashStore()
        self.results, self.errors = {}, {}
        self._groups = {}           # rank -> its group, kept until join()
        self._threads_before = torch.get_num_threads()

        def body(rank):
            try:
                torch.set_num_threads(1)
                group = self._groups[rank] = self.group(rank)
                self.results[rank] = fn(rank, group)
            except BaseException as e:      # read by join()
                self.errors[rank] = e

        self.threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                         name=f"rank{r}")
                        for r in (range(world) if ranks is None else ranks)]
        for t in self.threads:
            t.start()

    def group(self, rank):
        from ..distributed.collective import new_group
        return new_group(rank, self.world, self.store, timeout=self.timeout)

    def join(self, wait):
        """Wait up to `wait` seconds a thread; a rank still running, or
        one that raised, makes this raise (the first error, with every
        failing rank named)."""
        import torch
        for t in self.threads:
            t.join(wait)
        torch.set_num_threads(self._threads_before)
        self._groups.clear()
        alive = [t.name for t in self.threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"thread ranks still running: {alive}")
        if self.errors:
            first = min(self.errors)
            raise RuntimeError(
                f"ranks {sorted(self.errors)} failed; rank {first}: "
                f"{self.errors[first]!r}") from self.errors[first]
        return dict(self.results)


def run_thread_ranks(world, fn, timeout=60.0):
    """``fn(rank, group)`` on `world` threads (``ThreadRankSet``); returns
    the results in rank order. A rank that raised makes this raise; a
    rank still running after 4 x `timeout` too."""
    out = ThreadRankSet(world, fn, timeout).join(4 * timeout)
    return [out[r] for r in range(world)]
