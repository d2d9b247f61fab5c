"""The data-parallel gradient reducer of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/reducer.py``; reference EagerReducer,
paddle/fluid/distributed/collective/reducer.h:88).

Every rank computes the gradients of its own batch; the reducer averages
them over the data-parallel group while the backward runs:

- buckets are built back to front over the parameters, a new one when
  the next parameter would take the bucket past ``comm_buffer_size_mb``
  (or its dtype differs), as the JAX reducer builds them, so that the
  first bucket to fill is the one whose gradients arrive first;
- a parameter's ``register_post_accumulate_grad_hook`` marks it ready
  once its ``.grad`` is accumulated; when a bucket's last parameter is
  ready the bucket's gradients are copied into one flat buffer and its
  all_reduce is dispatched without waiting (``sync_op=False``), so it
  overlaps the rest of the backward;
- at the end of the backward (a callback queued on the autograd engine)
  incomplete buckets are dispatched too, the missing gradients as zeros,
  every dispatched reduce is waited for, divided by the group's size (the
  reference's reducer scales its fused buffer by 1 / nranks) and copied
  back into ``.grad``.

The average is taken of the whole accumulated ``.grad``: a value every
rank holds equally is left unchanged by it, so gradients accumulated over
several backwards (and over ``no_sync`` ones, which reduce nothing) are
reduced correctly by the next synchronised backward. With
``find_unused_parameters`` every bucket is reduced every backward, at
its end and in bucket order (other ranks may have used what this one did
not, so their buckets fill in another order), an unused parameter gets
its gradient from the reduce (zeros from this rank), and
``stats["unused"]`` lists the unused parameters' indices.
``torch.autograd.grad`` accumulates no ``.grad``, so it fires no hook and
leaves ``.grad`` alone, as the JAX reducer's ``in_grad_only_walk`` check
does.

``stats``: ``allreduce_calls`` and ``bytes`` (one call a bucket a
backward, summed over the backwards), ``events`` (the last backward's
("allreduce", bucket) in dispatch order) and ``unused``. A group of one
rank (or none) reduces nothing and fires nothing."""
import contextlib
import weakref

import torch

from .. import collective

__all__ = ["EagerReducer"]


class _Bucket:
    __slots__ = ("params", "nbytes", "ready", "dtype")

    def __init__(self, dtype):
        self.params, self.nbytes, self.ready = [], 0, set()
        self.dtype = dtype


class EagerReducer:
    def __init__(self, parameters, group=None, comm_buffer_size_mb=25,
                 find_unused_parameters=False):
        self.group = group
        self.nranks = group.size() if group is not None else 1
        self.find_unused = find_unused_parameters
        self._sync = True
        self.stats = {"allreduce_calls": 0, "bytes": 0, "events": [],
                      "unused": []}
        self.params = [p for p in parameters if p.requires_grad]
        cap = comm_buffer_size_mb * 1024 * 1024
        self.buckets = []
        cur = None
        for p in reversed(self.params):
            nb = p.numel() * p.element_size()
            if cur is None or (cur.params and cur.nbytes + nb > cap) \
                    or p.dtype != cur.dtype:
                cur = _Bucket(p.dtype)
                self.buckets.append(cur)
            cur.params.append(p)
            cur.nbytes += nb
        self._bucket_of = {id(p): bi for bi, b in enumerate(self.buckets)
                           for p in b.params}
        self._fired, self._pending, self._queued = set(), [], False
        wr = weakref.ref(self)
        self._hooks = [p.register_post_accumulate_grad_hook(
            self._make_hook(wr)) for p in self.params]

    # -- lifecycle -------------------------------------------------------
    def remove(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside accumulate local gradients and reduce
        nothing."""
        prev = self._sync
        self._sync = False
        try:
            yield
        finally:
            self._sync = prev

    # -- hooks -----------------------------------------------------------
    @staticmethod
    def _make_hook(wr):
        # weakref: a dropped reducer neither fires nor keeps its params
        def hook(p):
            r = wr()
            if r is not None:
                r._grad_ready(p)
        return hook

    def _grad_ready(self, p):
        if not self._sync or self.nranks == 1:
            return
        if not self._queued:
            self._queued = True
            self.stats["events"] = []
            torch.autograd.Variable._execution_engine.queue_callback(
                self._on_backward_end)
        self._fired.add(id(p))
        bi = self._bucket_of[id(p)]
        b = self.buckets[bi]
        b.ready.add(id(p))
        if len(b.ready) == len(b.params) and not self.find_unused:
            self._dispatch(bi)

    def _on_backward_end(self):
        self._queued = False
        done = {bi for bi, _, _ in self._pending}
        for bi, b in enumerate(self.buckets):
            if bi not in done and (b.ready or self.find_unused):
                self._dispatch(bi)
        if self.find_unused:
            self.stats["unused"] = [i for i, p in enumerate(self.params)
                                    if id(p) not in self._fired]
        for bi, flat, work in self._pending:
            work.wait()
            self._scatter(self.buckets[bi], flat.div_(self.nranks))
        self._pending = []
        self._fired = set()
        for b in self.buckets:
            b.ready.clear()

    # -- the fused reduce --------------------------------------------------
    def _dispatch(self, bi):
        """One flat all_reduce of bucket ``bi``'s gradients (zeros where
        a gradient is missing), not waited for."""
        b = self.buckets[bi]
        parts = [p.grad.reshape(-1) if p.grad is not None
                 else torch.zeros(p.numel(), dtype=b.dtype, device=p.device)
                 for p in b.params]
        flat = torch.cat(parts)
        work = collective.all_reduce(flat, group=self.group, sync_op=False)
        self.stats["allreduce_calls"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size()
        self.stats["events"].append(("allreduce", bi))
        self._pending.append((bi, flat, work))

    def _scatter(self, b, flat):
        off = 0
        for p in b.params:
            n = p.numel()
            part = flat[off:off + n].view(p.shape)
            off += n
            if p.grad is not None:
                p.grad.copy_(part)
            elif self.find_unused:
                p.grad = part.clone()
