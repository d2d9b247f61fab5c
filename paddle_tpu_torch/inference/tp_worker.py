"""Tensor-parallel serving's rank protocol: rank 0 leads, every other
rank follows.

The JAX package drives all of its devices from one controller, so it has
no counterpart of this module. Here each rank is a process (or, in
tests, a thread) holding the same ``torch.distributed`` group. Rank 0
holds the scheduler (``ContinuousBatchingEngine``, the stepper, the
gateway, the router); the scheduler reaches the engine only through
``new_paged_caches`` and the three paged programs (``_paged_step``,
``_paged_rewind``, ``_paged_copy``). Under tp each of those, on rank 0,
first broadcasts one op to the other ranks — a fixed header of int64
fields, then, where the op has host inputs, one int64 payload — and then
runs rank 0's own shard. A follower's ``serve_follower`` receives each op
and runs the same ``_paged_*_impl`` on its own shard, so the ranks meet
in the same all_reduces of the decoder stack. Followers hold weights and
cache shards and no scheduler; only rank 0 samples.

Header fields: ``[op, cache set id, payload length, dropped cache sets,
f0, f1, f2, f3]``. The payload carries the op's host arrays (for a step:
the token slab, the query spans, the block tables and the lengths; for
a rewind: the tables and both length rows), then the ids of cache sets
rank 0 has dropped since its last op (``TPCaches`` notes them when the
scheduler lets go of its caches), which every follower forgets.

A follower waits for the next op as long as ``idle_timeout`` allows (a
server between requests is idle); everything inside an op keeps the
group's timeout, so a rank that died or hangs makes the others raise.
The headers live where the group's backend takes them: the host for
gloo, the card for nccl.
"""
import weakref

import numpy as np
import torch

from ..distributed.collective import broadcast

__all__ = ["OP_STOP", "OP_CACHES", "OP_STEP", "OP_REWIND", "OP_COPY",
           "TPCaches", "send_caches", "send_step", "send_rewind",
           "send_copy", "send_stop", "serve_follower"]

OP_STOP, OP_CACHES, OP_STEP, OP_REWIND, OP_COPY = 0, 1, 2, 3, 4
_HEADER = 8
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# a follower with no idle bound still passes gloo a finite wait
_IDLE_FOREVER_S = 30 * 24 * 3600.0


class TPCaches(list):
    """Rank 0's per-layer cache shards under tp, named `tp_id` for the
    followers. When the scheduler drops the set, its id lands in `dead`
    and the next op tells the followers to free theirs."""

    def __init__(self, caches, tp_id, dead):
        super().__init__(caches)
        self.tp_id = tp_id
        weakref.finalize(self, dead.append, tp_id)


def _comm_device(engine):
    return engine.device if engine.group.name() == "nccl" \
        else torch.device("cpu")


def _send(engine, op, cid=0, fields=(), arrays=()):
    """Rank 0: broadcast one op (header, then payload) to the group."""
    dead = engine._tp_dead_caches
    freed = [dead.pop() for _ in range(len(dead))]
    parts = [np.asarray(a, np.int64).reshape(-1) for a in arrays]
    n_payload = sum(p.size for p in parts)
    hdr = [op, cid, n_payload, len(freed)] + [int(f) for f in fields]
    hdr += [0] * (_HEADER - len(hdr))
    dev = _comm_device(engine)
    broadcast(torch.tensor(hdr, dtype=torch.long, device=dev), 0,
              group=engine.group)
    if n_payload + len(freed):
        payload = np.concatenate(parts + [np.asarray(freed, np.int64)])
        broadcast(torch.from_numpy(payload).to(dev), 0, group=engine.group)


def _recv(engine, idle_timeout):
    """A follower: (op, cache set id, fields, payload, freed ids)."""
    dev = _comm_device(engine)
    hdr = torch.zeros(_HEADER, dtype=torch.long, device=dev)
    broadcast(hdr, 0, group=engine.group,
              timeout=_IDLE_FOREVER_S if idle_timeout is None
              else idle_timeout)
    op, cid, n_payload, n_freed, *fields = hdr.tolist()
    payload = np.zeros(0, np.int64)
    if n_payload + n_freed:
        buf = torch.zeros(n_payload + n_freed, dtype=torch.long, device=dev)
        broadcast(buf, 0, group=engine.group)
        payload = buf.cpu().numpy()
    return op, cid, fields, payload[:n_payload], payload[n_payload:]


def _cid(caches):
    cid = getattr(caches, "tp_id", None)
    if cid is None:
        raise ValueError("tensor-parallel paged programs take the caches "
                         "of this engine's new_paged_caches()")
    return cid


def send_caches(engine, cid, num_blocks, block_size, dtype):
    _send(engine, OP_CACHES, cid,
          (num_blocks, block_size, _DTYPES.index(dtype)))


def send_step(engine, caches, toks, qlens, tables, lens):
    toks, tables = np.asarray(toks), np.asarray(tables)
    _send(engine, OP_STEP, _cid(caches),
          toks.shape + (tables.shape[1],), (toks, qlens, tables, lens))


def send_rewind(engine, caches, tables, new_lens, old_lens, span):
    tables = np.asarray(tables)
    _send(engine, OP_REWIND, _cid(caches), tables.shape + (span,),
          (tables, new_lens, old_lens))


def send_copy(engine, caches, src_block, dst_block):
    _send(engine, OP_COPY, _cid(caches), (src_block, dst_block))


def send_stop(engine):
    _send(engine, OP_STOP)


def _split(payload, *shapes):
    out, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(payload[at:at + n].reshape(shape))
        at += n
    return out


def serve_follower(engine, idle_timeout=None):
    """Replay rank 0's ops on `engine` (a rank > 0 of a tp group) until
    it sends OP_STOP. Returns {"steps", "rewinds", "copies", "caches"}:
    the ops replayed, and the bytes of the last cache set allocated
    (``cache_bytes``)."""
    if engine.tp == 1 or engine.rank == 0:
        raise ValueError("serve_follower runs on the ranks > 0 of a "
                         "tensor-parallel engine")
    sets = {}
    stats = {"steps": 0, "rewinds": 0, "copies": 0, "caches": 0,
             "cache_bytes": 0}
    with torch.no_grad():
        while True:
            op, cid, f, payload, freed = _recv(engine, idle_timeout)
            for dead in freed.tolist():
                sets.pop(dead, None)
            if op == OP_STOP:
                break
            if op == OP_CACHES:
                sets[cid] = engine._alloc_paged_caches(f[0], f[1],
                                                       _DTYPES[f[2]])
                stats["caches"] += 1
                stats["cache_bytes"] = sum(c.numel() * c.element_size()
                                           for c in sets[cid])
            elif op == OP_STEP:
                b, c, m = f[0], f[1], f[2]
                toks, qlens, tables, lens = _split(payload, (b, c), (b,),
                                                   (b, m), (b,))
                engine._paged_step_impl(
                    engine._w, sets[cid], toks, qlens.astype(np.int32),
                    None, tables.astype(np.int32), lens.astype(np.int32),
                    None, None, 0.0, 1.0, None)
                stats["steps"] += 1
            elif op == OP_REWIND:
                b, m, span = f[0], f[1], f[2]
                tables, new_l, old_l = _split(payload, (b, m), (b,), (b,))
                engine._paged_rewind_impl(sets[cid], tables.astype(np.int32),
                                          new_l.astype(np.int32),
                                          old_l.astype(np.int32), span)
                stats["rewinds"] += 1
            elif op == OP_COPY:
                engine._paged_copy_impl(sets[cid], f[0], f[1])
                stats["copies"] += 1
            else:
                raise RuntimeError(f"tensor-parallel follower: unknown op "
                                   f"{op}")
    return stats
