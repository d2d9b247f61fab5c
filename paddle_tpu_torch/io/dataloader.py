"""DataLoader of the PyTorch port (counterpart of
``paddle_tpu/io/dataloader.py``).

Paddle's ``DataLoader`` surface on ``torch.utils.data.DataLoader``:
``batch_size`` / ``shuffle`` / ``drop_last`` build paddle's
``BatchSampler`` (or a ``batch_sampler`` is taken as given), and
``num_workers`` > 0 runs torch's worker processes with their prefetch
(``prefetch_factor`` batches a worker), where the JAX package runs a
thread or its own shared-memory rings. Workers only collate host data:
the default collate stacks numpy arrays and numbers into CPU tensors, and
a custom ``collate_fn`` runs in the worker as it is. A worker must not
touch CUDA (torch starts them by fork on Linux).

An ``IterableDataset`` is read whole by each worker, as torch's loader
reads one: shard it in ``__iter__`` by ``get_worker_info()``.

``instrument=True`` routes iteration through
``observability.train_health.instrument_loader`` (wait histogram,
``data_wait`` spans, batch counter, queue depth and the stall detector,
through ``health_monitor`` when one is attached), as the JAX package's
loader does. For ``shuffle=False`` the batches are the JAX package's
loader's batches.
"""
import collections.abc

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack a list of samples into a batch: numpy arrays and tensors
    into one tensor, ints into int64 and floats into float32 tensors,
    strings into a list, mappings and sequences field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (bool, np.bool_)):
        return torch.from_numpy(np.asarray(batch, dtype=np.bool_))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, collections.abc.Mapping):
        return {k: default_collate_fn([s[k] for s in batch])
                for k in sample}
    if isinstance(sample, collections.abc.Sequence):
        return [default_collate_fn(list(col)) for col in zip(*batch)]
    raise TypeError(f"cannot collate {type(sample)}")


class _IterableBatches(torch.utils.data.IterableDataset):
    """An iterable dataset's samples grouped into lists of ``batch_size``
    (the last one kept unless ``drop_last``), for a loader that collates
    each list."""

    def __init__(self, dataset, batch_size, drop_last):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class DataLoader:
    """Batches of ``dataset`` (a map-style dataset, any sequence, or an
    ``IterableDataset``). ``feed_list``, ``places``, ``return_list``,
    ``use_buffer_reader`` and ``use_shared_memory`` are taken for paddle's
    signature and change nothing (torch's workers share memory on their
    own)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, instrument=False):
        self.dataset = dataset
        self.instrument = bool(instrument)
        self.health_monitor = None      # TrainHealthMonitor, optional
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self._iterable = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable:
            self.batch_sampler = None
            source = _IterableBatches(dataset, batch_size, drop_last)
            sampler_kw = dict(batch_size=None)
        else:
            self.batch_sampler = batch_sampler if batch_sampler is not None \
                else BatchSampler(dataset, shuffle=shuffle,
                                  batch_size=batch_size, drop_last=drop_last)
            source = dataset
            sampler_kw = dict(batch_sampler=self.batch_sampler)
        workers = {}
        if self.num_workers > 0:
            workers = dict(prefetch_factor=self.prefetch_factor,
                           persistent_workers=bool(persistent_workers))
        self._loader = torch.utils.data.DataLoader(
            source, collate_fn=self.collate_fn, num_workers=self.num_workers,
            timeout=timeout, worker_init_fn=worker_init_fn, **sampler_kw,
            **workers)
        self._live = None

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self.instrument:
            # lazy import: the observability stack loads only when the
            # caller asks for the telemetry
            from ..observability import train_health as _th
            return _th.instrument_loader(
                self._iter_impl(), monitor=self.health_monitor,
                queue_depth=self._queue_depth)
        return self._iter_impl()

    def _queue_depth(self):
        """Batches the workers hold ready or in flight (0 without
        workers)."""
        it = self._live
        if it is None:
            return 0
        sent = getattr(it, "_send_idx", None)
        rcvd = getattr(it, "_rcvd_idx", None)
        return 0 if sent is None or rcvd is None else max(0, sent - rcvd)

    def _iter_impl(self):
        it = iter(self._loader)
        self._live = it
        try:
            yield from it
        finally:
            self._live = None
