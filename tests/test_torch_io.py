"""The PyTorch port's ``io`` (datasets, samplers and the ``DataLoader`` on
``torch.utils.data``) held against the JAX package's ``paddle_tpu.io`` on
the CPU: with ``shuffle=False`` the batches are the same values, with and
without workers, with the default and a custom collate, ``drop_last``
and iterable datasets; ``instrument=True`` counts
``train_data_batches_total`` and hands waits to the health monitor.
Exact comparisons throughout (the loaders only move data); the JAX
package's 64-bit integers come back 32-bit (its x64 is off), the port's
stay 64-bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu_torch.io as tio  # noqa: E402
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch.observability import train_health as tth  # noqa: E402


def _samples(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 128, 6).astype(np.int32),
             "labels": rng.integers(0, 128, 6).astype(np.int64),
             "w": float(rng.random()), "k": int(i)} for i in range(n)]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    # the JAX package runs with 64-bit types off: its int64 batches come
    # back int32 (values equal), the port's stay int64
    canon = {np.dtype(np.int64): np.dtype(np.int32),
             np.dtype(np.float64): np.dtype(np.float32)}
    return b.dtype in (a.dtype, canon.get(a.dtype)) and np.array_equal(a, b)


def _stack(rows):
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("batch_size,drop_last", [(3, False), (3, True),
                                                  (5, False), (1, False)])
@pytest.mark.parametrize("collate", ["default", "custom"])
def test_batches_equal_the_jax_loader(workers, batch_size, drop_last,
                                      collate):
    data = _samples()
    kw = dict(batch_size=batch_size, drop_last=drop_last, shuffle=False,
              collate_fn=_stack if collate == "custom" else None)
    want = list(jio.DataLoader(data, **kw))
    loader = tio.DataLoader(data, num_workers=workers, **kw)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    assert all(_same(g, w) for g, w in zip(got, want))
    if collate == "default":
        assert isinstance(got[0]["input_ids"], torch.Tensor)
        assert got[0]["input_ids"].dtype == torch.int32
        assert got[0]["w"].dtype == torch.float32
        assert got[0]["k"].dtype == torch.int64


class _Stream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(np.arange(self.n, dtype=np.int64).reshape(-1, 1)
                    .tolist())


class _JStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(np.arange(self.n, dtype=np.int64).reshape(-1, 1)
                    .tolist())


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_datasets_batch_as_in_the_jax_loader(drop_last):
    want = list(jio.DataLoader(_JStream(7), batch_size=3,
                               drop_last=drop_last))
    got = list(tio.DataLoader(_Stream(7), batch_size=3, drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    assert all(_same(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(7), batch_size=3))


def test_samplers_and_datasets_equal_the_jax_package():
    data = list(range(11))
    for kw in (dict(batch_size=4), dict(batch_size=4, drop_last=True)):
        assert list(tio.BatchSampler(data, **kw)) == \
            list(jio.BatchSampler(data, **kw))
        assert len(tio.BatchSampler(data, **kw)) == \
            len(jio.BatchSampler(data, **kw))
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank)
        assert list(tio.DistributedBatchSampler(data, **kw)) == \
            list(jio.DistributedBatchSampler(data, **kw))
    assert list(tio.SequenceSampler(data)) == list(jio.SequenceSampler(data))
    shuffled = [i for b in tio.BatchSampler(data, shuffle=True, batch_size=3)
                for i in b]
    assert sorted(shuffled) == data
    a, b = tio.TensorDataset([np.arange(6), np.arange(6) * 2]), \
        jio.TensorDataset([np.arange(6), np.arange(6) * 2])
    assert len(a) == len(b) and a[4] == b[4]
    cat = tio.ConcatDataset([data[:4], data[4:]])
    assert [cat[i] for i in range(-3, 11)] == \
        [jio.ConcatDataset([data[:4], data[4:]])[i] for i in range(-3, 11)]
    parts = tio.random_split(data, [0.5, 0.5],
                             generator=torch.Generator().manual_seed(0))
    assert sorted(parts[0].indices + parts[1].indices) == data
    assert tio.get_worker_info() is None


def test_instrumented_loader_counts_batches_and_feeds_the_monitor():
    reg = tobs.get_registry()
    before = reg.counter("train_data_batches_total").value
    tth.pop_data_wait()
    mon = tth.TrainHealthMonitor(data_stall_s=1e-9,
                                 flight_recorder=tobs.FlightRecorder())
    loader = tio.DataLoader(_samples(8), batch_size=4, num_workers=2,
                            instrument=True, collate_fn=_stack)
    loader.health_monitor = mon
    got = list(loader)
    assert len(got) == 2
    assert reg.counter("train_data_batches_total").value == before + 2
    assert mon.breach_counts == {"data_stall": 1}    # every wait > 1 ns
    assert tth.pop_data_wait() > 0
    assert loader._queue_depth() == 0                # no live iterator
    assert list(tio.DataLoader(_samples(8), batch_size=4,
                               collate_fn=_stack))[1]["k"].tolist() == \
        [4, 5, 6, 7]
