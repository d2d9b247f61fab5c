"""Samplers of the PyTorch port (counterpart of
``paddle_tpu/io/sampler.py``, numpy only): paddle's samplers and batch
samplers, including ``DistributedBatchSampler``."""
import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self._rng = np.random.default_rng()

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(self._rng.integers(0, n, self.num_samples).tolist())
        return iter(self._rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self._rng = np.random.default_rng()

    def __iter__(self):
        return iter([self.indices[i]
                     for i in self._rng.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.default_rng().choice(
            len(self.weights), size=self.num_samples,
            replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the sample space across data-parallel ranks.
    Without ``num_replicas`` / ``rank`` they come from the initialized
    ``torch.distributed`` process group (one rank when there is none)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            up = dist.is_available() and dist.is_initialized()
            num_replicas = num_replicas or (dist.get_world_size() if up
                                            else 1)
            rank = rank if rank is not None else (dist.get_rank() if up
                                                  else 0)
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]  # pad to even shards
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
