"""Datasets of the PyTorch port (counterpart of ``paddle_tpu/io/dataset.py``).

``Dataset`` and ``IterableDataset`` derive from their ``torch.utils.data``
namesakes, so ``DataLoader`` hands them to torch's loader as they are."""
import bisect

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ConcatDataset",
           "ChainDataset", "Subset", "random_split", "ComposeDataset",
           "get_worker_info"]


class Dataset(torch.utils.data.Dataset):
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(torch.utils.data.IterableDataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split ``dataset`` into ``Subset``s of ``lengths`` (counts, or
    fractions that sum to 1) over a random permutation drawn from
    ``generator`` (a ``torch.Generator``; default: torch's)."""
    if all(isinstance(n, float) for n in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * f)) for f in lengths]
        counts[0] += n - sum(counts)
        lengths = counts
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = torch.randperm(len(dataset), generator=generator).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


class ComposeDataset(Dataset):
    """Zip map-style datasets: sample i concatenates the fields of each
    dataset's sample i."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        self._len = min(len(d) for d in self.datasets)

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(sample)


def get_worker_info():
    """Inside a DataLoader worker: its (id, num_workers, dataset, seed);
    None in the main process."""
    return torch.utils.data.get_worker_info()
