"""paddle.io surface of the PyTorch port (counterpart of ``paddle_tpu/io``):
datasets, samplers and a ``DataLoader`` built on ``torch.utils.data``."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, get_worker_info, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      SubsetRandomSampler, WeightedRandomSampler)
