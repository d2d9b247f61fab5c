"""Megatron sequence parallelism of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/sp_layers.py``; reference
python/paddle/distributed/fleet/utils/sequence_parallel_utils.py:
AllGatherOp:111, ReduceScatterOp:127, ColumnSequenceParallelLinear:429,
RowSequenceParallelLinear:564).

Between tensor-parallel blocks the sequence dim is split over the model
axis: all_gather(seq) before the column-parallel product and
reduce_scatter(seq) after the row-parallel one. The JAX package writes
them in ``shard_map`` and lets JAX transpose each collective; here each
is a ``torch.autograd.Function`` of ``sharded._MpRegion`` on the
model-parallel group of ``fleet.init``'s ``HybridCommunicateGroup``,
with the transposed collective written out: all_gather's backward is a
reduce_scatter, reduce_scatter's an all_gather, ``scatter``'s (the
rank's slice) an all_gather.

The column layer holds ``weight[:, cols]`` (and ``bias[cols]``), the
row layer ``weight[rows, :]`` and the whole bias. The row layer's bias
is added to this rank's rows of the sequence only, so its gradient is
summed over the model axis (``mark_as_sequence_parallel_parameter``
marks it, and the ``enter`` operator sums it).
"""
import torch

from .mp_layers import _ShardedModule, _split, _xavier, model_region

__all__ = ["all_gather_sequence", "reduce_scatter_sequence", "scatter",
           "gather", "mark_as_sequence_parallel_parameter",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]


def all_gather_sequence(x, axis=0):
    """AllGatherOp: [S/p, ...] -> [S, ...] over the model axis (backward:
    reduce_scatter)."""
    return model_region().gather(x, axis, reduce=True)


def reduce_scatter_sequence(x, axis=0):
    """ReduceScatterOp: partial [S, ...] summed over the model axis and
    scattered -> [S/p, ...] (backward: all_gather)."""
    return model_region().reduce_scatter(x, axis)


def scatter(x, axis=0):
    """This rank's slice of the sequence dim (entry into the sequence
    parallel region; backward: all_gather)."""
    region = model_region()
    _split("scatter", x.shape[axis], region.size)
    return region.split(x, axis)


def gather(x, axis=0):
    return all_gather_sequence(x, axis=axis)


def mark_as_sequence_parallel_parameter(param):
    param.is_sequence_parallel = True


def _seq_axis(x):
    return 0 if x.dim() == 2 else 1


class ColumnSequenceParallelLinear(_ShardedModule):
    """all_gather(seq) -> x @ W[:, cols] (reference :429)."""

    _mp_dims = {"weight": 1, "bias": 0}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, name=None, seed=0):
        super().__init__()
        self._init_region()
        _split("ColumnSequenceParallelLinear out_features", out_features,
               self.nranks)
        gen = torch.Generator().manual_seed(seed)
        self._param("weight", _xavier((in_features, out_features), gen))
        if has_bias:
            self._param("bias", torch.zeros(out_features))
        else:
            self.bias = None

    def forward(self, x):
        x = self.region.gather(x, _seq_axis(x), reduce=True)
        out = torch.matmul(x, self.weight)
        return out if self.bias is None else out + self.bias


class RowSequenceParallelLinear(_ShardedModule):
    """x[..., rows] @ W[rows, :] -> reduce_scatter(seq) (reference
    :564)."""

    _mp_dims = {"weight": 0, "bias": None}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, name=None, seed=0):
        super().__init__()
        self._init_region()
        _split("RowSequenceParallelLinear in_features", in_features,
               self.nranks)
        gen = torch.Generator().manual_seed(seed)
        self._param("weight", _xavier((in_features, out_features), gen))
        if has_bias:
            self._param("bias", torch.zeros(out_features))
            mark_as_sequence_parallel_parameter(self.bias)
        else:
            self.bias = None

    def forward(self, x):
        out = self.region.reduce_scatter(torch.matmul(x, self.weight),
                                         _seq_axis(x))
        if self.bias is None:
            return out
        return out + self.region.enter(self.bias)
