"""Tensor-parallel layers of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py``; reference
python/paddle/distributed/fleet/layers/mpu/mp_layers.py).

The JAX package keeps each weight as one array sharded over the mesh's
"model" axis and lets XLA place the collectives. Here every rank holds
its own shard of the whole parameter as a ``torch.nn.Module``'s
parameter, and the collectives are ``torch.autograd.Function``s on the
model-parallel group of ``fleet.init``'s ``HybridCommunicateGroup``:
the operators of ``sharded._MpRegion``, which the training mesh's
Megatron modules use too.

* ``ColumnParallelLinear`` holds ``weight[:, cols]`` and ``bias[cols]``;
  the input enters with ``enter`` (identity forward, all_reduce of its
  gradient), and ``gather_output`` all-gathers the columns.
* ``RowParallelLinear`` holds ``weight[rows, :]`` and the whole bias,
  added after the ``leave`` all_reduce; an input that is not parallel
  (``input_is_parallel=False``) is split first.
* ``VocabParallelEmbedding`` holds rows ``[start, start + V / mp)`` of
  the table: a masked local lookup, all_reduced.
* ``ParallelCrossEntropy`` takes this rank's logits ``[..., V / mp]``
  and never gathers them: kernel C's vocab-sharded form
  (``ops.token_ce.token_ce_fwd_partial``: the CUDA kernel on the card,
  its plain version on the CPU) gives each row's max, sum of exps and
  target logit on the shard, and two all_reduces over the model group
  (a max, then one sum) combine them (``ops.token_ce.combine_partials``);
  the backward is C's backward kernel with the combined stats.
* ``TensorParallel`` wraps a model (the JAX package's passthrough).

A width or vocabulary that the model-parallel degree does not divide
raises, as the JAX shard does. Initial weights: every rank draws the
same whole tensor from a generator seeded with ``seed`` (the JAX
package's initializers: Xavier normal for the linear weights, zero
biases, N(0, 0.02) for the table) and keeps its shard;
``shard_state_from_numpy`` loads the whole arrays of a JAX layer
instead.
"""
import math

import numpy as np
import torch

from ...ops import token_ce as _tc
from .sharded import _MpRegion
from .topology import get_hcg

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "TensorParallel", "parallel_cross_entropy", "model_region",
           "shard_state_from_numpy"]


def _hcg():
    hcg = get_hcg()
    if hcg is None:
        raise RuntimeError("call fleet.init(is_collective=True) first")
    return hcg


def model_region():
    """The model-parallel operators (``sharded._MpRegion``) of this
    thread's hybrid group (``fleet.init``'s)."""
    return _MpRegion(_hcg().mesh, None)


def _split(name, n, parts):
    if n % parts:
        raise ValueError(f"{name}: {n} does not split evenly over the "
                         f"model-parallel degree {parts}")
    return n // parts


def _xavier(shape, gen):
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    return torch.randn(shape, generator=gen) * std


class _ShardedModule(torch.nn.Module):
    """A module whose parameters are shards of whole tensors:
    ``_mp_dims`` {parameter name: the dim split over the model axis, or
    None for a whole copy}."""

    _mp_dims = {}

    def _init_region(self):
        self.region = model_region()
        self.nranks = self.region.size
        self.device = self.region.mesh.device

    def _param(self, name, whole):
        """Register this rank's shard of the whole tensor ``whole``."""
        dim = self._mp_dims.get(name)
        t = whole
        if dim is not None:
            t = whole.chunk(self.nranks, dim)[self.region.rank]
        param = torch.nn.Parameter(t.contiguous().to(self.device))
        # a shard of its own on each mp rank: the hybrid clip counts it on
        # every rank (Paddle's attribute)
        param.is_distributed = dim is not None and self.nranks > 1
        self.register_parameter(name, param)


class ColumnParallelLinear(_ShardedModule):
    """Weight [in, out] split on out (dim 1) over the model axis."""

    _mp_dims = {"weight": 1, "bias": 0}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 name=None, seed=0):
        super().__init__()
        self._init_region()
        _split("ColumnParallelLinear out_features", out_features,
               self.nranks)
        self.gather_output = gather_output
        self.out_features = out_features
        gen = torch.Generator().manual_seed(seed)
        self._param("weight", _xavier((in_features, out_features), gen))
        if has_bias:
            self._param("bias", torch.zeros(out_features))
        else:
            self.bias = None

    def forward(self, x):
        out = torch.matmul(self.region.enter(x), self.weight)
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = self.region.gather(out, -1)
        return out


class RowParallelLinear(_ShardedModule):
    """Weight [in, out] split on in (dim 0); the partial products are
    all_reduced, then the whole bias is added."""

    _mp_dims = {"weight": 0, "bias": None}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, name=None, seed=0):
        super().__init__()
        self._init_region()
        _split("RowParallelLinear in_features", in_features, self.nranks)
        self.input_is_parallel = input_is_parallel
        gen = torch.Generator().manual_seed(seed)
        self._param("weight", _xavier((in_features, out_features), gen))
        if has_bias:
            self._param("bias", torch.zeros(out_features))
        else:
            self.bias = None

    def forward(self, x):
        if not self.input_is_parallel:
            x = self.region.split(x, -1)
        out = self.region.leave(torch.matmul(x, self.weight))
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(_ShardedModule):
    """Table [V, E] split on its rows over the model axis: a masked local
    lookup, all_reduced (reference mp_layers.py:49, the c_embedding
    kernel)."""

    _mp_dims = {"weight": 0}

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, seed=0):
        super().__init__()
        self._init_region()
        self.num_embeddings = num_embeddings
        self.per_part = _split("VocabParallelEmbedding num_embeddings",
                               num_embeddings, self.nranks)
        self.start = self.region.rank * self.per_part
        gen = torch.Generator().manual_seed(seed)
        self._param("weight", torch.randn(
            (num_embeddings, embedding_dim), generator=gen) * 0.02)

    def forward(self, x):
        local = x.to(torch.int64) - self.start
        inr = (local >= 0) & (local < self.per_part)
        out = torch.nn.functional.embedding(
            local.clamp(0, self.per_part - 1), self.weight)
        out = torch.where(inr[..., None], out, torch.zeros_like(out))
        return self.region.leave(out)


class _ParallelCE(torch.autograd.Function):
    """Per-row loss of the whole rows from this rank's vocabulary shard
    x [N, V_r] (kernel C's vocab-sharded form); the backward writes the
    shard's dlogits with the combined stats."""

    @staticmethod
    def forward(ctx, x, labels, region, start, ignore):
        part = _tc.token_ce_fwd_partial(x, labels, start)
        loss, stats = _tc.combine_partials(
            part, labels, start, x.shape[1], ignore,
            lambda t: region.all_reduce(t, "max"), region.all_reduce)
        ctx.save_for_backward(x, labels, stats)
        ctx.args = (start, ignore)
        ctx.mark_non_differentiable(labels)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, labels, stats = ctx.saved_tensors
        start, ignore = ctx.args
        dx = _tc.token_ce_bwd(x, labels, stats, g.contiguous(), None,
                              ignore, 0.0, "none", start)
        return dx, None, None, None, None


def parallel_cross_entropy(logits, labels, region, ignore_index=-100,
                           label_smoothing=0.0):
    """Softmax cross entropy per row of logits split over the model axis:
    ``logits`` [..., V / mp] are this rank's columns [rank V / mp, (rank +
    1) V / mp) of every row, ``labels`` [...] (or [..., 1]) the whole
    vocabulary's ids; ``region`` the model-parallel operators
    (``model_region``). Returns the f32 loss of each row, shaped as
    ``labels``, on every rank; 0 where the label is ``ignore_index``.
    Label smoothing is refused: JAX's ``ParallelCrossEntropy`` has
    none."""
    if label_smoothing:
        raise NotImplementedError(
            "parallel_cross_entropy: label smoothing is not supported (the "
            "JAX package's ParallelCrossEntropy has none)")
    v_local = logits.shape[-1]
    shape = labels.shape
    lbl = labels.to(torch.int64).reshape(-1).contiguous()
    x = logits.reshape(-1, v_local)
    if x.stride(-1) != 1:
        x = x.contiguous()
    if lbl.shape[0] != x.shape[0]:
        raise ValueError(f"parallel_cross_entropy: {lbl.shape[0]} labels "
                         f"for {x.shape[0]} rows")
    loss = _ParallelCE.apply(x, lbl, region, region.rank * v_local,
                             int(ignore_index))
    return loss.reshape(shape)


class ParallelCrossEntropy(torch.nn.Module):
    """Vocab-split softmax cross entropy (reference mp_layers.py:744, the
    c_softmax_with_cross_entropy kernel): the max, the sum of exps and
    the target logit are exchanged over the model axis; the logits are
    never gathered."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.region = model_region()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return parallel_cross_entropy(input, label, self.region,
                                      self.ignore_index)


class TensorParallel(torch.nn.Module):
    """Model wrapper (reference meta_parallel/tensor_parallel.py:28).
    Every rank draws (or loads) the same whole weights and keeps its
    shards, so nothing is broadcast: as in the JAX package, a
    passthrough."""

    def __init__(self, layers, hcg=None, **kwargs):
        super().__init__()
        self._layers = layers
        self.hcg = hcg

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


def shard_state_from_numpy(module, whole_arrays):
    """Load whole numpy arrays ({parameter name: array}, the JAX layer's
    ``weight.numpy()`` and so on; names as ``module.named_parameters()``
    gives them) into ``module``: each parameter of a tensor-parallel layer
    takes this rank's shard, every other one the whole array. The key
    sets must match. Returns the module."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(whole_arrays))
    extra = sorted(set(whole_arrays) - set(own))
    if missing or extra:
        raise KeyError(f"shard_state_from_numpy: missing {missing}, "
                       f"unexpected {extra}")
    dims = {}
    for mname, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            dims[full] = (mod, getattr(mod, "_mp_dims", {}).get(pname))
    with torch.no_grad():
        for name, p in own.items():
            mod, dim = dims[name]
            whole = torch.from_numpy(np.array(whole_arrays[name],
                                              dtype=np.float32))
            if dim is not None:
                whole = whole.chunk(mod.nranks, dim)[mod.region.rank]
            if tuple(whole.shape) != tuple(p.shape):
                raise ValueError(f"shard_state_from_numpy: {name} has a "
                                 f"shard of {tuple(whole.shape)}, the "
                                 f"module {tuple(p.shape)}")
            p.copy_(whole.to(p.dtype))
    return module
