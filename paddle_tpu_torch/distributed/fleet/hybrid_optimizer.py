"""``HybridParallelOptimizer`` and ``HybridParallelClipGrad`` of the
PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``; reference
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:275).

The JAX package's arrays are global, so its clip sees whole gradients.
Here a rank holds shards: a model-parallel parameter (``is_distributed``,
set by fleet's mp layers) holds its part of the tensor on each mp rank,
and the ZeRO stages hand the optimizer dim-0 chunks. The global norm
counts every element once: an mp-split shard counts on its rank, a
parameter replicated over mp only on mp rank 0, and the sum of squares is
all_reduced over the model-parallel group after the sharding group's sum
(``_norm_split``). Under pipeline parallelism every parameter lives on
one stage, and the sum is all_reduced over the pp group as well (after
mp's). On the card that split runs inside kernel D's eager form (its
``owned`` flags and ``reduce`` between the two launches). ``stats`` (a
dict, None by default) tallies those all_reduces by "op,axis", as the
pipeline's step reads them.
Gradients are averaged over the data-parallel group by ``DataParallel``
(``fleet.distributed_model``), not here."""
from .. import collective
from ...nn.clip import ClipGradByGlobalNorm
from .topology import get_hcg

__all__ = ["HybridParallelClipGrad", "HybridParallelOptimizer"]


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip of ``clip`` (its ``clip_norm``) over the
    hybrid group ``hcg``'s model-parallel shards."""

    def __init__(self, clip, hcg=None):
        super().__init__(getattr(clip, "clip_norm", 1.0))
        self._hcg = hcg or get_hcg()
        self.stats = None

    def _norm_split(self, params, owned, reduce):
        hcg = self._hcg
        if hcg is None:
            return owned, reduce
        mp = hcg.get_model_parallel_world_size() > 1
        pp = hcg.get_pipe_parallel_world_size() > 1
        if not (mp or pp):
            return owned, reduce
        if mp:
            first = hcg.get_model_parallel_rank() == 0
            # ``is True``: a torch tensor's own ``is_distributed`` is a
            # method
            owned = [o and (getattr(p, "is_distributed", False) is True
                            or first) for p, o in zip(params, owned)]
        inner = reduce

        def hybrid_reduce(t):
            if inner is not None:
                t = inner(t)
            if mp:
                t = collective.all_reduce(
                    t, group=hcg.get_model_parallel_group(), axis="mp",
                    stats=self.stats)
            if pp:
                t = collective.all_reduce(
                    t, group=hcg.get_pipe_parallel_group(), axis="pp",
                    stats=self.stats)
            return t
        return owned, hybrid_reduce


class HybridParallelOptimizer:
    """``optimizer`` under the hybrid topology: a global-norm clip
    becomes ``HybridParallelClipGrad``, and with a sharding degree above
    1 the step runs through ``DygraphShardingOptimizer`` (stage 1)."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner = optimizer
        self._hcg = hcg or get_hcg()
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm) \
                and not isinstance(clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(clip, self._hcg)
        if self._hcg is not None \
                and self._hcg.get_sharding_parallel_world_size() > 1:
            from .sharding import DygraphShardingOptimizer
            self._inner = DygraphShardingOptimizer(optimizer, self._hcg)

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()

    def clear_grad(self, *a, **k):
        self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
