"""``fleet`` of the PyTorch port (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``; reference
python/paddle/distributed/fleet/fleet.py:218): the hybrid topology
(``init``, ``DistributedStrategy``, ``HybridCommunicateGroup``), the
tensor- and sequence-parallel layers (``mp_layers``, ``sp_layers``),
context parallelism over the sep axis (``context_parallel``:
``ring_attention``, ``ulysses_attention``, ``split_sequence``,
``SegmentParallel``),
activation recompute (``recompute``, ``recompute_sequential``,
``recompute_hybrid``), the training mesh's sharded compute (``sharded``:
ZeRO-3 over fsdp, Megatron over mp), the eager loop's wrappers
(``distributed_model``: ``TensorParallel`` with a model axis, else
``DataParallel`` and its bucketed ``reducer``; ``distributed_optimizer``:
``HybridParallelOptimizer`` with ``HybridParallelClipGrad``), the ZeRO
stages (``sharding``: ``DygraphShardingOptimizer``,
``GroupShardedStage2`` / ``3``, ``group_sharded_parallel``) and pipeline
parallelism over the pp axis (``pipeline_parallel``: ``PipelineLayer``,
``LayerDesc``, ``SharedLayerDesc``, ``PipelineParallel``,
``ZeroBubblePipelineParallel``, ``WeightGradStore``,
``split_weight_grad``; ``pipeline_schedule``: the 1F1B, FThenB, VPP and
ZB-H1 runners under the JAX names and ``stack_stage_params``).

``init`` takes the caller's world group and device (``group=``,
``device=``), as the port's mesh does; nothing here calls
``init_process_group``.
"""
from . import sharded  # noqa: F401
from .context_parallel import (SegmentParallel, ring_attention,  # noqa
                               split_sequence, ulysses_attention)
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa
                        RowParallelLinear, TensorParallel,
                        VocabParallelEmbedding, parallel_cross_entropy,
                        shard_state_from_numpy)
from .recompute import (recompute, recompute_hybrid,  # noqa: F401
                        recompute_sequential)
from .hybrid_optimizer import (HybridParallelClipGrad,  # noqa: F401
                               HybridParallelOptimizer)
from .pipeline_parallel import (LayerDesc, PipelineLayer,  # noqa: F401
                                PipelineParallel, SharedLayerDesc,
                                WeightGradStore,
                                ZeroBubblePipelineParallel,
                                split_weight_grad)
from .pipeline_schedule import (pipeline_1f1b, pipeline_gpipe,  # noqa
                                pipeline_interleaved, pipeline_zero_bubble,
                                stack_stage_params)
from .sharding import (DygraphShardingOptimizer,  # noqa: F401
                       GroupShardedStage2, GroupShardedStage3,
                       group_sharded_parallel)
from .sp_layers import (ColumnSequenceParallelLinear,  # noqa: F401
                        RowSequenceParallelLinear, all_gather_sequence,
                        mark_as_sequence_parallel_parameter,
                        reduce_scatter_sequence)
from .topology import (AXES, CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, get_hcg, set_hcg)
from ..mesh import ProcessMesh, set_mesh

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid",
           "CommunicateTopology", "HybridCommunicateGroup",
           "DistributedStrategy", "init", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "TensorParallel", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear", "HybridParallelOptimizer",
           "HybridParallelClipGrad", "DygraphShardingOptimizer",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "ring_attention", "ulysses_attention",
           "split_sequence", "SegmentParallel", "PipelineLayer",
           "LayerDesc", "SharedLayerDesc", "PipelineParallel",
           "ZeroBubblePipelineParallel", "WeightGradStore",
           "split_weight_grad", "pipeline_1f1b", "pipeline_gpipe",
           "pipeline_interleaved", "pipeline_zero_bubble",
           "stack_stage_params"]


class DistributedStrategy:
    """Knob bundle (reference: distributed_strategy.proto wrapped by
    fleet/base/distributed_strategy.py); plain attributes, as in the JAX
    package. ``init`` reads ``hybrid_configs``."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
            "pp_configs": {},
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False


def init(role_maker=None, is_collective=False, strategy=None, log_level=None,
         group=None, device="cuda"):
    """Build this rank's ``HybridCommunicateGroup`` from the strategy's
    ``hybrid_configs`` over the caller's world group (``group``: a
    ``collective.new_group`` group or a ``torch.distributed`` one; None
    for a world of one rank) on ``device``, make it this thread's
    (``get_hybrid_communicate_group``) and return it. The pp axis is the
    mesh's (``get_stage_id``, ``get_pipe_parallel_group``)."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    hcg = HybridCommunicateGroup(
        dp_degree=hc.get("dp_degree", 1), mp_degree=hc.get("mp_degree", 1),
        pp_degree=hc.get("pp_degree", 1),
        sharding_degree=hc.get("sharding_degree", 1),
        sep_degree=hc.get("sep_degree", 1), group=group, device=device)
    set_hcg(hcg)
    set_mesh(ProcessMesh(hcg.mesh))
    hcg.strategy = strategy
    return hcg


def get_hybrid_communicate_group():
    return get_hcg()


def distributed_model(model):
    """The parallel wrapper of ``model`` (reference fleet/model.py):
    ``PipelineParallel`` with a pp degree above 1 (the schedule of the
    strategy's ``pp_configs``); else with a sep degree above 1, ``DataParallel`` over the data and sep
    axes (``get_dp_sep_parallel_group``: each rank's gradients of its
    rows and sequence block averaged, as the reference's sep-axis
    all_reduce does; the JAX package's pick needs none, its one program
    reducing over the global batch); else ``TensorParallel`` when the
    model-parallel degree is above 1, and ``DataParallel`` over the
    data-parallel group otherwise, as the JAX package picks them."""
    hcg = get_hcg()
    if hcg is None:
        raise RuntimeError("call fleet.init first")
    if hcg.get_pipe_parallel_world_size() > 1:
        return PipelineParallel(model, hcg, getattr(hcg, "strategy", None))
    from ..parallel import DataParallel
    if hcg.get_sep_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_dp_sep_parallel_group())
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg)
    return DataParallel(model, group=hcg.get_data_parallel_group())


def distributed_optimizer(optimizer, strategy=None):
    """``HybridParallelOptimizer`` around ``optimizer`` on this thread's
    hybrid group: the clip over the model-parallel shards and the
    pipeline's stages, and ZeRO stage 1 with a sharding degree above
    1."""
    hcg = get_hcg()
    if hcg is None:
        raise RuntimeError("call fleet.init first")
    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or getattr(hcg, "strategy",
                                                       None))
