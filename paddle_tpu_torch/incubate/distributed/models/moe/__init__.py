"""MoE of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed/models/moe``; reference
python/paddle/incubate/distributed/models/moe/): the capacity gates and
the MoE layer with expert parallelism over all_to_all."""
from .gate import (NaiveGate, SwitchGate, GShardGate, BaseGate,  # noqa: F401
                   topk_capacity_dispatch, topk_capacity_route)
from .moe_layer import (MoELayer, ExpertMLP, global_scatter,  # noqa: F401
                        global_gather, moe_state_from_numpy)
