"""``paddle.distributed.sharding`` of the PyTorch port (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``; reference
python/paddle/distributed/sharding/group_sharded.py:50, :149):
``group_sharded_parallel`` wraps a model and its optimizer in ZeRO stage
1 / 2 / 3 ("os" / "os_g" / "p_g_os", ``fleet.sharding``), and
``save_group_sharded_model`` saves the whole model (and optimizer)
state for a plain module to load."""
import os

import torch

from ..fleet.sharding import (  # noqa: F401
    DygraphShardingOptimizer, GroupShardedStage2, GroupShardedStage3,
    group_sharded_parallel)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def save_group_sharded_model(model, output, optimizer=None):
    """Save ``model``'s whole state to ``output/model.pdmodel`` and, with
    ``optimizer``, its whole state to ``output/model.pdopt``
    (``torch.save``; the keys of the unwrapped module and the JAX
    optimizer's keys). Wrappers are unwrapped, and a stage-3 model's or a
    sharded optimizer's chunks are gathered first: every rank of the
    sharding group calls this, and its rank 0 writes."""
    inner = model
    while isinstance(getattr(inner, "_layers", None), torch.nn.Module):
        inner = inner._layers
    state = inner.state_dict()
    opt_state = optimizer.state_dict() if optimizer is not None else None
    group = getattr(inner, "_group", None) or getattr(optimizer, "_group",
                                                      None)
    if group is not None and group.rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        torch.save({k: v.detach().cpu() if isinstance(v, torch.Tensor)
                    else v for k, v in opt_state.items()},
                   os.path.join(output, "model.pdopt"))
