"""Distributed surface of the PyTorch port (counterpart of
``paddle_tpu/distributed``): collectives on explicit groups
(``collective``), the comm watchdog, the training mesh (``mesh``), the
parallel environment and ``DataParallel`` (``parallel``: each rank's
gradients averaged over the data-parallel group during the backward),
``fleet`` (the hybrid topology, tensor parallelism, recompute, the
mesh's sharded compute, ``distributed_model`` / ``distributed_optimizer``
and the ZeRO stages) and ``sharding`` (``group_sharded_parallel``,
``save_group_sharded_model``)."""
from . import fleet  # noqa: F401
from .parallel import (DataParallel, ParallelEnv, ParallelMode,  # noqa: F401
                       destroy_process_group, get_backend, get_rank,
                       get_world_size, init_parallel_env, is_available,
                       is_initialized)
from . import sharding  # noqa: F401
