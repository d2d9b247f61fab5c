"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package runs on
an NVIDIA Hopper GPU with PyTorch and hand-written CUDA kernels, and
imports nothing of JAX or of ``paddle_tpu``. Module paths mirror the JAX
package's. Entry points take ``device=`` (default "cuda") and raise
without a GPU unless the caller asks for the CPU.

Slice 1 covers paged continuous-batching serving: ``inference`` (the
engine), ``incubate.nn`` (the fused decoder op and the scheduler),
``ops`` (paged attention and the int4 weight-only matmul, with their
kernels under ``csrc/``), ``observability`` and ``core``.

Slice 2 covers the Llama forward and the single-device pretraining step:
``models`` (``LlamaForCausalLM``, ``pretrain``), ``nn`` (the layers and
functionals the model calls) and flash attention in ``ops`` with its
forward and fused backward kernels.

Later slices (see CHANGES.md) add the serving front door, the training
step's options, tensor-parallel serving, the training mesh and fleet's
tensor-parallel layers. Slice 22 adds the eager training path:
``optimizer`` (the fifteen optimizers and the ``lr`` schedulers; Adam and
AdamW on kernel D's eager form), ``nn.clip``, ``distributed.parallel``
(``DataParallel`` with the bucketed reducer of
``distributed.fleet.reducer``), ``fleet.distributed_optimizer`` and the
ZeRO stages (``distributed.fleet.sharding``, ``distributed.sharding``).
The next slice adds the serving autotuner on the port's kernel plans
(``ops.autotune``, the engines' ``autotune_cache``) and ``amp``
(``auto_cast``, ``decorate``, ``GradScaler``, ``debugging``;
``distributed.fleet.utils.mix_precision_utils``).

Slice 28 adds the vision training path: the rest of ``nn`` that the
model zoo builds from (pools, batch / instance norms, activations,
containers, losses, 1-3D convolutions and their transposes,
initializers), ``vision.models`` (the zoo), ``hapi`` (``Model`` with its
callbacks, ``summary``, ``flops``; ``Model``, ``summary`` and ``flops``
are also top-level names here), ``metric`` and ``framework``'s ``save``
/ ``load``.
"""


def __getattr__(name):
    """``Model``, ``summary`` and ``flops`` at the top level, as paddle has
    them (imported on first use: ``import paddle_tpu_torch`` stays
    light)."""
    if name in ("Model", "summary", "flops"):
        from . import hapi
        return getattr(hapi, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
