"""Common functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/common.py``). Only what the Llama model
calls. ``linear`` and ``embedding`` are named entries of the amp hook
(``amp._hook.amp_op``)."""
import threading

import torch

from ...amp._hook import amp_op

# the pipeline's weight-gradient split (ZB-H1): while a thread is inside
# ``distributed.fleet.pipeline_parallel.split_weight_grad``, its ``fn``
# computes this thread's linears
weight_grad_split = threading.local()


def plain_linear(x, weight):
    """``x @ weight`` with the JAX package's dtype promotion."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return torch.matmul(x.to(dtype), weight.to(dtype))


@amp_op("linear")
def linear(x, weight):
    """paddle convention: weight is [in_features, out_features], so this
    is ``x @ weight``. Mixed dtypes promote as in the JAX package (a bf16
    activation against an f32 weight computes in f32); torch's matmul
    would refuse them. Inside ``split_weight_grad`` the weight's gradient
    is deferred (``fleet.pipeline_parallel``)."""
    split = getattr(weight_grad_split, "fn", None)
    if split is not None:
        return split(x, weight)
    return plain_linear(x, weight)


@amp_op("embedding")
def embedding(x, weight):
    """Rows of ``weight`` [V, E] at the ids ``x``, as the JAX package's
    ``jnp.take`` (fill mode) gathers them: an id in [-V, V) reads its row,
    a negative one wrapping to ``id + V``; any other id reads a row of NaN
    in the weight's dtype, and its gradient is dropped. The index is
    clamped before the gather and the NaN rows selected after it, so no
    id can reach past the table (on the card that would be a device-side
    assert, which ends the CUDA context)."""
    idx = x.long()
    v = weight.shape[0]
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    rows = torch.nn.functional.embedding(idx.clamp(0, max(v - 1, 0)), weight)
    nan = torch.full((), float("nan"), dtype=weight.dtype,
                     device=weight.device)
    return torch.where(valid[..., None], rows, nan)
