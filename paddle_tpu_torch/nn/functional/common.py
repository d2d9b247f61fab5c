"""Common functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/common.py``). Only what the Llama model
calls."""
import torch


def linear(x, weight):
    """paddle convention: weight is [in_features, out_features], so this
    is ``x @ weight``. Mixed dtypes promote as in the JAX package (a bf16
    activation against an f32 weight computes in f32); torch's matmul
    would refuse them."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return torch.matmul(x.to(dtype), weight.to(dtype))


def embedding(x, weight):
    """Rows of ``weight`` [V, E] at the ids ``x``."""
    return torch.nn.functional.embedding(x.long(), weight)
