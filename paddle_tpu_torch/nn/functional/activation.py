"""Activations for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/activation.py``). Only what the Llama model
calls. ``silu`` is a named entry of the amp hook."""
import torch

from ...amp._hook import amp_op


@amp_op("silu")
def silu(x):
    return torch.nn.functional.silu(x)
