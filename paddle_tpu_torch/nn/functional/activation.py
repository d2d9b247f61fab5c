"""Activations for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/activation.py``). Only what the Llama model
calls."""
import torch


def silu(x):
    return torch.nn.functional.silu(x)
