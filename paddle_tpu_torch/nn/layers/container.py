"""Containers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/container.py``). ``LayerList`` is
``torch.nn.ModuleList``: its modules are named by their index
(``h.0.attn...``, ``layers.3...``), as the JAX ``LayerList`` names its
sublayers, so parameter names match ``jit.functional.state_arrays``."""
import torch

LayerList = torch.nn.ModuleList
