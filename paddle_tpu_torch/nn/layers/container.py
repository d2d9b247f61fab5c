"""Containers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/container.py``). ``LayerList`` is
``torch.nn.ModuleList``: its modules are named by their index
(``h.0.attn...``, ``layers.3...``), as the JAX ``LayerList`` names its
sublayers, so parameter names match ``jit.functional.state_arrays``.
``Sequential`` names its layers ``"0"``, ``"1"``, ... when given them
positionally, or by the names of ``(name, layer)`` pairs or of an
``OrderedDict``; a slice is a new ``Sequential`` of the sliced layers,
named afresh from ``"0"`` as the JAX one does. ``ParameterList`` and
``LayerDict`` are torch's ``ParameterList`` and ``ModuleDict``, whose
names are the JAX ones (the index, the key)."""
import collections

import torch

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]

LayerList = torch.nn.ModuleList
ParameterList = torch.nn.ParameterList
LayerDict = torch.nn.ModuleDict


class Sequential(torch.nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
        elif any(isinstance(l, tuple) for l in layers):
            super().__init__(collections.OrderedDict(
                l if isinstance(l, tuple) else (str(i), l)
                for i, l in enumerate(layers)))
        else:
            super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)
