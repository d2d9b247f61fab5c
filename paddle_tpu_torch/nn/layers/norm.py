"""RMSNorm layer of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/norm.py``)."""
import torch

from ...core.device import DEFAULT_DEVICE, resolve_device
from .. import functional as F


class RMSNorm(torch.nn.Module):
    """RMSNorm with a float32 scale initialised to 1.0, built on ``device``
    (default "cuda", which raises without a GPU)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=DEFAULT_DEVICE):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, dtype=torch.float32,
                       device=resolve_device(device)))

    def forward(self, x, residual=None):
        """RMSNorm of x, or with ``residual`` of h = x + residual (rounded
        to x's dtype): then (out, h), the add handed to the norm's kernel
        (the JAX layer's ``residual + hidden_states`` before the next
        norm). The scale is cast to the activation's dtype either way.
        Through ``F.rms_norm``, the amp hook's named entry."""
        return F.rms_norm(x, self.weight, self.epsilon, residual=residual)
