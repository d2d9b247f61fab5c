"""Normalisation functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/norm.py``). Only what the Llama model calls."""
from ...ops import fused_norm


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm: the mean square in float32, the normalised value cast back
    to x's dtype, then scaled by the weight cast to x's dtype (an f32
    scale never promotes a bf16 activation). Kernel A
    (``ops.fused_norm``) on the card, its plain version on the CPU."""
    return fused_norm.rms_norm(x, weight, epsilon)
