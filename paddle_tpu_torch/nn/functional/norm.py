"""Normalisation functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/norm.py``). Only what the Llama model calls.
``rms_norm`` is a named entry of the amp hook (``amp._hook.amp_op``)."""
from ...amp._hook import amp_op, casting
from ...ops import fused_norm


@amp_op("rms_norm")
def _rms_norm(x, weight, epsilon, residual):
    return fused_norm.rms_norm(x, weight, epsilon, residual=residual)


def rms_norm(x, weight=None, epsilon=1e-6, residual=None):
    """RMSNorm: the mean square in float32, the normalised value cast back
    to x's dtype, then scaled by the weight cast to x's dtype (an f32
    scale never promotes a bf16 activation). Kernel A
    (``ops.fused_norm``) on the card, its plain version on the CPU.

    ``residual`` (the port's fused form, ``nn.RMSNorm``'s): the norm of
    h = residual + x, returned as (out, h), the add inside kernel A. Under
    auto_cast the add is the JAX layer's own op, as there: it runs first,
    cast as "add" (so h takes the add's dtype, bf16 under O2), and the
    norm takes h as the black list casts it."""
    if residual is not None and casting():
        h = residual + x
        return _rms_norm(h, weight, epsilon, None), h
    return _rms_norm(x, weight, epsilon, residual)


rms_norm.amp_name = "rms_norm"
