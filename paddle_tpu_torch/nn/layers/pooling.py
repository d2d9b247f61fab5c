"""Pooling layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/pooling.py``, with the pooling layers of its
``extra_layers.py``): one ``torch.nn.Module`` a functional of
``nn.functional.pooling`` (``nn.layer.functional_layer``). Each layer
passes every argument it takes to its functional (some JAX layers take
``ceil_mode``, ``divisor_override``, ``return_mask`` or ``data_format``
and drop them: ROADMAP Queue 3). The unpools' forward takes (x,
indices)."""
from .. import functional as F
from ..layer import functional_layer as _layer

__all__ = [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "LPPool1D", "LPPool2D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]

_K = ("kernel_size", None)
_S = ("stride", None)
_P = ("padding", 0)
_OUT = ("output_size", None)
_MASK = ("return_mask", False)
_CEIL = ("ceil_mode", False)


def _fmt(nd):
    return ("data_format", ("NCL", "NCHW", "NCDHW")[nd - 1])


MaxPool1D = _layer("MaxPool1D", F.max_pool1d, _K, _S, _P, _MASK, _CEIL)
MaxPool2D = _layer("MaxPool2D", F.max_pool2d, _K, _S, _P, _MASK, _CEIL,
                   _fmt(2))
MaxPool3D = _layer("MaxPool3D", F.max_pool3d, _K, _S, _P, _MASK, _CEIL,
                   _fmt(3))
AvgPool1D = _layer("AvgPool1D", F.avg_pool1d, _K, _S, _P,
                   ("exclusive", True), _CEIL)
AvgPool2D = _layer("AvgPool2D", F.avg_pool2d, _K, _S, _P, _CEIL,
                   ("exclusive", True), ("divisor_override", None), _fmt(2))
AvgPool3D = _layer("AvgPool3D", F.avg_pool3d, _K, _S, _P, _CEIL,
                   ("exclusive", True), ("divisor_override", None), _fmt(3))
AdaptiveAvgPool1D = _layer("AdaptiveAvgPool1D", F.adaptive_avg_pool1d, _OUT)
AdaptiveAvgPool2D = _layer("AdaptiveAvgPool2D", F.adaptive_avg_pool2d, _OUT,
                           _fmt(2))
AdaptiveAvgPool3D = _layer("AdaptiveAvgPool3D", F.adaptive_avg_pool3d, _OUT,
                           _fmt(3))
AdaptiveMaxPool1D = _layer("AdaptiveMaxPool1D", F.adaptive_max_pool1d, _OUT,
                           _MASK)
AdaptiveMaxPool2D = _layer("AdaptiveMaxPool2D", F.adaptive_max_pool2d, _OUT,
                           _MASK, _fmt(2))
AdaptiveMaxPool3D = _layer("AdaptiveMaxPool3D", F.adaptive_max_pool3d, _OUT,
                           _MASK, _fmt(3))
MaxUnPool1D = _layer("MaxUnPool1D", F.max_unpool1d, _K, _S, _P, _fmt(1),
                     _OUT)
MaxUnPool2D = _layer("MaxUnPool2D", F.max_unpool2d, _K, _S, _P, _fmt(2),
                     _OUT)
MaxUnPool3D = _layer("MaxUnPool3D", F.max_unpool3d, _K, _S, _P, _fmt(3),
                     _OUT)
FractionalMaxPool2D = _layer("FractionalMaxPool2D", F.fractional_max_pool2d,
                             _OUT, ("kernel_size", None), ("random_u", None),
                             _MASK)
FractionalMaxPool3D = _layer("FractionalMaxPool3D", F.fractional_max_pool3d,
                             _OUT, ("kernel_size", None), ("random_u", None),
                             _MASK)
LPPool1D = _layer("LPPool1D", F.lp_pool1d, ("norm_type", None), _K, _S, _P,
                  _CEIL, _fmt(1))
LPPool2D = _layer("LPPool2D", F.lp_pool2d, ("norm_type", None), _K, _S, _P,
                  _CEIL, _fmt(2))
