"""Layers of the PyTorch port (counterpart of ``paddle_tpu/nn/layers``):
what the model families and the vision zoo build."""
from .activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, SiLU, Sigmoid, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Fold, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, PixelShuffle, PixelUnshuffle, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .container import (LayerDict, LayerList,  # noqa: F401
                        ParameterList, Sequential)
from .conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                   Conv2DTranspose, Conv3D, Conv3DTranspose)
from .loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    HuberLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
    SmoothL1Loss, TripletMarginLoss)
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, LPPool1D, LPPool2D, MaxPool1D, MaxPool2D,
    MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, FractionalMaxPool2D,
    FractionalMaxPool3D)
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = sorted(n for n in dir() if n[0].isupper())
