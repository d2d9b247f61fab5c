"""Loss layers of the PyTorch port (counterpart of
``paddle_tpu/nn/layers/loss.py``): one ``torch.nn.Module`` a functional
of ``nn.functional.loss`` (``nn.layer.functional_layer``), under the JAX
names and with the JAX defaults. ``CrossEntropyLoss`` keeps
``F.cross_entropy``'s route onto kernel C (hard labels, class axis last,
no class weights), a vision label of shape [B, 1] included. ``CTCLoss``
is not ported yet (ROADMAP Queue 1 item 10)."""
import torch

from .. import functional as F
from ..layer import functional_layer as _layer

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CosineEmbeddingLoss",
           "CrossEntropyLoss", "HuberLoss", "KLDivLoss", "L1Loss",
           "MSELoss", "MarginRankingLoss", "NLLLoss", "SmoothL1Loss",
           "TripletMarginLoss"]


class CrossEntropyLoss(torch.nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self._weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


_RED = ("reduction", "mean")
_W = ("weight", None)

MSELoss = _layer("MSELoss", F.mse_loss, _RED)
L1Loss = _layer("L1Loss", F.l1_loss, _RED)
NLLLoss = _layer("NLLLoss", F.nll_loss, _W, ("ignore_index", -100), _RED)
BCELoss = _layer("BCELoss", F.binary_cross_entropy, _W, _RED)
BCEWithLogitsLoss = _layer("BCEWithLogitsLoss",
                           F.binary_cross_entropy_with_logits, _W, _RED,
                           ("pos_weight", None))
SmoothL1Loss = _layer("SmoothL1Loss", F.smooth_l1_loss, _RED, ("delta", 1.0))
HuberLoss = _layer("HuberLoss", F.huber_loss, _RED, ("delta", 1.0))
KLDivLoss = _layer("KLDivLoss", F.kl_div, _RED, ("log_target", False))
MarginRankingLoss = _layer("MarginRankingLoss", F.margin_ranking_loss,
                           ("margin", 0.0), _RED)
CosineEmbeddingLoss = _layer("CosineEmbeddingLoss", F.cosine_embedding_loss,
                             ("margin", 0.0), _RED)
TripletMarginLoss = _layer("TripletMarginLoss", F.triplet_margin_loss,
                           ("margin", 1.0), ("p", 2.0), ("epsilon", 1e-6),
                           ("swap", False), _RED)
