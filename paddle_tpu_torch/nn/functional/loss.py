"""Loss functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/loss.py``): ``cross_entropy`` and the
element-wise losses up to ``gaussian_nll_loss``, each a named entry of
the amp hook under the JAX op's name and computed as the JAX op computes
it (``hsigmoid_loss``, ``margin_cross_entropy``, ``rnnt_loss``,
``adaptive_log_softmax_with_loss`` and ``ctc_loss`` are not ported yet,
ROADMAP Queue 1 item 10).

``cross_entropy`` takes every mode of the JAX function. The streamed case
(softmax on, hard labels, class axis last, no class weights; any
reduction and label smoothing) runs through the token cross-entropy
kernel (``ops.token_ce``: the CUDA kernels on the card, their plain
versions on the CPU), which never forms an [N, V] f32 tensor. Soft
labels, class weights, another axis and ``use_softmax=False`` are plain
PyTorch, as the JAX package computes them in plain XLA.
``cross_entropy`` is a named entry of the amp hook (``amp._hook.amp_op``:
on the black list, so under auto_cast it takes f32 logits).
"""
import numpy as np
import torch

from ...amp._hook import amp_op

from ...ops.token_ce import token_cross_entropy


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _take(x, idx, axis):
    """x gathered at ``idx`` along ``axis`` (idx has that axis removed; x
    1-D: a lookup); NaN where idx is outside the axis (JAX's gather
    fills)."""
    n = x.shape[axis]
    inr = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1)
    if x.dim() == 1:
        got = x[safe]
    else:
        got = torch.gather(x, axis, safe.unsqueeze(axis)).squeeze(axis)
    return torch.where(inr, got, torch.full_like(got, float("nan")))


@amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy of logits ``input`` against int class labels
    (or, with ``soft_label``, a distribution), paddle's semantics as the
    JAX package implements them. Rows whose label is ``ignore_index``
    count zero and leave the mean's denominator (with class weights the
    denominator is the sum of the kept rows' weights)."""
    nd = input.dim()
    ax = axis % nd
    if use_softmax and not soft_label and ax == nd - 1 and weight is None:
        return token_cross_entropy(input, label, ignore_index, reduction,
                                   label_smoothing)
    if use_softmax:
        # f32 softmax accumulation whatever the logits' dtype
        logp = torch.log_softmax(input.to(torch.float32), dim=ax)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    n_classes = input.shape[ax]
    if soft_label:
        tgt = label
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / n_classes
        loss = -torch.sum(tgt * logp, dim=ax)
        valid = torch.ones(loss.shape, dtype=logp.dtype, device=loss.device)
    else:
        lbl = label.to(torch.int64)
        if lbl.dim() == nd:          # [N, 1] style labels
            lbl = lbl.squeeze(ax)
        keep = lbl != ignore_index
        safe = torch.where(keep, lbl, torch.zeros_like(lbl))
        picked = _take(logp, safe, ax)
        if label_smoothing > 0:
            smooth = -torch.mean(logp, dim=ax)
            loss = (1 - label_smoothing) * (-picked) \
                + label_smoothing * smooth
        else:
            loss = -picked
        if weight is not None:
            loss = loss * _take(weight, safe, 0)
        loss = torch.where(keep, loss, torch.zeros_like(loss))
        valid = keep.to(logp.dtype)
    if reduction == "mean":
        if weight is not None and not soft_label:
            denom = torch.sum(_take(weight, safe, 0) * valid)
        else:
            denom = torch.clamp_min(torch.sum(valid), 1.0)
        return torch.sum(loss) / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The per-row loss of ``cross_entropy`` with the class axis kept (size
    1); with ``return_softmax`` also the softmax."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """-input[label] along the last axis (log-probabilities in), weighted
    by ``weight[label]``; rows at ``ignore_index`` count zero, and the
    mean divides by the kept rows' weight (at least 1e-12)."""
    lbl = label.to(torch.int64)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -_take(input, safe, input.dim() - 1)
    if weight is not None:
        loss = loss * _take(weight, safe, 0)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = _take(weight, safe, 0) * valid if weight is not None \
            else valid
        return torch.sum(loss) / torch.clamp_min(
            torch.sum(denom.to(input.dtype)), 1e-12)
    return _reduce(loss, reduction)


@amp_op("mse_loss")
def mse_loss(input, label, reduction="mean"):
    return _reduce((input - label) ** 2, reduction)


@amp_op("l1_loss")
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@amp_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - label
    a = torch.abs(d)
    return _reduce(torch.where(a < delta, 0.5 * d * d / delta,
                               a - 0.5 * delta), reduction)


@amp_op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean"):
    d = input - label
    a = torch.abs(d)
    return _reduce(torch.where(a <= delta, 0.5 * d * d,
                               delta * (a - 0.5 * delta)), reduction)


@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """Probabilities in, clipped to [1e-12, 1 - 1e-7] as in the JAX op."""
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """max(z, 0) - z y + log(1 + exp(-|z|)), times y (pos_weight - 1) + 1
    and ``weight`` where given."""
    loss = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        loss = loss * (label * (pos_weight - 1) + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False):
    """KL(label || exp(input)) element-wise ("batchmean": the sum over the
    batch's first dim)."""
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = torch.where(
            label > 0,
            label * (torch.log(torch.clamp_min(label, 1e-30)) - input),
            torch.zeros_like(input))
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@amp_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


@amp_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0.0)),
                   reduction)


@amp_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


@amp_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(u, v):
        return torch.sum(torch.abs(u - v + epsilon) ** p, dim=-1) ** (1 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0.0), reduction)


@amp_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@amp_op("log_loss")
def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


@amp_op("square_error_cost")
def square_error_cost(input, label):
    return (input - label) ** 2


@amp_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |X and Y| / (|X| + |Y|) over all but the batch dim, label the
    class ids [..., 1] of the probabilities' last dim; the batch's mean."""
    yoh = (label.squeeze(-1).long()[..., None]
           == torch.arange(input.shape[-1], device=input.device)
           ).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = torch.sum(input * yoh, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(yoh, dim=red)
    return torch.mean(1.0 - 2.0 * inter / (union + epsilon))


@amp_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean"):
    return _reduce(torch.log1p(torch.exp(-label.to(input.dtype) * input)),
                   reduction)


@amp_op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    logsig = torch.nn.functional.logsigmoid
    loss = -(label * logsig(input) + (1 - label) * logsig(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


@amp_op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    n, c = input.shape
    lbl = label.to(torch.int64)
    gold = torch.gather(input, 1, lbl[:, None])
    m = torch.clamp_min(margin - gold + input, 0.0) ** p
    if weight is not None:
        m = m * weight[lbl][:, None]
    m = m * (1 - torch.nn.functional.one_hot(lbl, c).to(m.dtype))
    return _reduce(m.sum(-1) / c, reduction)


@amp_op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        y = label
        stirling = y * torch.log(y + (y <= 1).to(y.dtype)) - y \
            + 0.5 * torch.log(2 * torch.pi * torch.clamp_min(y, 1.0))
        loss = loss + torch.where(y > 1, stirling, torch.zeros_like(y))
    return _reduce(loss, reduction)


@amp_op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * float(np.log(2 * np.pi))
    return _reduce(loss, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    """``triplet_margin_loss`` under a distance of the caller's (default:
    the p = 2 one)."""
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = torch.minimum(d_an, distance_function(positive, negative))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)
