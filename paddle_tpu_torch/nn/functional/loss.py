"""Loss functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/loss.py``).

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
