"""Loss functionals for the PyTorch port (counterpart of
``paddle_tpu/nn/functional/loss.py``).

Only the path the pretraining criterion takes is ported: hard labels,
``use_softmax``, class axis last, no class weights, no label smoothing,
the mean over valid rows. Other modes raise ``NotImplementedError``.
"""
import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy of logits ``input`` [..., V] against int
    labels [...] (or [..., 1]). The row max is subtracted in the logits'
    dtype and the difference upcast to float32 (the JAX package's order:
    bf16 parity depends on it); the gold logit is read in float32. Rows
    whose label is ``ignore_index`` count zero and leave the mean's
    denominator."""
    last = axis in (-1, input.dim() - 1)
    if (weight is not None or soft_label or not use_softmax or not last
            or label_smoothing > 0 or reduction != "mean"):
        raise NotImplementedError(
            "cross_entropy: only hard labels with use_softmax on the last "
            "axis and the mean reduction, without class weights or label "
            "smoothing, are ported; the other modes are a later slice")
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    m = input.detach().amax(dim=-1, keepdim=True)
    shifted = (input - m).to(torch.float32)
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) \
        + m[..., 0].to(torch.float32)
    picked = torch.gather(input, -1, safe[..., None])[..., 0].to(
        torch.float32)
    loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return loss.sum() / valid.to(torch.float32).sum().clamp_min(1.0)
