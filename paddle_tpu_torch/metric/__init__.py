"""paddle.metric of the PyTorch port (counterpart of
``paddle_tpu/metric/__init__.py``): ``Metric``, ``Accuracy``,
``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

``Accuracy.compute`` takes the top k on the device the predictions lie
on (``torch.topk``) and returns the [..., maxk] correctness mask there;
``update`` sums it for every k on the device and reads the sums on the
host, one read a step, as the JAX metric's numpy does. Ties in the top k
follow ``torch.topk`` (the JAX metric's ``np.argsort`` order promises no
order either). ``Precision``, ``Recall`` and ``Auc`` count on the host in
numpy, as the JAX ones do."""
import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _correct(pred, label, maxk):
    """[..., maxk] bool: is the j-th highest score's class the label?"""
    pred = torch.as_tensor(pred)
    label = torch.as_tensor(label, device=pred.device)
    top = torch.topk(pred, maxk, dim=-1).indices
    if label.dim() == pred.dim():
        label = label.squeeze(-1)
    return top == label.long()[..., None]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        return _correct(pred, label, max(self.topk))

    def update(self, correct, *args):
        correct = torch.as_tensor(correct)
        n = correct.shape[0] if correct.dim() else 1
        rows = int(np.prod(correct.shape[:-1]))
        hits = torch.stack([correct[..., :k].any(dim=-1).sum()
                            for k in self.topk]).cpu().tolist()
        res = []
        for i, c in enumerate(hits):
            self.total[i] += float(c)
            self.count[i] += rows
            res.append(float(c) / max(n, 1))
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """tp / (tp + fp) of binary predictions (a score above 0.5 is 1)."""

    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).ravel()
        lab = _np(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """tp / (tp + fn) of binary predictions (a score above 0.5 is 1)."""

    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).ravel()
        lab = _np(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from histograms of the positive class's score over
    ``num_thresholds`` + 1 bins (a 2-D prediction's last column), by the
    trapezoid rule over descending thresholds."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _np(labels).ravel()
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        pos = lab != 0
        bins = self.num_thresholds + 1
        self._stat_pos += np.bincount(idx[pos], minlength=bins)
        self._stat_neg += np.bincount(idx[~pos], minlength=bins)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The share of rows whose label is among the k highest scores, a
    float32 scalar tensor on the input's device."""
    return _correct(input, label, k).any(dim=-1).to(torch.float32).mean()
