"""hapi ``Model`` of the PyTorch port (counterpart of
``paddle_tpu/hapi/model.py``; reference python/paddle/hapi/model.py):
Keras-like ``prepare`` / ``fit`` / ``evaluate`` / ``predict`` with
callbacks, on a network that is a ``torch.nn.Module``.

The network runs where its parameters are: ``train_batch`` /
``eval_batch`` / ``predict_batch`` move each batch (the DataLoader
collates on the host) to the device of the network's first parameter.
A step reads its loss on the host (``loss.item()``) and each metric's
update reads its sums, as the JAX loop reads its numpy values.
``prepare(jit=True)`` is refused: the JAX ``Model`` compiles its loss
graph through ``to_static``, which the port does not have yet (ROADMAP
Queue 1 item 10, ``jit``). ``amp_configs`` is accepted and not read, as
in the JAX ``Model``: run ``evaluate`` / ``fit`` inside
``amp.auto_cast`` for mixed precision. ``save`` / ``load`` write and
read ``.pdparams`` (the network's ``state_dict``, buffers included) and
``.pdopt`` (the optimizer's) in the format of ``framework.save``, which
the JAX package reads."""
import os

import numpy as np
import torch

from ..io import DataLoader
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


def _update_metric(metric, out, label):
    """``Metric.compute`` may return one value or a tuple of ``update``
    arguments (the base ``compute`` passes (pred, label) through)."""
    res = metric.compute(out, label)
    if isinstance(res, tuple):
        metric.update(*res)
    else:
        metric.update(res)


def _named(metric):
    res = metric.accumulate()
    names = metric.name() if isinstance(metric.name(), list) \
        else [metric.name()]
    vals = res if isinstance(res, list) else [res]
    return dict(zip(names, vals))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []

    def prepare(self, optimizer=None, loss=None, metrics=None, jit=False,
                amp_configs=None):
        if jit:
            raise NotImplementedError(
                "Model.prepare(jit=True): the port has no to_static yet "
                "(ROADMAP Queue 1 item 10, jit); use jit=False")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        return self

    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _to(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device(), non_blocking=True)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(self._device())
        return x

    # -- single steps -------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step on a batch: forward, loss, backward and (with
        ``update``) the optimizer's step; returns the loss tensor."""
        self.network.train()
        x, y = self._to(_first(inputs)), self._to(_first(labels))
        out = self.network(x)
        loss = self._loss(out, y)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        for m in self._metrics:
            _update_metric(m, out.detach(), y)
        return loss

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        x, y = self._to(_first(inputs)), self._to(_first(labels))
        out = self.network(x)
        loss = self._loss(out, y) if self._loss else None
        for m in self._metrics:
            _update_metric(m, out, y)
        return loss, out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(self._to(_first(inputs)))

    # -- loops --------------------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle, num_workers,
                   drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._to_loader(train_data, batch_size, shuffle,
                                 num_workers, drop_last)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers)
        cbs = CallbackList(_as_list(callbacks)
                           or [ProgBarLogger(log_freq, verbose)])
        cbs.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbs.on_begin("train", {"epochs": epochs, "steps": steps,
                               "metrics": self._metric_names()})
        logs = {}
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbs.on_batch_begin("train", step, logs)
                x, y = batch[0], batch[1] if len(batch) > 1 else None
                update = (step + 1) % accumulate_grad_batches == 0
                loss = self.train_batch(x, y, update=update)
                logs = {"loss": float(loss.item()), "step": step}
                for m in self._metrics:
                    logs.update(_named(m))
                cbs.on_batch_end("train", step, logs)
                if num_iters is not None and step + 1 >= num_iters:
                    break
                if cbs.stop_training:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          num_workers=num_workers)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbs.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            if cbs.stop_training:
                break
        cbs.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """{"loss": the batches' mean loss, metric name: value}."""
        loader = self._to_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            x, y = batch[0], batch[1] if len(batch) > 1 else None
            loss, _ = self.eval_batch(x, y)
            if loss is not None:
                losses.append(float(loss.item()))
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs.update(_named(m))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """[list of each batch's output as numpy], or [their
        concatenation] with ``stack_outputs``."""
        loader = self._to_loader(test_data, batch_size, False, num_workers)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(x).detach().cpu().numpy())
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # -- persistence ----------------------------------------------------------
    def save(self, path, training=True):
        from .. import framework
        framework.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework
        state = framework.load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            state = {k: v for k, v in state.items()
                     if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.network.load_state_dict(state, strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(framework.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
