"""hapi callbacks of the PyTorch port (counterpart of
``paddle_tpu/hapi/callbacks.py``): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping`` and
``LRScheduler``, called by ``Model.fit`` in the JAX order: on_begin,
then per epoch on_epoch_begin, on_batch_begin / on_batch_end a step,
on_epoch_end, and on_end."""
import time

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler"]


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass


class CallbackList:
    """The callbacks of one ``fit``, called in order; a callback stops the
    loop by setting ``stop_training`` on its list (``_list``)."""

    def __init__(self, callbacks):
        self.callbacks = callbacks
        self.stop_training = False

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)
            c._list = self

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.set_params(logs or {})
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


def _items(logs):
    return " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                      if isinstance(v, (int, float)) and k != "step")


class ProgBarLogger(Callback):
    """Prints the logs every ``log_freq`` steps and at each epoch's end
    (``verbose`` 0: nothing)."""

    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_begin(self, mode, logs=None):
        self._start = time.monotonic()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._epoch_start = time.monotonic()

    def on_batch_end(self, mode, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"Epoch {self.epoch} step {step}: {_items(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.monotonic() - self._epoch_start
            print(f"Epoch {epoch} done in {dt:.1f}s: {_items(logs)}")


class ModelCheckpoint(Callback):
    """``Model.save`` to ``save_dir``/``epoch`` every ``save_freq``
    epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    """Stops ``fit`` once ``monitor`` has not improved by ``min_delta``
    for more than ``patience`` epochs ("auto": higher is better for a
    name with "acc" in it, lower otherwise)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        better = (self.best is None
                  or (self.mode == "min" and val < self.best - self.min_delta)
                  or (self.mode == "max" and val > self.best + self.min_delta))
        if better:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience and getattr(self, "_list", None):
                self._list.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler each train batch (``by_step``)
    or each epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None)

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train" and self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()
