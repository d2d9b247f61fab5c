"""``optimizer`` of the PyTorch port (counterpart of
``paddle_tpu/optimizer``; reference python/paddle/optimizer/): the
``Optimizer`` base, the fifteen optimizers (``Adam`` and ``AdamW`` on
kernel D's eager form) and the ``lr`` schedulers, for the eager loop
``loss.backward(); opt.step(); opt.clear_grad()``."""
from .optimizer import (Optimizer, optimizer_state_from_numpy,  # noqa: F401
                        optimizer_state_to_numpy)
from .optimizers import (SGD, Momentum, Adam, AdamW, Adagrad,  # noqa: F401
                         RMSProp, Adadelta, Adamax, Lamb, NAdam, RAdam,
                         Rprop, ASGD, LarsMomentum, LBFGS)
from . import lr  # noqa: F401
