"""Automatic mixed precision of the PyTorch port (counterpart of
``paddle_tpu/amp/__init__.py``; reference python/paddle/amp/ —
``auto_cast`` (auto_cast.py:1006), the O1 / O2 op lists (amp_lists.py),
``GradScaler`` / ``AmpScaler`` (grad_scaler.py:62, :657) and
``decorate``'s master weights).

``auto_cast`` casts each op's floating inputs by Paddle's op name, as the
JAX package's dispatch hook does: O1 runs the white list in ``dtype``,
the black list in f32 and promotes the rest; O2 runs everything but the
black list in ``dtype``; OD casts only its short white list; O0 (or
``enable=False``) casts nothing. The hook (``amp._hook``) sits on the
port's named functional entries and, through a torch-function mode, on
the torch calls of the model's own code. The context is per thread.
``decorate`` casts a model's f32 parameters for O2 (norm layers and
``excluded_layers`` keep f32) and turns on the optimizers' f32 masters.
With no auto_cast active nothing is cast.

bf16 is the default dtype and needs no loss scaling; fp16 with
``GradScaler`` is kept for the reference's API.
"""
import contextlib

import torch

from . import amp_lists, debugging  # noqa: F401
from ._hook import _AmpState, pushed
from .amp_lists import black_list, white_list
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = [
    "auto_cast", "amp_guard", "decorate", "amp_decorate", "GradScaler",
    "AmpScaler", "OptimizerState", "white_list", "black_list",
    "is_float16_supported", "is_bfloat16_supported", "debugging",
]

_LOW = {"float16": torch.float16, "bfloat16": torch.bfloat16,
        torch.float16: torch.float16, torch.bfloat16: torch.bfloat16}


def _low_dtype(dtype):
    d = _LOW.get(dtype if isinstance(dtype, torch.dtype)
                 else str(dtype).replace("paddle.", ""))
    if d is None:
        raise ValueError(f"amp dtype must be float16/bfloat16, got {dtype}")
    return d


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Mixed-precision context (reference python/paddle/amp/
    auto_cast.py:1006) on this thread. level O1: white-list ops run in
    ``dtype``, black-list ops in fp32, the rest promote. level O2:
    everything but the black list runs in ``dtype``. Nested contexts: the
    innermost one holds."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"level should be O0/OD/O1/O2, got {level}")
    target = _low_dtype(dtype)
    white, black = amp_lists._get_lists(level)
    if custom_white_list:
        white = white | set(custom_white_list)
        black = black - set(custom_white_list)
    if custom_black_list:
        black = black | set(custom_black_list)
        white = white - set(custom_black_list)
    st = _AmpState(enable and level != "O0", target, level, white, black,
                   use_promote)
    with pushed(st):
        yield


amp_guard = auto_cast  # legacy alias (auto_cast.py amp_guard)


def _is_norm_param_holder(layer):
    name = type(layer).__name__
    return ("Norm" in name) or name in ("BatchNorm", "SyncBatchNorm")


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast every f32 parameter of ``models`` (torch modules) to
    ``dtype`` in place, except those held directly by a norm layer (a
    class whose name has "Norm") or by an ``excluded_layers`` instance,
    and turn on each optimizer's ``_multi_precision`` (f32 masters of the
    low-precision parameters) unless ``master_weight`` is False. O1 casts
    nothing. Returns the model(s), or (model(s), optimizer(s)), as
    given."""
    if level not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models)
    single_opt = optimizers is not None \
        and not isinstance(optimizers, (list, tuple))
    opt_list = ([optimizers] if single_opt
                else list(optimizers) if optimizers is not None else [])

    if level == "O2":
        target = _low_dtype(dtype)
        excluded = set()
        for m in model_list:
            for sub in m.modules():
                if _is_norm_param_holder(sub) or (
                        excluded_layers
                        and isinstance(sub, tuple(excluded_layers))):
                    excluded.update(id(p) for p in sub.parameters(
                        recurse=False))
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32 and id(p) not in excluded:
                        p.data = p.data.to(target)
        for opt in opt_list:
            if master_weight is None or master_weight:
                opt._multi_precision = True

    if save_dtype is not None:
        for m in model_list:
            m._amp_save_dtype = save_dtype

    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    return models_out, (opt_list[0] if single_opt else opt_list)


amp_decorate = decorate


def _device(device):
    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    return torch.device(device)


def is_float16_supported(device=None):
    """fp16 compute on ``device`` (default: the card when there is one):
    the CPU computes it; a card from compute capability 5.3."""
    dev = _device(device)
    if dev.type != "cuda":
        return True
    return torch.cuda.get_device_capability(dev) >= (5, 3)


def is_bfloat16_supported(device=None):
    """bf16 compute on ``device`` (default: the card when there is one):
    the CPU computes it; a card from compute capability 8.0."""
    dev = _device(device)
    if dev.type != "cuda":
        return True
    return torch.cuda.get_device_capability(dev) >= (8, 0)
