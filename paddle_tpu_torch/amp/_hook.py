"""The auto-cast hook of the PyTorch port (counterpart of the amp hook slot
of ``paddle_tpu/core/dispatch.py``: ``set_amp_hook`` and its call before
every dispatched op).

The JAX package has one dispatch function that every op passes by name,
and the amp hook casts the op's floating inputs there. The port has no
dispatch, so the hook sits in two places:

* ``amp_op(name)`` wraps a named functional entry of the port
  (``nn.functional.linear``, ``flash_attention``, ``rms_norm``,
  ``cross_entropy``, ``ops.swiglu.swiglu``, ...): the entry's floating
  tensor arguments are cast by the active state, then its body runs with
  the hook suspended, so what the body calls inside is not cast again
  (as JAX's hook never sees the ``jnp`` calls inside an op);
* ``AmpMode``, a ``torch.overrides.TorchFunctionMode``, does the same for
  the torch calls made at the model's level, through one table from torch
  callables to Paddle's op names (``TORCH_NAMES``: ``torch.matmul`` and
  ``Tensor.__matmul__`` are "matmul", ``+`` is "add", ``F.softmax`` is
  "softmax", ...). A torch call outside the table is not touched.

Both feed the debugging collectors (``amp.debugging``) after the cast, as
JAX's ``_master_hook`` does, and hand each op's outputs to the run
listeners (``debugging.collect_run_stats``, JAX's op listeners). With no
auto_cast, collector or listener active a named entry only checks a
thread-local flag and calls its body.

The state is per thread: ``auto_cast`` pushes onto this thread's stack and
enters the mode on this thread (torch's mode stack is per thread too). A
serving stepper thread or a thread rank enters its own context. The
recompute of ``distributed.fleet.recompute`` takes a ``snapshot()`` at
the forward and runs the backward's second forward under ``restored()``,
so it casts exactly as the first forward did.
"""
import contextlib
import functools
import inspect
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["amp_op", "AmpMode", "TORCH_NAMES", "snapshot", "restored",
           "active_state", "casting"]

_FLOATS = (torch.float32, torch.float16, torch.bfloat16, torch.float64)
_NEVER = ("cast", "getitem", "setitem", "clone")
_tls = threading.local()
_listeners = []     # fn(name, outputs) after every hooked op


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "white", "black",
                 "use_promote")

    def __init__(self, enable, dtype, level, white, black, use_promote):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black
        self.use_promote = use_promote


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def active_state():
    """This thread's innermost auto_cast state, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


_debugging = None


def _collecting():
    global _debugging
    if _debugging is None:          # amp.debugging imports this module
        from . import debugging
        _debugging = debugging
    return _debugging._stats is not None or _debugging._checker is not None


def _run(name, fn, args, kwargs):
    """``fn(*args, **kwargs)`` with the hook suspended; its outputs go to
    the run listeners."""
    with _suspend():
        out = fn(*args, **kwargs)
    for listen in list(_listeners):
        listen(name, out)
    return out


def casting():
    """True when an enabled auto_cast state casts this thread's ops here:
    not inside a named entry's body, where nothing is cast again."""
    st = active_state()
    return st is not None and st.enable \
        and not getattr(_tls, "suspended", 0)


def _hooked():
    """True when a named entry must run the hook on this thread."""
    if getattr(_tls, "suspended", 0):
        return False
    return bool(getattr(_tls, "stack", None)) or _collecting() \
        or bool(_listeners)


@contextlib.contextmanager
def _suspend():
    _tls.suspended = getattr(_tls, "suspended", 0) + 1
    try:
        yield
    finally:
        _tls.suspended -= 1


def _target(name, st, tensors):
    """The dtype the state casts op ``name``'s floating inputs to, or None
    (JAX's ``_hook``)."""
    if not st.enable or name in _NEVER:
        return None
    if name in st.black:
        return torch.float32
    if name in st.white or st.level == "O2":
        return st.dtype
    if st.use_promote:
        # gray ops promote: fp32 if any float input is fp32, else the
        # low-precision dtype flows through
        has_f32 = any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                      for a in tensors)
        return torch.float32 if has_f32 else st.dtype
    return None


def _cast(t, dtype):
    if isinstance(t, torch.Tensor) and t.dtype in _FLOATS and t.dtype != dtype:
        return t.to(dtype)
    return t


def _apply(name, args, kwargs, only=None):
    """Cast ``args`` / ``kwargs`` (``only``: the kwarg names to cast, None
    for every argument) by this thread's state, then feed the debugging
    collectors. Returns (args, kwargs)."""
    st = active_state()
    if st is not None:
        pool = list(args) + list(kwargs.values()) if only is None \
            else [kwargs.get(k) for k in only]
        target = _target(name, st, pool)
        if target is not None:
            if only is None:
                args = tuple(_cast(a, target) for a in args)
                kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
            else:
                kwargs = {k: _cast(v, target) if k in only else v
                          for k, v in kwargs.items()}
    if _collecting():
        _debugging._stats_hook(name, args, kwargs)
    return args, kwargs


def amp_op(name, only=None):
    """Decorator: the named functional entry ``name`` under auto_cast
    (module docstring). ``only`` names the parameters that are cast (None:
    every floating tensor argument, as JAX casts every input of an op);
    flash attention casts q, k and v and keeps its f32 rope tables."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _hooked():
                return fn(*args, **kwargs)
            if only is not None:
                bound = sig.bind(*args, **kwargs)
                args, kwargs = (), dict(bound.arguments)
                extra = kwargs.pop(next((p.name for p in
                                         sig.parameters.values()
                                         if p.kind == p.VAR_KEYWORD), None),
                                   {})
                kwargs.update(extra)
            args, kwargs = _apply(name, args, kwargs, only)
            return _run(name, fn, args, kwargs)
        wrapper.amp_name = name
        return wrapper
    return deco


def _table():
    """torch callable -> Paddle op name, for the calls the model makes
    itself."""
    names = {
        "matmul": ("matmul", "__matmul__", "__rmatmul__"),
        "mm": ("mm",), "bmm": ("bmm",), "addmm": ("addmm",), "mv": ("mv",),
        "inner": ("inner",), "outer": ("outer",), "einsum": ("einsum",),
        "linear": ("F.linear",), "conv1d": ("F.conv1d",),
        "conv2d": ("F.conv2d",), "conv3d": ("F.conv3d",),
        "add": ("add", "__add__", "__radd__"),
        "subtract": ("sub", "subtract", "__sub__", "__rsub__"),
        "multiply": ("mul", "multiply", "__mul__", "__rmul__"),
        "divide": ("div", "divide", "true_divide", "__truediv__",
                   "__rtruediv__"),
        "pow": ("pow", "__pow__", "__rpow__"),
        "exp": ("exp",), "expm1": ("expm1",), "log": ("log",),
        "log2": ("log2",), "log10": ("log10",), "log1p": ("log1p",),
        "logsumexp": ("logsumexp",), "logcumsumexp": ("logcumsumexp",),
        "square": ("square",), "sqrt": ("sqrt",), "rsqrt": ("rsqrt",),
        "abs": ("abs",), "maximum": ("maximum",), "minimum": ("minimum",),
        "tanh": ("tanh", "F.tanh"), "sigmoid": ("sigmoid", "F.sigmoid"),
        "relu": ("relu", "F.relu"), "gelu": ("F.gelu",),
        "silu": ("F.silu",), "softplus": ("F.softplus",),
        "erf": ("erf",), "erfinv": ("erfinv",), "lgamma": ("lgamma",),
        "digamma": ("digamma",),
        "softmax": ("softmax", "F.softmax"),
        "log_softmax": ("log_softmax", "F.log_softmax"),
        "mean": ("mean",), "sum": ("sum",), "prod": ("prod",),
        "cumsum": ("cumsum",), "cumprod": ("cumprod",),
        "norm": ("norm",), "layer_norm": ("F.layer_norm",),
        "batch_norm": ("F.batch_norm",),
        "instance_norm": ("F.instance_norm",),
        "group_norm": ("F.group_norm",),
        "nll_loss": ("F.nll_loss",), "kl_div": ("F.kl_div",),
        "binary_cross_entropy": ("F.binary_cross_entropy",),
        "binary_cross_entropy_with_logits": (
            "F.binary_cross_entropy_with_logits",),
        "cos_sim": ("F.cosine_similarity",),
    }
    out = {}
    for op, torch_names in names.items():
        for n in torch_names:
            if n.startswith("F."):
                fn = getattr(F, n[2:], None)
                if fn is not None:
                    out[fn] = op
                continue
            for owner in (torch, torch.Tensor):
                fn = getattr(owner, n, None)
                if fn is not None:
                    out[fn] = op
    return out


TORCH_NAMES = _table()


class AmpMode(TorchFunctionMode):
    """The hook for torch calls (module docstring): a call whose callable
    is in ``TORCH_NAMES`` has its floating inputs cast and is counted by
    the collectors; every other call passes as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = TORCH_NAMES.get(func)
        if name is None or getattr(_tls, "suspended", 0):
            return func(*args, **kwargs)
        args, kwargs = _apply(name, args, kwargs)
        return _run(name, func, args, kwargs)


def _enter():
    """Count one user of this thread's mode; the first enters it."""
    depth = getattr(_tls, "depth", 0)
    if depth == 0:
        _tls.mode = AmpMode()
        _tls.mode.__enter__()
    _tls.depth = depth + 1


def _exit():
    _tls.depth -= 1
    if _tls.depth == 0:
        mode, _tls.mode = _tls.mode, None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def pushed(state):
    """Run the body under ``state`` on this thread (``auto_cast``)."""
    _stack().append(state)
    _enter()
    try:
        yield
    finally:
        _exit()
        _stack().pop()


def snapshot():
    """This thread's auto_cast stack, to replay in a recompute."""
    return tuple(getattr(_tls, "stack", None) or ())


@contextlib.contextmanager
def restored(states):
    """Run the body under the auto_cast stack ``states`` (a ``snapshot``)
    on this thread, whatever is active here; the stack of the moment comes
    back after."""
    saved = getattr(_tls, "stack", None)
    _tls.stack = list(states)
    entered = bool(states)
    if entered:
        _enter()
    try:
        yield
    finally:
        if entered:
            _exit()
        _tls.stack = saved
