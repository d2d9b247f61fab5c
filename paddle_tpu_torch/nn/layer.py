"""Parameter creation of the PyTorch port (counterpart of the
``ParamAttr`` / ``Layer.create_parameter`` rule of
``paddle_tpu/nn/layer.py``). The port's layers are ``torch.nn.Module``s;
they keep no ``Layer`` class of their own.

``create_parameter`` picks the initializer as the JAX rule does: the
``ParamAttr``'s, else the layer's default, else ``Constant(0)`` for a
bias and ``XavierNormal`` otherwise. A parameter is float32 on
``device``, drawn from ``generator``; without one, a random initializer
draws from a generator seeded from the port's default chain
(``core.random.fresh_seed``), the counterpart of the JAX key chain that
the JAX initializers consume (a constant one draws nothing)."""
import torch

from ..core import random as _random
from ..core.device import DEFAULT_DEVICE, resolve_device
from . import initializer as I

__all__ = ["ParamAttr", "create_parameter", "functional_layer", "model_init"]


class ParamAttr:
    """paddle's parameter attribute bundle. ``initializer`` picks the
    initializer; ``trainable`` False makes a parameter without a
    gradient; ``learning_rate`` and ``need_clip`` are set on the
    parameter, where the port's optimizer and clips read them.
    ``name`` and ``regularizer`` are kept and not read."""

    def __init__(self, name=None, initializer=None, learning_rate=None,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, generator=None,
                     device=DEFAULT_DEVICE):
    """A float32 ``torch.nn.Parameter`` of ``shape`` by the JAX rule
    (module docstring)."""
    device = resolve_device(device)
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    elif default_initializer is not None:
        init = default_initializer
    else:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    if generator is None and not isinstance(init, I.Constant):
        generator = _random.make_generator(_random.fresh_seed(device),
                                           device)
    p = torch.nn.Parameter(init(tuple(int(s) for s in shape), generator,
                                device))
    if attr is not None:
        if getattr(attr, "trainable", True) is False:
            p.requires_grad_(False)
        if getattr(attr, "learning_rate", None) is not None:
            p.optimize_attr = {"learning_rate": attr.learning_rate}
        if getattr(attr, "need_clip", True) is False:
            p.need_clip = False
    return p


def model_init(device=DEFAULT_DEVICE, seed=0, generator=None):
    """``dict(generator=, device=)`` for the layers of a model built on
    ``device`` from ``generator``, or from one seeded with ``seed``."""
    dev = resolve_device(device)
    return dict(generator=generator if generator is not None
                else _random.make_generator(seed, dev), device=dev)


def functional_layer(name, fn, *args):
    """A ``torch.nn.Module`` class ``name`` over the functional ``fn``:
    its constructor takes ``args`` ((name, default) pairs, in order,
    positionally or by keyword; paddle's ``name=`` is taken and dropped)
    and keeps each as an attribute, and ``forward(*inputs)`` is
    ``fn(*inputs, **those attributes)``, as the JAX layers that wrap one
    functional read theirs."""
    names = [n for n, _ in args]

    def __init__(self, *values, **kw):
        torch.nn.Module.__init__(self)
        kw.pop("name", None)
        given = dict(zip(names, values))
        if len(values) > len(names) or set(kw) - set(names) \
                or set(kw) & set(given):
            raise TypeError(f"{name}: takes {names}, got {len(values)} "
                            f"positional and {sorted(kw)}")
        for n, default in args:
            setattr(self, n, given.get(n, kw.get(n, default)))

    def forward(self, *inputs):
        return fn(*inputs, **{n: getattr(self, n) for n in names})

    def extra_repr(self):
        return ", ".join(f"{n}={getattr(self, n)}" for n in names)

    return type(name, (torch.nn.Module,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__doc__": f"``{fn.__module__}.{fn.__name__}`` as a layer."})
