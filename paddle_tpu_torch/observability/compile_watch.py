"""Compile watch: the port's compiles as registry metrics (counterpart of
``paddle_tpu/observability/compile_watch.py``, which listens to
``jax.monitoring``).

The port compiles in two places: ``ops/_build.py`` builds each
hand-written CUDA source with ``nvcc`` and loads the library, and
``torch.compile`` (which the port's own path does not use) traces and
compiles a frame. ``install()`` counts both:

* ``compiles_total{stage, fn}`` - stage "nvcc_build" / "library_load"
  (fn the source's name) or "torch_compile" (fn what triggered it);
* ``compile_seconds{stage}`` - wall time of each.

A steady training or serving loop adds nothing to either after its
warm-up: ``tools/torch_train_monitor.py`` gates "new compiles after
warmup" on ``compiles_total``. A torch without dynamo's callback handler
counts the builds alone.
"""
import threading
import time

from .metrics import get_registry

__all__ = ["install", "installed", "compiles", "COMPILE_STAGES"]

COMPILE_STAGES = ("nvcc_build", "library_load", "torch_compile")

# a library load takes ~1 ms, an nvcc build seconds to minutes
_COMPILE_BUCKETS = tuple(1e-4 * 4.0 ** i for i in range(10))

_installed = False
_dynamo_start = threading.local()


def _record(stage, fn, seconds):
    reg = get_registry()
    reg.counter("compiles_total",
                help="kernel builds, library loads and torch.compile "
                     "compiles", labels=("stage", "fn")).labels(
                         stage=stage, fn=str(fn)).inc()
    reg.histogram("compile_seconds", help="compile wall time",
                  labels=("stage",),
                  buckets=_COMPILE_BUCKETS).labels(stage=stage).observe(
                      seconds)


def _on_dynamo_start(args=None):
    _dynamo_start.t = time.perf_counter()


def _on_dynamo_end(args=None):
    t0 = getattr(_dynamo_start, "t", None)
    seconds = 0.0 if t0 is None else time.perf_counter() - t0
    _record("torch_compile", getattr(getattr(args, "callback_trigger", None),
                                     "name", "frame"),
            seconds)


def _hook_dynamo():
    try:
        from torch._dynamo.callback import callback_handler
    except ImportError:
        return
    if _on_dynamo_start not in getattr(callback_handler, "start_callbacks",
                                       ()):
        callback_handler.register_start_callback(_on_dynamo_start)
        callback_handler.register_end_callback(_on_dynamo_end)


def install():
    """Start counting compiles. Idempotent; ``torch._dynamo.reset()`` drops
    dynamo's callbacks, and calling ``install()`` again puts them back.
    Returns True."""
    global _installed
    if not _installed:
        from ..ops import _build
        _build.listeners.append(_record)
        _installed = True
    _hook_dynamo()
    return True


def installed():
    return _installed


def compiles(registry=None):
    """Sum of ``compiles_total`` over every stage and source."""
    reg = registry if registry is not None else get_registry()
    fam = reg.snapshot().get("compiles_total", {})
    return sum(c["value"] for c in fam.get("children", {}).values())
