"""Seeding for the PyTorch port (counterpart of ``paddle_tpu/core/random.py``).

The JAX package threads a PRNG key chain; the port hands out explicit
``torch.Generator`` objects instead. A generator lives on the device
whose tensors it draws for (``torch.multinomial`` on a CUDA tensor needs
a CUDA generator). The two frameworks give different bits for the same
seed: tests compare greedy paths exactly and sampled paths only for
determinism per seed.

The default chain (``seed``, ``fresh_seed``) is the counterpart of the
JAX package's global key chain (``seed`` and ``fresh_key_tensor``): one
generator per device, kept on the host so that a draw never waits on the
card. A random op takes a seed drawn from it in its forward and builds
its own generator from that seed, as a JAX op takes its key as an input;
``get_state`` / ``set_state`` let activation recompute replay the chain
(``distributed.fleet.recompute``)."""
import threading

import torch

from .device import resolve_device

_DEFAULT_SEED = 0
_lock = threading.Lock()
_chain = {"seed": _DEFAULT_SEED, "gens": {}}


def make_generator(seed, device="cuda"):
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


def seed(s):
    """paddle.seed: reset the default chain of every device to ``s``."""
    with _lock:
        _chain["seed"] = int(s)
        _chain["gens"] = {}
    return int(s)


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _generator(device):
    """The default chain's generator for ``device`` (a host generator,
    seeded from ``seed`` and the device's name)."""
    key = _key(device)
    with _lock:
        gen = _chain["gens"].get(key)
        if gen is None:
            gen = torch.Generator()
            gen.manual_seed((_chain["seed"] * 1_000_003
                             + sum(key.encode())) % (1 << 63))
            _chain["gens"][key] = gen
    return gen


def fresh_seed(device="cuda"):
    """A fresh 64-bit seed from ``device``'s default generator: the port's
    counterpart of a key passed to an op as an input."""
    gen = _generator(device)
    with _lock:
        return int(torch.randint(0, (1 << 63) - 1, (), generator=gen))


def get_state():
    """The default chain's state: {device: generator state}."""
    with _lock:
        return {k: g.get_state() for k, g in _chain["gens"].items()}


def set_state(state):
    """Restore a state ``get_state`` returned (devices it lacks start
    afresh from the seed)."""
    with _lock:
        gens = {}
        for k, st in state.items():
            g = torch.Generator()
            g.set_state(st)
            gens[k] = g
        _chain["gens"] = gens
