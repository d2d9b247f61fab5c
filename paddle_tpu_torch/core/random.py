"""Seeding for the PyTorch port (counterpart of ``paddle_tpu/core/random.py``).

The JAX package threads a PRNG key chain; the port hands out explicit
``torch.Generator`` objects instead. A generator lives on the device
whose tensors it draws for (``torch.multinomial`` on a CUDA tensor needs
a CUDA generator). The two frameworks give different bits for the same
seed: tests compare greedy paths exactly and sampled paths only for
determinism per seed."""
import torch

from .device import resolve_device


def make_generator(seed, device="cuda"):
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen
