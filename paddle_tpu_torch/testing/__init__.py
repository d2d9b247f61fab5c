"""Test/chaos support utilities of the PyTorch port (deterministic fault
injection)."""
from .faults import FaultInjector, seeded_plan  # noqa: F401

__all__ = ["FaultInjector", "seeded_plan"]
