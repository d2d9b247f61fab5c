"""Test/chaos support utilities of the PyTorch port (deterministic fault
injection for serving and training)."""
from .faults import FaultInjector, TrainFaultInjector, seeded_plan  # noqa: F401

__all__ = ["FaultInjector", "TrainFaultInjector", "seeded_plan"]
