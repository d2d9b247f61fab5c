"""Test/chaos support utilities of the PyTorch port (deterministic fault
injection for serving and training, thread ranks for the mesh)."""
from .faults import FaultInjector, TrainFaultInjector, seeded_plan  # noqa: F401
from .ranks import ThreadRankSet, run_thread_ranks  # noqa: F401

__all__ = ["FaultInjector", "TrainFaultInjector", "seeded_plan",
           "ThreadRankSet", "run_thread_ranks"]
