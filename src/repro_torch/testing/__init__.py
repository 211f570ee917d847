"""Test support: the fault injector (counterpart of ``repro.testing``)."""
from .faults import FaultInjector, FaultProbe

__all__ = ["FaultInjector", "FaultProbe"]
