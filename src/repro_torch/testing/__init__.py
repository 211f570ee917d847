"""Test support: the fault injector (counterpart of ``repro.testing``)."""
from .faults import FaultInjector, FaultProbe, PRESSURE_KINDS, pressure_trace

__all__ = ["FaultInjector", "FaultProbe", "PRESSURE_KINDS", "pressure_trace"]
