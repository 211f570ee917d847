"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the single CPU
device by default (CI's tier1-multidevice job exports
XLA_FLAGS=--xla_force_host_platform_device_count=8 itself); only
launch/dryrun.py forces 512 placeholder devices.

REPRO_TEST_IMPL=pallas_interpret re-points every ``impl='auto'`` kernel
dispatch at the Pallas kernel bodies in interpret mode (CI's
kernel-interpret job runs tests/test_kernels.py + tests/test_fused_kernel.py
this way, so the kernels — not just the jnp oracles — are validated on
every PR).
"""
import os

import numpy as np
import pytest

import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _reset_probe_counters():
    """The trace-time probes (``ops.DISPATCH_COUNTS``,
    ``engine.TRACE_COUNTS``, ``layers.MATERIALIZE_COUNTS``,
    ``resilience.FALLBACK_COUNTS``, ``residency.RESIDENCY_COUNTS``) are
    global Counters asserted by tests; reset them between tests so probe
    assertions can't leak across modules (a prior test's traces otherwise
    satisfy — or break — a later test's expectations)."""
    from repro.kernels import ops
    from repro.models import layers
    from repro.serve import engine, residency, resilience
    for counter in (ops.DISPATCH_COUNTS, engine.TRACE_COUNTS,
                    layers.MATERIALIZE_COUNTS, resilience.FALLBACK_COUNTS,
                    residency.RESIDENCY_COUNTS):
        counter.clear()
    yield


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skipped "
        "without one")
    impl = os.environ.get("REPRO_TEST_IMPL")
    if impl:
        from repro.kernels import ops
        ops.set_default_impl(impl)
