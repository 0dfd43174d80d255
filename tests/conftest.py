"""Shared pytest fixtures.

NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the real
single CPU device.  Distributed tests that need fake devices run
themselves in a subprocess (tests/test_distributed.py).
"""
import os
import signal
import sys

import pytest

# make tests/proptest.py importable regardless of invocation directory
sys.path.insert(0, os.path.dirname(__file__))

# Per-test wall-clock limit, seconds; 0 disables.  pytest-timeout is not
# in the container, so this is a SIGALRM equivalent: a wedged test (a
# hung compile, a scheduler that fails to drain) dies with a TimeoutError
# naming itself instead of stalling the whole CI job until the runner's
# global kill.  Main-thread only (SIGALRM), which is how this suite runs.
TEST_TIMEOUT_S = float(os.environ.get("REPRO_TEST_TIMEOUT", "600"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (launches the PyTorch port's "
        "CUDA kernels); skips without one")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if TEST_TIMEOUT_S <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _expire(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded REPRO_TEST_TIMEOUT="
            f"{TEST_TIMEOUT_S:.0f}s")

    old = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def tmp_autotune_cache(tmp_path, monkeypatch):
    """Isolated on-disk autotune cache (shared by the fusion test files)."""
    from repro.kernels import autotune as autotune_mod
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    autotune_mod.clear_memory_cache()
    yield tmp_path / "at.json"
    autotune_mod.clear_memory_cache()
