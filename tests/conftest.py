"""Shared fixtures + the pinned hypothesis profile.

NOTE: XLA_FLAGS / device-count forcing is deliberately NOT set here — smoke
tests and benches must see the single real CPU device; only launch/dryrun.py
forces 512 placeholder devices (system prompt rule)."""

import os

import pytest

try:
    from hypothesis import HealthCheck, settings
except ImportError:
    pass                     # property tests are simply not collected
else:
    # "ci" (the default): PINNED — derandomize gives a fixed seed so every
    # run (local or CI) executes the identical example sequence, bounded
    # example counts keep the model-driven properties inside the CI budget,
    # and no deadline: jit compiles inside an example are not flakes.
    # Tests that pin their own @settings(...) override these per-field.
    settings.register_profile(
        "ci", max_examples=16, deadline=None, derandomize=True,
        suppress_health_check=[HealthCheck.too_slow])
    # "dev": opt-in randomized exploration (HYPOTHESIS_PROFILE=dev) for
    # hunting new counterexamples locally.
    settings.register_profile(
        "dev", max_examples=50, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (a hand-written kernel has no "
        "CPU mode); skips without one")


def pytest_addoption(parser):
    parser.addoption(
        "--soak", action="store_true", default=False,
        help="run long-duration concurrency soak tests",
    )


@pytest.fixture
def soak(request):
    return request.config.getoption("--soak")
