import os
import sys
import types

import pytest

# test modules import their helpers as `tests.<name>`; bind that name to
# this directory even where an installed top-level `tests` package would
# shadow it (a namespace directory loses to a regular package)
_tests = types.ModuleType("tests")
_tests.__path__ = [os.path.dirname(os.path.abspath(__file__))]
sys.modules["tests"] = _tests

# Tests run on the CPU backend with 8 virtual devices so multi-device
# sharding paths compile and execute without an accelerator.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA GPU (python -m pytest -m gpu "
        "tests/ on the card); skips elsewhere")
    # `-m gpu` selects only the card's tests and leaves JAX its default
    # platform; every other run is pinned to the CPU backend
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The card's `nvidia-smi` name and power limit; skips the test when
    JAX's backend is not a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU backend (python -m pytest -m gpu "
                    "tests/ on the card)")
    from chip_smoke import card_names

    return card_names()[0]
