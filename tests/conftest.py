"""Test-suite bootstrap: register the deterministic hypothesis shim when the
real package is not installed, so collection works on bare environments."""

import sys

try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_shim

    hyp = sys.modules["hypothesis"] = _hypothesis_shim
    sys.modules["hypothesis.strategies"] = hyp.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
        "without them")
