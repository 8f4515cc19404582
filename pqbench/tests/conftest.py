"""Fixtures of the benchmark's CPU tests.

Run with ``python -m pytest pqbench/tests``.  Tests that need the card are
marked ``cuda`` and skip without one; whether there is a card is decided
inside each such test.
"""

import pytest

from pqbench_support import make_root


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A throwaway checkout root holding the benchmark's own files with
    every configuration cut to a size the CPU runs in seconds (its layout
    pinned from a write at that size)."""
    return make_root(str(tmp_path_factory.mktemp("pqbench_root")))
