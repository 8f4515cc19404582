"""Fixtures of the benchmark's CPU tests.

Run with ``python -m pytest pqbench/tests``.  Tests that need the card are
marked ``cuda`` and skip without one; whether there is a card is decided
inside each such test.
"""

import pytest

from pqbench_support import add_nested, make_root


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A throwaway checkout root holding the benchmark's own files with
    every configuration cut to a size the CPU runs in seconds (its layout
    pinned from a write at that size)."""
    return make_root(str(tmp_path_factory.mktemp("pqbench_root")))


@pytest.fixture(scope="session")
def nested_root(tiny_root, tmp_path_factory):
    """``tiny_root`` with the nested configuration and its full-scan cell
    added by files and entries (:func:`pqbench_support.add_nested`)."""
    import shutil

    root = str(tmp_path_factory.mktemp("pqbench_nested") / "root")
    shutil.copytree(tiny_root, root)
    add_nested(root)
    return root
