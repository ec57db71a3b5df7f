"""The benchmark's own tests: ``python3 -m pytest portbench/tests`` here
on the CPU; ``-m card`` on a machine with an H100 runs the tests that
need one (they skip elsewhere, deciding inside the test)."""

import os

import pytest

from portbench.registry import HERE, Registry

CELLS = os.path.join(HERE, "tests", "cells")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def test_reg():
    """The registry of the test-only cells, in front of the package's
    own files."""
    return Registry(os.path.join(CELLS, "benchmark.json"),
                    roots=(CELLS, HERE))


@pytest.fixture
def tmp_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    yield tmp_path
    tempfile.tempdir = None
