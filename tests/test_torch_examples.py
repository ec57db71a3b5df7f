"""The example twins (``examples/torch/``) on the CPU: each through
runpy with ``--device cpu`` (its own assertions are the check),
``run_all.py``, ex13 on four gloo ranks under ``testing.multiproc``,
and ex16 beside the reference's ex16: the same tiles, results within
1e-4 (f32) relative to the largest entry of each result."""

import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from slate_tpu_torch.testing import multiproc as mp

REPO = pathlib.Path(__file__).resolve().parents[1]
TWINS = REPO / "examples" / "torch"
NAMES = sorted(p.name for p in TWINS.glob("ex*.py"))


def test_every_reference_example_has_a_twin():
    ref = sorted(p.name for p in (REPO / "examples").glob("ex*.py"))
    assert NAMES == ref and len(NAMES) == 17


def _run(path, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", [str(path), *args])
    return runpy.run_path(str(path), run_name="__main__")


@pytest.mark.parametrize("name", NAMES)
def test_twin_runs_on_cpu(name, monkeypatch, capsys):
    _run(TWINS / name, monkeypatch, "--device", "cpu")
    assert "FAILED" not in capsys.readouterr().out


def test_twin_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the default without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(TWINS / "ex01_matrix.py", monkeypatch)


def test_run_all_on_cpu():
    out = subprocess.run([sys.executable, str(TWINS / "run_all.py"),
                          "--device", "cpu"], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "All examples passed" in out.stdout
    assert out.stdout.count("=== ex") == 17


def test_ex13_on_four_gloo_ranks():
    _, outs = mp.launch(str(TWINS / "ex13_distributed_mesh.py"), 4,
                        extra_args=["--device", "cpu"], timeout=300)
    recs = [mp.results(o)["ex13"] for o in outs]
    assert [(r["p"], r["q"]) for r in recs] == [(2, 2)] * 4
    assert all(r["resid"] < 1e-4 for r in recs)
    assert len({r["resid"] for r in recs}) == 1      # one global X


def _within(x, ref, tol=1e-4):
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max(), (
        np.abs(x - ref).max(), np.abs(ref).max())


def test_ex16_beside_reference(monkeypatch):
    j = _run(REPO / "examples" / "ex16_non_uniform_tiles.py", monkeypatch)
    t = _run(TWINS / "ex16_non_uniform_tiles.py", monkeypatch,
             "--device", "cpu")
    for name in ("A", "B", "S", "C"):
        J, T = j[name], t[name]
        assert (T.m, T.n, T.mb, T.nb, T.mt, T.nt, T.rb, T.cb) == \
            (J.m, J.n, J.mb, J.nb, J.mt, J.nt, J.rb, J.cb), name
        _within(T.to_numpy(), J.to_numpy())
    assert np.array_equal(t["F"].pivots.numpy()[:24],
                          np.asarray(j["F"].pivots)[:24])
    _within(t["x"].to_numpy(), j["x"].to_numpy())
