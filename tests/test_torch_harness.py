"""The port's sweep tester and its junit orchestrator
(``slate_tpu_torch/testing/tester.py``, ``run_tests.py``) against the
JAX package's: the spec parsers, the FLOP formulas, the groups and size
classes, the junit XML byte for byte, ``run_one``'s status and error
ratios, the CLI on the CPU, and a 2 x 2 sweep of four gloo ranks.

On the CPU; the port is asked for it (``--device cpu``). The JAX side
runs only gemm, potrf, gesv and gels, which bounds its compile time.
Error ratios are in units of n eps (the reference's); the port's
inputs come from a torch.Generator, the reference's from numpy, so the
two agree statistically: within 10x, with a floor of 0.01 under which
both are exact to well inside one unit."""

import importlib
import json
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from slate_tpu.testing import run_tests as jrun

from slate_tpu_torch.testing import multiproc as mp
from slate_tpu_torch.testing import run_tests as trun
from slate_tpu_torch.testing import tester as ttester

CPU = ["--device", "cpu"]
ROUTINES = ("gemm", "potrf", "posv", "getrf", "gesv", "geqrf", "gels",
            "heev", "svd", "hesv", "gbsv", "pbsv", "gbmm")
JAX_ROUTINES = ("gemm", "potrf", "gesv", "gels")
RATIO = 10.0
RATIO_FLOOR = 0.01


@pytest.fixture(scope="module")
def jtester():
    """The JAX package's tester, imported for this module only: its
    functions bind ``out=sys.stdout`` when the module is first
    imported, so a copy imported here would keep this module's stdout
    for a later test that captures the reference's CLI output
    (tests/test_harness.py imports it inside its test). Teardown
    forgets the module, so the next import is a fresh one."""
    mod = importlib.import_module("slate_tpu.testing.tester")
    yield mod
    sys.modules.pop("slate_tpu.testing.tester", None)
    pkg = sys.modules.get("slate_tpu.testing")
    if pkg is not None and getattr(pkg, "tester", None) is mod:
        delattr(pkg, "tester")


@pytest.mark.parametrize("spec", ["256", "64:128:*2", "1:10:3",
                                  "16,32,100:400:100", "1024:4096:*2",
                                  "7:7:1", "5:4:1", "3:100:*3,8"])
def test_parse_dims_matches_reference(jtester, spec):
    assert ttester._parse_dims(spec) == jtester._parse_dims(spec)


@pytest.mark.parametrize("routine", ROUTINES + ("trsm", "herk", "norm"))
@pytest.mark.parametrize("m,n,k", [(64, 64, 10), (1000, 300, 7),
                                   (16384, 16384, 16384)])
def test_gflops_matches_reference(jtester, routine, m, n, k):
    assert ttester._gflops(routine, m, n, k) == \
        jtester._gflops(routine, m, n, k)


def test_groups_sizes_and_dtypes_match_reference(jtester):
    assert trun.GROUPS == jrun.GROUPS
    assert trun.SIZES == jrun.SIZES
    assert trun.ALL == jrun.ALL
    assert ttester.DTYPES == jtester.DTYPES


def _rows():
    return [dict(routine="gemm", n=64, dtype="float32", nb=32, time=0.25,
                 gflops=1.5, error=0.01, status="pass", grid="1x1"),
            dict(routine="gesv", n=128, dtype="float64", nb=64,
                 time=1.23456, gflops=0.0, error=250.0, status="FAILED",
                 grid="2x2"),
            dict(routine="svd", n=64, dtype="float32", nb=32, time=0.0,
                 gflops=0.0, error=None, status="FAILED", grid="1x1",
                 detail="ValueError: <bad> & \"quoted\"")]


def test_write_junit_bytes_match_reference(tmp_path):
    rows = _rows()
    jrun.write_junit(rows, str(tmp_path / "j.xml"), 3.14159)
    trun.write_junit(rows, str(tmp_path / "t.xml"), 3.14159)
    assert (tmp_path / "t.xml").read_bytes() == \
        (tmp_path / "j.xml").read_bytes()


def _close(t_err, j_err):
    return (t_err <= RATIO * max(j_err, RATIO_FLOOR)
            and j_err <= RATIO * max(t_err, RATIO_FLOOR))


@pytest.mark.parametrize("types", ["s", "d"])
@pytest.mark.parametrize("routine", ROUTINES)
def test_run_one_status_matches_reference(jtester, routine, types):
    """Every routine passes on the CPU at n = 64, nb 32, as the
    reference's own CLI test expects; gemm, potrf, gesv and gels are
    also run through the JAX package, with status and error ratio
    held to its."""
    dt = ttester.DTYPES[types]
    r = ttester.run_one(routine, 64, dt, 32, True, False, device="cpu")
    assert r["status"] == "pass", r
    assert r["dtype"] == np.dtype(dt).name and r["time"] > 0
    if routine not in JAX_ROUTINES:
        return
    j = jtester.run_one(routine, 64, dt, 32, True, False)
    assert r["status"] == j["status"]
    assert set(r) == set(j)
    assert _close(r["error"], j["error"]), (r["error"], j["error"])


@pytest.mark.parametrize("routine", JAX_ROUTINES + ("getrf", "posv"))
def test_run_one_ref_matches_reference(jtester, routine):
    """--ref y: the host comparison (numpy / scipy)."""
    r = ttester.run_one(routine, 64, np.float64, 32, False, True,
                        device="cpu")
    assert r["status"] == "pass", r
    if routine in JAX_ROUTINES:
        j = jtester.run_one(routine, 64, np.float64, 32, False, True)
        assert _close(r["error"], j["error"]), (r["error"], j["error"])


def test_run_one_complex_and_unknown():
    for dt in (np.complex64, np.complex128):
        for routine in ("gemm", "posv", "gesv", "heev"):
            r = ttester.run_one(routine, 48, dt, 16, True, False,
                                device="cpu")
            assert r["status"] == "pass", r
    with pytest.raises(ValueError):
        ttester.run_one("nosuch", 8, np.float32, 4, True, False,
                        device="cpu")
    rows = ttester.sweep(["nosuch", "gemm"], "16", "s", "8", "1x1",
                         device="cpu")
    assert [r["status"] for r in rows] == ["FAILED", "pass"]
    assert rows[0]["detail"].startswith("ValueError")


def test_tester_cli_quick(capsys, tmp_path):
    trace = tmp_path / "sweep.json"
    rc = ttester.main(["gemm", "potrf", "--dim", "64", "--type", "s,d",
                       "--nb", "32", "--trace-out", str(trace)] + CPU)
    out = capsys.readouterr().out
    assert rc == 0
    assert "All tests passed" in out
    assert "gemm" in out and "potrf" in out
    assert json.loads(trace.read_text())["traceEvents"]
    from slate_tpu_torch import obs
    obs.disable()


def test_grid_larger_than_world_is_skipped(capsys):
    rows = ttester.sweep(["gesv"], "32", "s", "16", "2x2,1x1",
                         device="cpu")
    assert [r["grid"] for r in rows] == ["1x1"]
    assert "grid 2x2 skipped: only 1 ranks" in capsys.readouterr().out


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttester.main(["gemm", "--dim", "16", "--nb", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["blas3", "--dim", "16", "--nb", "8"])


def test_run_tests_quick_writes_junit(tmp_path, capsys):
    path = tmp_path / "quick.xml"
    rc = trun.main(["--quick", "--xml", str(path)] + CPU)
    out = capsys.readouterr().out
    assert rc == 0, out
    suite = ET.parse(path).getroot()
    assert suite.get("name") == "slate_tpu.tester"
    cases = suite.findall("testcase")
    assert int(suite.get("tests")) == len(cases) == 2 * len(trun.ALL)
    assert suite.get("failures") == "0"
    assert {c.get("classname") for c in cases} == \
        {"tester." + r for r in trun.ALL}
    assert "gesv_float32_n128_nb32_g1x1" in {c.get("name") for c in cases}


def test_run_tests_rejects_unknown_group(capsys):
    with pytest.raises(SystemExit):
        trun.main(["nosuch"] + CPU)


def test_sweep_on_2x2_grid_of_four_gloo_ranks():
    """One launch: potrf and gesv at n = 64 on a 2 x 2 grid, the
    drivers under Option.Grid + MethodFactor.Tiled, on every rank."""
    _, outs = mp.launch(
        "slate_tpu_torch.testing.sweep_checks", 4,
        extra_args=["potrf", "gesv", "--dim", "64", "--nb", "32",
                    "--type", "s,d", "--grid", "2x2"] + CPU,
        timeout=300)
    errs = []
    for out in outs:
        rows = mp.results(out)["rows"]["rows"]
        assert [(r["routine"], r["grid"], r["status"]) for r in rows] == \
            [(rt, "2x2", "pass") for rt in ("potrf", "potrf", "gesv",
                                             "gesv")], out[-2000:]
        errs.append([r["error"] for r in rows])
    # every rank holds the same global factors
    assert all(e == errs[0] for e in errs)
