"""The result line, the CPU rehearsal of each cell's loop at n = 256, a
cell of test-only files, and the refusal to measure without a card."""

import contextlib
import io
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, run
from portbench.registry import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _main(argv, reg):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv, reg=reg)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("traced", [0, 1])
def test_the_last_line_has_its_keys_and_checks_close_stderr(
        test_reg, tmp_tmpdir, traced):
    rc, out, err = _main(["--workload", "tiny.added", "--seed",
                          str(2 ** 31 + 12345), "--seconds", "1.5",
                          "--trace", str(traced)], test_reg)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    keys = KEYS[:-1] + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the test-only metric is reported in its own cell
        assert line["metrics"]["tiny_calls"]["value"] == line["attempted"]
    last = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), last):
        assert text == "check %s %s limit %s" % (name, c["value"],
                                                 c["limit"])


@pytest.mark.parametrize("cell", ["tiny.rhs64", "tiny.rhs1", "tiny.rhs300"])
def test_cpu_rehearsal_of_each_cell(test_reg, tmp_tmpdir, cell):
    c = test_reg.cell(cell)
    for traced in (False, True):
        r = harness.measure(test_reg, c, 987654321987, 1.5, traced,
                            torch.device("cpu"), 0.0)
        assert r["correct"] is True, r["checks"]
        assert r["attempted"] >= 1 and r["failed"] == 0
        if not traced:
            want = {m["name"] for m in c.end_to_end}
            # a percentile needs two calls at least
            if r["attempted"] < 2:
                want -= {"solve_p90_ms", "solve_p90_ms.mixed"}
            assert set(r["metrics"]) == want
    if cell == "tiny.rhs1":
        assert r["metrics"]["refine_iters"]["value"] >= 0


def test_the_same_seed_makes_the_same_inputs(test_reg):
    c = test_reg.cell("tiny.rhs64")
    gen = test_reg.module("generators", c.config["generator"])
    cfg, tr = dict(c.config, n=64), dict(c.traffic, nrhs=3)
    s1 = gen.make(5, 1, cfg, tr, "cpu")
    s2 = gen.make(5, 1, cfg, tr, "cpu")
    s3 = gen.make(5, 2, cfg, tr, "cpu")
    assert s1["a"].shape == (64, 64) and s1["b"].shape == (64, 3)
    assert torch.equal(s1["a"], s2["a"]) and torch.equal(s1["b"], s2["b"])
    assert not torch.equal(s1["a"], s3["a"])


@pytest.mark.parametrize("traced", [0, 1])
def test_a_cell_of_its_own_shapes_check_and_loop_runs(test_reg, tmp_tmpdir,
                                                      traced):
    """tiny.gels: a tall A, X judged by the normal equations' residual,
    calls arriving at a fixed rate; only test-only files and entries of
    the test's BENCHMARK.json make it."""
    rc, out, err = _main(["--workload", "tiny.gels", "--seed",
                          str(2 ** 33 + 5), "--seconds", "0.5",
                          "--trace", str(traced)], test_reg)
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"normal_residual_max", "calls_failed"}
    assert line["attempted"] >= 2
    if not traced:
        assert set(line["metrics"]) == {"gflops", "solve_p90_ms", "setup_s"}
    c = test_reg.cell("tiny.gels")
    bad = harness.measure(test_reg, c, 77, 0.2, False, torch.device("cpu"),
                          0.0, entry="test_gels_altered")
    assert bad["correct"] is False and bad["failed"] >= 1, bad["checks"]


def test_the_measurement_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "lu_f32.rhs64", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
    assert "is_available() is False" in err.getvalue()
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "lu_mixed.rhs1", "--seed", "3", "--seconds", "1",
                        "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
