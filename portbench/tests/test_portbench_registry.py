"""Cells are found by name from BENCHMARK.json and the data files."""

import json
import os

import pytest

from portbench.registry import HERE, REPO, LookupFailed, Registry


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_resolves(cell):
    reg = Registry()
    c = reg.cell(cell)
    assert c.config["name"] == c.workload["config"]
    for kind, key in (("entries", "entry"), ("generators", "generator"),
                      ("checks", "check"), ("roofline", "roofline"),
                      ("launch", "launch")):
        reg.module(kind, c.config[key])
    assert callable(reg.module("loops", c.traffic["loop"]).run)
    assert c.traffic["nrhs"] >= 1 and c.traffic["pool"] >= 2
    assert c.limits["berr_max"] > 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in c.end_to_end + c.per_layer:
        assert callable(reg.module("metrics", m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in names


def test_reduced_keys_are_in_the_config_file():
    spec = _spec()
    for entry in spec["configs"]:
        with open(os.path.join(REPO, entry["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"]
        for key in entry["reduced"]:
            assert key in cfg and key in cfg["source_values"]


def test_an_unknown_name_is_refused():
    reg = Registry()
    with pytest.raises(LookupFailed):
        reg.cell("no_such.cell")
    with pytest.raises(LookupFailed):
        reg.module("metrics", "no_such_metric")


def test_a_cell_of_test_only_files_is_found(test_reg):
    c = test_reg.cell("tiny.added")
    assert c.config["launch"] == "cpu_inline"
    assert test_reg.path("launch", "cpu_inline", ".py").startswith(
        os.path.join(HERE, "tests"))
    assert [m["name"] for m in c.end_to_end][-1] == "tiny_calls"
    # the package's own files answer what the test root does not hold
    assert test_reg.path("entries", "gesv", ".py") == os.path.join(
        HERE, "entries", "gesv.py")
    assert test_reg.path("loops", "closed", ".py") == os.path.join(
        HERE, "loops", "closed.py")
    assert "tiny_calls" not in [m["name"]
                                for m in
                                test_reg.cell("tiny.rhs64").end_to_end]


def test_a_cell_of_its_own_shapes_check_and_loop_is_found(test_reg):
    """A tall least-squares cell: its generator, check, loop, entry and
    roofline are all test-only files; nothing of the package changed."""
    c = test_reg.cell("tiny.gels")
    for kind, name in (("generators", c.config["generator"]),
                       ("checks", c.config["check"]),
                       ("entries", c.config["entry"]),
                       ("roofline", c.config["roofline"]),
                       ("loops", c.traffic["loop"])):
        assert test_reg.path(kind, name, ".py").startswith(
            os.path.join(HERE, "tests")), (kind, name)
