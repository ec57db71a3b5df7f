"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
slate_tpu (top-level names compared whole: the port's name begins with
the JAX package's), and the reference loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from portbench import run
from portbench.registry import HERE, REPO

_PROBE = r"""
import sys, os, torch
from portbench import harness, run
from portbench.registry import Registry, HERE
cells = os.path.join(HERE, "tests", "cells")
reg = Registry(os.path.join(cells, "benchmark.json"), roots=(cells, HERE))
for cell in ("tiny.rhs64", "tiny.rhs1", "tiny.gels"):
    for traced in (False, True):
        harness.measure(reg, reg.cell(cell), 11, 0.2, traced,
                        torch.device("cpu"), 0.0)
full = Registry()
for w in full.spec["workloads"]:
    c = full.cell(w["name"])
    for kind, key in (("entries", "entry"), ("generators", "generator"),
                      ("checks", "check"), ("roofline", "roofline"),
                      ("launch", "launch")):
        full.module(kind, c.config[key])
    full.module("loops", c.traffic["loop"])
    for m in c.end_to_end + c.per_layer:
        full.module("metrics", m["name"])
full.module("entries", "control_lu_tf32")
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_the_check_compares_top_level_names_whole():
    assert run.forbidden_modules(["slate_tpu_torch", "slate_tpu_torch.lu",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["slate_tpu.linalg", "jax._src", "flax",
                                  "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "slate_tpu"]


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "slate_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_under_portbench_names_jax_or_slate_tpu():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(HERE, "reference", "*.py"))
    assert files
    for path in files:
        tops = set(_imports(path))
        assert "slate_tpu_torch" not in tops, path
        assert tops <= {"torch", "portbench", "__future__", "math"}, path
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference.lu, "
         "portbench.reference.backward_error; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "slate_tpu_torch" not in p.stdout
