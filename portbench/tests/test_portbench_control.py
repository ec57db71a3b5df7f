"""The comparison that decides ``correct`` fails its control and the
planted faults, and passes the program: at n = 256 on the CPU, under the
limits of the real cells (``limits/``). On a card, the same at the
cells' own size (``-m card``)."""

import pytest
import torch

from portbench import harness
from portbench.registry import Registry

#: test cell -> the real cell whose limit it is held to
REAL = {"tiny.rhs64": "lu_f32.rhs64", "tiny.rhs1": "lu_mixed.rhs1",
        "tiny.rhs300": "lu_f32.rhs8192"}
#: the faults each cell can have (one right-hand side has no half)
FAULTS = {"tiny.rhs64": ("unchanged", "half", "altered"),
          "tiny.rhs1": ("unchanged", "altered"),
          "tiny.rhs300": ("unchanged", "half", "altered")}


def _run(reg, cell, seed, entry=None, seconds=0.2, device="cpu"):
    c = reg.cell(cell)
    c.limits = Registry().cell(REAL.get(cell, cell)).limits
    return harness.measure(reg, c, seed, seconds, False,
                           torch.device(device), 0.0, entry=entry)


@pytest.mark.parametrize("cell", sorted(REAL))
def test_the_program_passes_and_the_control_fails(test_reg, tmp_tmpdir, cell):
    for seed in (101, 2 ** 31 + 7):
        ok = _run(test_reg, cell, seed)
        assert ok["correct"] is True, ok["checks"]
        bad = _run(test_reg, cell, seed, entry="control_lu_tf32")
        assert bad["correct"] is False, bad["checks"]
        assert bad["checks"]["berr_max"]["value"] > \
            3 * ok["checks"]["berr_max"]["value"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_each_fault_is_called_wrong(test_reg, tmp_tmpdir, cell, fault):
    entry = test_reg.cell(cell).config["entry"]
    r = _run(test_reg, cell, 4242, entry="fault_%s_%s" % (fault, entry))
    assert r["correct"] is False, r["checks"]
    assert r["failed"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell", ["lu_f32.rhs64", "lu_mixed.rhs1",
                                  "lu_f32.rhs8192"])
def test_at_the_cells_size_on_the_card(cell, tmp_tmpdir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    reg = Registry()
    for seed in (31, 2 ** 31 + 31, 9_000_000_031):
        ok = _run(reg, cell, seed, seconds=2.0, device="cuda")
        assert ok["correct"] is True, ok["checks"]
        bad = _run(reg, cell, seed, entry="control_lu_tf32", seconds=2.0,
                   device="cuda")
        assert bad["correct"] is False, bad["checks"]
