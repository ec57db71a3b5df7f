"""The classical and panel operation and byte counts against hand-worked
cases."""

import pytest

from portbench.roofline import lu, peaks


def _panel_ops_by_hand(m, w):
    """Partial-pivot LU of an m x w panel, column by column: m - j - 1
    divisions and an (m - j - 1) x (w - j - 1) rank-1 update of 2 flops
    an entry."""
    return sum((m - j - 1) + 2 * (m - j - 1) * (w - j - 1)
               for j in range(w))


def test_classical_flops():
    assert lu.classical_flops(3, 2) == pytest.approx(2 / 3 * 27 + 2 * 9 * 2)
    # PERF.md's 16384 / 64 rhs gesv: 2.966e12
    assert lu.classical_flops(16384, 64) == pytest.approx(2.966e12, rel=1e-3)
    assert lu.call_flops({"n": 16384}, {"nrhs": 8192}) == pytest.approx(
        2 / 3 * 16384 ** 3 + 2 * 16384 ** 2 * 8192)


@pytest.mark.parametrize("m,w", [(2048, 256), (4096, 512), (512, 512)])
def test_panel_flops_is_the_leading_order_count(m, w):
    # m w^2 - w^3 / 3 drops the terms of order m w and w^2
    assert lu.panel_flops(m, w) == pytest.approx(_panel_ops_by_hand(m, w),
                                                 rel=3.0 / w)
    assert lu.panel_flops(4, 2) == pytest.approx(16 - 8 / 3)


def test_panel_bytes_and_schedule():
    assert lu.panel_bytes(1024, 512, "float32") == 2 * 1024 * 512 * 4 + 4 * 512
    assert lu.panel_bytes(1024, 512, "bfloat16") == \
        2 * 1024 * 512 * 2 + 4 * 512
    assert lu.panel_schedule(1024, 512) == [(1024, 512), (512, 512)]
    assert lu.panel_schedule(1000, 512) == [(1000, 512), (488, 488)]
    assert len(lu.panel_schedule(16384, 512)) == 32


def test_panel_bound_by_hand():
    # n = 1024, nb = 512, f32: panels 1024 x 512 and 512 x 512, both
    # bound by their operations at 67 TFLOP/s
    f1 = 1024 * 512 ** 2 - 512 ** 3 / 3
    f2 = 512 * 512 ** 2 - 512 ** 3 / 3
    cfg = {"n": 1024, "block_size": 512, "factor_dtype": "float32"}
    assert lu.panel_bound_s(cfg) == pytest.approx((f1 + f2) / 67e12)
    # bf16: 989 TFLOP/s against 3.35 TB/s; the 1024 x 512 panel's 2 MiB
    # read and written take 0.63 us against 0.26 us of operations
    cfg["factor_dtype"] = "bfloat16"
    b1 = (2 * 1024 * 512 * 2 + 2048) / 3.35e12
    b2 = (2 * 512 * 512 * 2 + 2048) / 3.35e12
    assert lu.panel_bound_s(cfg) == pytest.approx(b1 + b2)
    assert peaks.bound_s(1e12, 0, "float32") == pytest.approx(1 / 67)
