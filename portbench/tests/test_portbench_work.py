"""The roofline's operation and byte counts against hand counts."""

import pytest

from portbench import peaks, work


def test_dense_adam_step_bytes():
    # 7M configuration: (91,641 + 17,560) rows x 128 x (p r/w 8 + m r/w 8 + v r/w 8)
    w = work.train_step("adam", 91_641, 17_560, 128, 10_000)
    tables = 109_201 * 128 * 24
    batch = 10_000 * 12 + 2 * 2 * 10_000 * 128 * 4
    assert w.nbytes == tables + batch
    assert w.computed_in == "float32"
    assert w.least_seconds() == pytest.approx((tables + batch) / 3.35e12)
    assert work.train_step("fused_adam", 91_641, 17_560, 128, 10_000) == w


def test_bf16_moments_and_lazy():
    w = work.train_step("fused_adam_bf16m", 10, 20, 8, 4)
    assert w.nbytes == 30 * 8 * (8 + 8) + 4 * 12 + 2 * 2 * 4 * 8 * 4
    lazy = work.train_step("lazy_adam", 10, 20, 8, 4, touched_rows=5)
    assert lazy.nbytes == 5 * 8 * 24 + 4 * 12 + 2 * 2 * 4 * 8 * 4
    with pytest.raises(ValueError):
        work.train_step("lazy_adam", 10, 20, 8, 4)


def test_scan_counts():
    w = work.scan(350_000, 128, 256, 10)
    assert w.nbytes == 350_000 * 128 * 4 + 256 * 128 * 4 + 256 * 10 * 12
    assert w.flops == 2 * 256 * 350_000 * 128 and w.computed_in == "tf32"
    assert w.least_seconds() == pytest.approx(max(w.nbytes / peaks.HBM_BYTES_PER_S,
                                                  w.flops / peaks.TF32_FLOPS))
    one = work.scan(17_560, 128, 1, 10, mask=True, head=True)
    assert one.nbytes == 17_560 * 128 * 4 + 128 * 4 + 120 + 17_560
    assert one.flops == 2 * 17_560 * 128 + 4 * 17_560 and one.computed_in == "float32"
