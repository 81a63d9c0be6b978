"""The rest of a run, past the look for a card, on the CPU at reduced
planes: a sound run comes out correct, and each fault the cell can have,
planted under the timed path, and the lower-precision control come out
not correct against the cell's own limits."""

import time

import pytest

from conftest import small_cell
import calibrate
import faults
import run
from harness import check

SEED = 2 ** 31 + 2024


def _execute(cell, tmp_path):
    return run.execute(cell, SEED, 0.5, 0, time.time(), "cpu",
                       str(tmp_path))


@pytest.mark.parametrize("name", ["unet.pce_b24", "unet_cct.dmpls_b6",
                                  "unet.val_fold", "unet.pce_b24_f32"])
def test_a_sound_run_is_correct(name, tmp_path):
    # f32 at 32x32 on the CPU: the program's plain path agrees with the
    # reference to rounding, well inside every limit
    res = _execute(small_cell(name, dtype="float32"), tmp_path)
    assert res.correct and res.failed == 0, res.checks
    assert {n for n, _, _ in res.checks} == set(small_cell(name).limits)


@pytest.mark.parametrize("name,fault", [
    ("unet.pce_b24", "unchanged"), ("unet.pce_b24", "half"),
    ("unet_cct.dmpls_b6", "unchanged"), ("unet_cct.dmpls_b6", "half"),
    ("unet.val_fold", "half"), ("unet.val_fold", "altered"),
    ("unet.pce_b24_f32", "unchanged"), ("unet.pce_b24_f32", "half")])
def test_a_planted_fault_is_not_correct(name, fault, tmp_path):
    cell = small_cell(name, dtype="float32")
    with faults.planted(cell.traffic["kind"], fault):
        res = _execute(cell, tmp_path)
    assert not res.correct, res.checks


@pytest.mark.parametrize("name", ["unet.pce_b24", "unet_cct.dmpls_b6",
                                  "unet.val_fold"])
def test_the_control_is_not_correct(name):
    # the cell's own precision, bf16, and the fp8 control below it (the
    # f32 cell's TF32 control needs a card: test_bench_card.py), at 64x64
    # planes and batch 8: at 32x32 the control's error on some seeds
    # stays inside the limits set at the cell's own size
    cell = small_cell(name, hw=64, batch=8)
    numbers = calibrate.readings(cell, SEED, "control", "cpu")
    ok, rows = check.verdict(numbers, cell.limits)
    assert not ok, rows
