"""A run of each cell on a card, as the benchmark's command runs it (skips
without a card)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from harness import spec


@pytest.mark.parametrize("workload", spec.cells(spec.load_spec(ROOT)))
def test_a_short_run_prints_a_correct_result(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_the_f32_control_is_not_correct(card):
    # TF32, the step below float32, exists only on the card
    import calibrate
    from conftest import small_cell
    from harness import check

    cell = small_cell("unet.pce_b24_f32", hw=64, batch=8)
    sound = calibrate.readings(cell, 2 ** 31 + 7, "program", card)
    control = calibrate.readings(cell, 2 ** 31 + 7, "control", card)
    assert check.verdict(sound, cell.limits)[0]
    assert not check.verdict(control, cell.limits)[0]
