"""The benchmark's own tests (not collected by the repository's tests/):
run them with ``python -m pytest benchmark/tests -q``. Tests that need a
CUDA card decide so in the ``card`` fixture and skip without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def small_cell(name, dtype=None, root=ROOT, hw=32, batch=4):
    """The cell at planes and batches a CPU test can hold (hw x hw, a few
    slices); widths as published."""
    from harness import spec

    cell = spec.find_cell(name, root)
    cell.config["patch_size"] = [hw, hw]
    t = cell.traffic
    if t["kind"] == "train":
        t.update(batch=batch, steps_per_call=2, traced_steps=2,
                 datasets=[dict(d, slices=4 * batch)
                           for d in t["datasets"]])
    else:
        t.update(volumes=3, depth=5, height=24, width=32, chunk=16,
                 traced_passes=1)
    if dtype is not None:
        t["compute_dtype"] = dtype
    return cell
