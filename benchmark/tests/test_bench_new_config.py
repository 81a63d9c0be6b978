"""A configuration of another architecture, added with files only: P-Net
(dilated convs, no encoder or decoder), its plain reference and work
counts as ``configs/pnet.py`` (``files/pnet.py``), its sizes as
``configs/pnet.json``, a cell of it under pCE in ``BENCHMARK.json`` and a
limits file. The harness runs it, unedited, to a correct result on the
CPU, and its per-layer readers count the work from the new module."""

import json
import os
import shutil
import time

import pytest

from conftest import BENCH, ROOT
import run
from harness import spec

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "pnet.pce_b4"


@pytest.fixture
def checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = root / "benchmark" / "configs"
    shutil.copy(os.path.join(HERE, "files", "pnet.py"), configs / "pnet.py")
    (configs / "pnet.json").write_text(json.dumps({
        "model": "pnet", "in_chns": 1, "class_num": 4, "num_filters": 64,
        "patch_size": [32, 32]}))
    traffic = json.loads((root / "benchmark/traffic/pce_b24.json")
                         .read_text())
    traffic.update(batch=4, compute_dtype="float32", steps_per_call=2,
                   datasets=[{"slices": 16, "labels": "scribble"}])
    (root / "benchmark/traffic/pce_b4.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/unet.pce_b24.json",
                root / f"benchmark/limits/{CELL}.json")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "pnet", "source": "test",
                         "file": "benchmark/configs/pnet.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": CELL, "config": "pnet",
                           "traffic": "pce_b4", "chips": 1, "why": "test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "unet.pce_b24" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return str(root)


def test_a_configuration_of_another_architecture_runs_correct(checkout):
    cell = spec.find_cell(CELL, checkout)
    res = run.execute(cell, 2 ** 31 + 77, 0.5, 0, time.time(), "cpu",
                      root=checkout)
    assert res.correct, res.checks
    assert res.numbers["loss"] < 1e-5 and res.numbers["grad"] < 1e-3
    net = cell.reference_model()
    per_step = 4 * (net.forward_flops(cell.config)
                    + net.backward_flops(cell.config))
    assert res.context["work"] == per_step
    mfu = cell.metric_reader("mfu.train").read(res.context)
    assert mfu == pytest.approx(100.0 * per_step * res.context["units"]
                                / res.context["window_s"] / 67e12)


def test_the_drivers_read_no_size_of_a_configuration():
    # the sizes are the configuration module's to read (patch_size aside)
    for name in ("train.py", "infer.py", "spec.py", "check.py",
                 "readers.py", "trace.py", "inputs.py"):
        with open(os.path.join(BENCH, "harness", name)) as f:
            text = f.read()
        for key in ("feature_chns", "decoders", "in_chns", "dropout"):
            assert f'"{key}"' not in text, (name, key)


@pytest.mark.parametrize("method,own_build", [("pce", False), ("s2l", True)])
def test_the_bundle_is_the_methods_own(method, own_build, tmp_path):
    # a method with its own make_bundle brings its host hook and variant
    # (s2l's refresh and gate); the others get their build's parts
    import numpy as np

    from harness.train import program_bundle
    from wsl4mis_torch.data.synthetic import ArraySliceDataset
    from wsl4mis_torch.engine.config import TrainConfig

    cfg = TrainConfig(method=method, sup_type="scribble", batch_size=2,
                      patch_size=(16, 16), device="cpu",
                      compute_dtype="float32",
                      snapshot_root=str(tmp_path))
    data = ArraySliceDataset(np.zeros((6, 16, 16), np.float32),
                             np.zeros((6, 16, 16), np.int32))
    bundle = program_bundle(cfg, [data], "unet")
    assert (bundle.host_hook is not None) == own_build
    assert (bundle.variant is not None) == own_build
    assert tuple(bundle.aux["images"].shape) == (6, 16, 16)
    assert set(next(bundle.data_iter)) == {"index"}
