"""The port's data, validation and Trainer on a tiny synthetic ACDC H5
tree (on the CPU): the normal entry points get_method(name).build(cfg)
and Trainer(cfg, bundle).train() run 4 steps, validate, write the
reference-named checkpoints and resume. Also: the port's copies of the
ACDC readers and metrics agree with the JAX package's, and importing the
port pulls in neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from wsl4mis_tpu.data.acdc import (  # noqa: E402
    AcdcSliceDataset as JaxSlices,
    AcdcVolumeDataset as JaxVolumes,
)
from wsl4mis_tpu.eval import metrics as jmetrics  # noqa: E402
from wsl4mis_torch.data.acdc import (  # noqa: E402
    AcdcSliceDataset,
    AcdcVolumeDataset,
)
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.eval import metrics as tmetrics  # noqa: E402
from wsl4mis_torch.eval.val2d import VolumePredictor  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def acdc_tree(tmp_path_factory):
    """fold1 layout: train slices of patients 21-22 (40x48, scribbles),
    val volumes of patients 1-2 (3x40x48)."""
    root = tmp_path_factory.mktemp("acdc")
    (root / "ACDC_training_slices").mkdir()
    (root / "ACDC_training_volumes").mkdir()
    data = synthetic_slices(12, (40, 48), seed=5)
    scrib = synthetic_slices(12, (40, 48), seed=5, sup_type="scribble")
    for i in range(12):
        name = f"patient{21 + i // 6:03d}_frame01_slice_{i % 6}.h5"
        with h5py.File(root / "ACDC_training_slices" / name, "w") as f:
            f["image"] = data.images[i]
            f["label"] = data.labels[i].astype(np.uint8)
            f["scribble"] = scrib.labels[i].astype(np.uint8)
    for p in (1, 2):
        sl = slice(3 * p, 3 * p + 3)
        with h5py.File(root / "ACDC_training_volumes"
                       / f"patient{p:03d}_frame01.h5", "w") as f:
            f["image"] = data.images[sl]
            f["label"] = data.labels[sl].astype(np.uint8)
    return str(root)


def test_readers_match_the_jax_package(acdc_tree):
    for sup in ("label", "scribble"):
        a = AcdcSliceDataset(base_dir=acdc_tree, sup_type=sup,
                             patch_size=(32, 32))
        b = JaxSlices(base_dir=acdc_tree, sup_type=sup, patch_size=(32, 32))
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.slice_names == b.slice_names
    va, vb = AcdcVolumeDataset(base_dir=acdc_tree), JaxVolumes(
        base_dir=acdc_tree)
    assert va.cases == vb.cases
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(x["image"], y["image"])


def test_metrics_match_the_jax_package():
    rs = np.random.RandomState(0)
    for _ in range(5):
        pred = rs.rand(4, 20, 24) > 0.6
        gt = rs.rand(4, 20, 24) > 0.5
        assert tmetrics.calculate_metric_percase(pred, gt) == \
            jmetrics.calculate_metric_percase(pred, gt)
    assert tmetrics.calculate_metric_percase(pred, gt * 0) == (0.0, 0.0)


def _cfg(acdc_tree, snap, **kw):
    base = dict(method="fully_supervised", device="cpu", root_path=acdc_tree,
                patch_size=(32, 32), batch_size=2, max_iterations=4,
                val_every=4, ckpt_every=2, compute_dtype="float32",
                snapshot_root=str(snap), log_every=2, seed=3)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("method,sup", [("fully_supervised", "label"),
                                        ("dmpls", "scribble"),
                                        ("pce_gatedcrf", "scribble"),
                                        ("pce_intensity_variance",
                                         "scribble")])
def test_trainer_runs_validates_checkpoints_and_resumes(acdc_tree, tmp_path,
                                                        method, sup):
    cfg = _cfg(acdc_tree, tmp_path, method=method, sup_type=sup)
    bundle = get_method(method).build(cfg)
    assert bundle.aux["images"].shape == (12, 32, 32)
    assert bundle.steps_per_epoch == 6
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    assert trainer.train() == "Training Finished!"
    snap = cfg.snapshot_path
    for name in ("iter_2.pth", "iter_4.pth", "latest_full.ckpt", "log.txt"):
        assert os.path.isfile(os.path.join(snap, name)), name
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "iteration 4 : mean_dice" in log
    assert bundle.state.step == 4
    saved = torch.load(os.path.join(snap, "iter_4.pth"), weights_only=True)
    assert saved["step"] == 4
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(saved["model"][k], v, rtol=0, atol=0)

    # resume from latest_full.ckpt and train 2 more steps
    cfg2 = cfg.replace(max_iterations=6, resume=True)
    bundle2 = get_method(method).build(cfg2)
    trainer2 = Trainer(cfg2, bundle2, use_tensorboard=False)
    assert bundle2.state.step == 4 and bundle2.state.opt.count == 4
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(bundle2.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    trainer2.train()
    assert bundle2.state.step == 6
    assert os.path.isfile(os.path.join(snap, "iter_6.pth"))


def test_trainer_rejects_a_width_its_process_group_does_not_have(acdc_tree,
                                                                  tmp_path):
    """TrainConfig.num_devices is the data-parallel width: a Trainer built
    in one process with no group refuses any width but 1 (the ranks come
    from parallel.spawn) and writes nothing."""
    cfg = _cfg(acdc_tree, tmp_path, batch_size=4)
    bundle = get_method(cfg.method).build(cfg)
    for n in (2, 4):
        with pytest.raises(ValueError, match=f"num_devices {n} but this "
                                             f"process is rank 0 of 1"):
            Trainer(cfg.replace(num_devices=n), bundle,
                    use_tensorboard=False)
    assert not os.path.exists(cfg.snapshot_path)
    trainer = Trainer(cfg.replace(num_devices=1), bundle,
                      use_tensorboard=False)
    assert trainer.mesh.world_size == 1 and trainer.lead


def test_predictor_batched_equals_per_volume(acdc_tree):
    cfg = _cfg(acdc_tree, "unused")
    bundle = get_method("fully_supervised").build(cfg)
    pred = VolumePredictor(bundle.model, (32, 32), device="cpu", chunk=4)
    vols = list(bundle.val_volumes)
    batched = pred.predict_volumes([v["image"] for v in vols])
    for v, p in zip(vols, batched):
        assert p.shape == v["image"].shape and p.dtype == np.int32
        np.testing.assert_array_equal(p, pred.predict_volume(v["image"]))


@pytest.mark.parametrize("build,name", [(net_factory, "pnet"),
                                        (net_factory, "unet_cct_3h"),
                                        (net_factory, "unet_ds")])
def test_unported_names_name_their_roadmap_item(build, name):
    """These names raised NotImplementedError citing their ROADMAP item
    until the zoo was ported (ROADMAP Queue 1, item 14, done): they now
    build, with the JAX factory's number of outputs."""
    from wsl4mis_torch.models import MODEL_NUM_OUTPUTS

    model = build(name, 4, dtype=torch.float32)
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 1), train=False)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == MODEL_NUM_OUTPUTS[name]


def test_port_imports_no_jax():
    """Importing every module of the package (walked, so that new modules
    are covered) and chip_smoke pulls in none of them, nor h5py or msgpack
    (imported where a file is read)."""
    code = (
        "import importlib, pkgutil, sys, wsl4mis_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "wsl4mis_torch.__path__, 'wsl4mis_torch.')]\n"
        "assert len(names) > 30 and 'wsl4mis_torch.ops.gated_crf' in names\n"
        "assert 'wsl4mis_torch.parallel.mesh' in names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'wsl4mis_tpu', 'h5py', "
        "'msgpack'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # no import of them anywhere in the package's sources (the notes that
    # name a replaced TPU kernel's file are prose, not imports)
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                        r"wsl4mis_tpu)\b|import_module\(\s*['\"]"
                        r"(jax|flax|optax|wsl4mis_tpu)", re.M)
    pkg = os.path.join(REPO, "wsl4mis_torch")
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname)) as f:
                    assert not banned.search(f.read()), fname
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not banned.search(f.read())
