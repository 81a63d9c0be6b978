"""The port's random walker (data/random_walker.py) and pce_random_walker
against the JAX package, on the CPU.

Both packages run the same numpy and scipy code, so the labels must agree
bit for bit: random_walker itself and the ACDC and prostate pseudo-label
generators on seeded 32x32 phantoms, and AcdcSliceDataset(sup_type=
"random_walker") on an H5 tree without a random_walker key, which makes
the labels from each slice's scribble (rw_mode "acdc" or "prostate").
pce_random_walker is fully_supervised's step on those labels; its build()
on the tree runs two steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from wsl4mis_tpu.data import random_walker as jrw  # noqa: E402
from wsl4mis_tpu.data.acdc import AcdcSliceDataset as JaxSlices  # noqa: E402
from wsl4mis_torch.data import random_walker as trw  # noqa: E402
from wsl4mis_torch.data import synthetic_slices  # noqa: E402
from wsl4mis_torch.data.acdc import AcdcSliceDataset  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402


def _scribbled(n, hw, seed):
    """Phantom images and scribbles: the dense label kept on ~15% of the
    pixels, class 4 elsewhere."""
    data = synthetic_slices(n, hw, seed=seed)
    keep = np.random.RandomState(seed).rand(*data.labels.shape) < 0.15
    return data.images, np.where(keep, data.labels, 4).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_walker_matches_bit_for_bit(seed):
    images, scribbles = _scribbled(1, (32, 32), seed)
    markers = np.where(scribbles[0] == 4, 0, scribbles[0] + 1)
    got = trw.random_walker(images[0], markers, beta=100.0)
    want = jrw.random_walker(images[0], markers, beta=100.0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(np.unique(markers[markers > 0]))


@pytest.mark.parametrize("name", ["pseudo_label_generator_acdc",
                                  "pseudo_label_generator_prostate"])
def test_generators_match_bit_for_bit(name):
    images, scribbles = _scribbled(4, (32, 32), seed=3)
    # a slice whose scribble lacks class 1: both generators give zeros
    scribbles[3][scribbles[3] == 1] = 4
    for img, scr in zip(images, scribbles):
        got = getattr(trw, name)(img, scr)
        want = getattr(jrw, name)(img, scr)
        assert got.dtype == want.dtype == scr.dtype
        np.testing.assert_array_equal(got, want)
    assert not getattr(trw, name)(images[3], scribbles[3]).any()
    assert set(np.unique(trw.pseudo_label_generator_acdc(
        images[0], scribbles[0]))) == {0, 1, 2, 3}


@pytest.fixture(scope="module")
def rw_tree(tmp_path_factory):
    """fold1 layout without random_walker keys: 8 train slices of patient
    21 (40x48; label and scribble), val volumes of patients 1-2."""
    root = tmp_path_factory.mktemp("acdc_rw")
    (root / "ACDC_training_slices").mkdir()
    (root / "ACDC_training_volumes").mkdir()
    data = synthetic_slices(8, (40, 48), seed=6)
    _, scribbles = _scribbled(8, (40, 48), seed=6)
    for i in range(8):
        with h5py.File(root / "ACDC_training_slices"
                       / f"patient021_frame01_slice_{i}.h5", "w") as f:
            f["image"] = data.images[i]
            f["label"] = data.labels[i].astype(np.uint8)
            f["scribble"] = scribbles[i].astype(np.uint8)
    for p in (1, 2):
        sl = slice(3 * p - 3, 3 * p)
        with h5py.File(root / "ACDC_training_volumes"
                       / f"patient{p:03d}_frame01.h5", "w") as f:
            f["image"] = data.images[sl]
            f["label"] = data.labels[sl].astype(np.uint8)
    return str(root)


@pytest.mark.parametrize("rw_mode", ["acdc", "prostate"])
def test_on_the_fly_labels_match_the_jax_dataset(rw_tree, rw_mode):
    ours = AcdcSliceDataset(base_dir=rw_tree, sup_type="random_walker",
                            patch_size=(32, 32), rw_mode=rw_mode)
    theirs = JaxSlices(base_dir=rw_tree, sup_type="random_walker",
                       patch_size=(32, 32), rw_mode=rw_mode)
    assert len(ours) == 8 and ours.slice_names == theirs.slice_names
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    np.testing.assert_array_equal(ours.images, theirs.images)
    assert ours.labels.dtype == np.int32
    assert (ours.labels != 4).all() and ours.labels.any()


def test_other_missing_keys_still_raise(rw_tree):
    with pytest.raises(KeyError, match="no 'pseudo' key"):
        AcdcSliceDataset(base_dir=rw_tree, sup_type="pseudo",
                         patch_size=(32, 32))


def test_pce_random_walker_builds_and_steps(rw_tree):
    """get_method("pce_random_walker").build(cfg): fully_supervised's
    bundle staged on the random-walker labels; two CPU steps."""
    cfg = TrainConfig(method="pce_random_walker", device="cpu",
                      root_path=rw_tree, sup_type="random_walker",
                      patch_size=(32, 32), batch_size=4, base_lr=0.01,
                      compute_dtype="float32", seed=3)
    bundle = get_method("pce_random_walker").build(cfg)
    want = JaxSlices(base_dir=rw_tree, sup_type="random_walker",
                     patch_size=(32, 32))
    np.testing.assert_array_equal(bundle.aux["labels"].numpy(), want.labels)
    assert bundle.steps_per_epoch == 2
    for t in range(2):
        metrics = bundle.step_fn(bundle.state, next(bundle.data_iter),
                                 split_rngs(cfg.seed, t, "cpu"), bundle.aux)
        assert all(np.isfinite(float(v)) for k, v in metrics.items()
                   if k != "vis")
    assert bundle.state.step == 2
