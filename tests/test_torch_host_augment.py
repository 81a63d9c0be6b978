"""The port's host augmentation (aug_mode="host") against the JAX
package's (on the CPU): HostRandomGenerator sample by sample, bit for bit,
on native-size slices with scribbles (fill 4) and with dense labels; the
batch stream over a synthetic ACDC H5 tree; and one step of each method
that takes host batches, built by build(cfg), with no on-device augment
call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from wsl4mis_tpu.data.acdc import AcdcSliceDataset as JaxSlices  # noqa: E402
from wsl4mis_tpu.data.augment import (  # noqa: E402
    HostRandomGenerator as JaxGenerator,
)
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods.common import (  # noqa: E402
    _host_augmented_iterator as jax_host_iterator,
)
from wsl4mis_torch.data import augment_device  # noqa: E402
from wsl4mis_torch.data.acdc import (  # noqa: E402
    AcdcSliceDataset,
    _nearest_zoom2d,
)
from wsl4mis_torch.data.augment import HostRandomGenerator  # noqa: E402
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import (  # noqa: E402
    _host_augmented_iterator,
    split_rngs,
)

NATIVE = (212, 232)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sup_type", ["scribble", "label"])
def test_generator_matches_the_jax_package(sup_type):
    """200 samples (40 native 212x232 slices, five times over) from one
    seed: every image and label bit-equal, augmented and identity samples
    both drawn, and the scribbles' rotations filled with 4."""
    data = synthetic_slices(40, NATIVE, seed=1, sup_type=sup_type)
    ours, theirs = HostRandomGenerator(seed=11), JaxGenerator(seed=11)
    changed = filled = 0
    for i in range(200):
        sample = {"image": data.images[i % 40], "label": data.labels[i % 40]}
        got, want = ours(dict(sample)), theirs(dict(sample))
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
        assert got["image"].dtype == np.float32
        assert got["label"].dtype == np.int32
        assert got["image"].shape == (256, 256)
        changed += int(not np.array_equal(
            got["image"], _nearest_zoom2d(sample["image"], (256, 256))))
        filled += int(got["label"][0, 0] == 4)
    assert 0 < changed < 200
    assert (filled > 0) == (sup_type == "scribble")


@pytest.fixture(scope="module")
def acdc_tree(tmp_path_factory):
    """fold1: 12 train slices of patients 21-22 at 40x48 (labels and
    scribbles), val volumes of patients 1-2."""
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
        with h5py.File(root / "ACDC_training_volumes"
                       / f"patient{p:03d}_frame01.h5", "w") as f:
            f["image"] = data.images[3 * p:3 * p + 3]
            f["label"] = data.labels[3 * p:3 * p + 3].astype(np.uint8)
    return str(root)


def _first_batches(acdc_tree, sup_type, n):
    """The first n host batches of both packages over the tree (64x64
    patches, batch 4, seed 3)."""
    kw = dict(root_path=acdc_tree, sup_type=sup_type, patch_size=(64, 64),
              batch_size=4, seed=3, aug_mode="host")
    port = AcdcSliceDataset(base_dir=acdc_tree, sup_type=sup_type,
                            patch_size=(64, 64), keep_native=True)
    ref = JaxSlices(base_dir=acdc_tree, sup_type=sup_type,
                    patch_size=(64, 64), keep_native=True)
    ours = _host_augmented_iterator(TrainConfig(**kw), port)
    theirs = jax_host_iterator(JaxConfig(**kw), ref)
    return [(next(ours), next(theirs)) for _ in range(n)]


@pytest.mark.parametrize("sup_type", ["scribble", "label"])
def test_batch_stream_matches_the_jax_package(acdc_tree, sup_type):
    """keep_native slices and the first three host batches."""
    port = AcdcSliceDataset(base_dir=acdc_tree, sup_type=sup_type,
                            patch_size=(64, 64), keep_native=True)
    assert [a.shape for a in port.native_images] == [(40, 48)] * 12
    assert AcdcSliceDataset(base_dir=acdc_tree).native_images is None
    for got, want in _first_batches(acdc_tree, sup_type, 3):
        assert sorted(got) == ["image", "label"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].shape == (4, 64, 64)


@pytest.mark.parametrize("method,sup_type", [
    ("fully_supervised", "label"), ("pce", "scribble"),
    ("dmpls", "scribble"), ("pce_tv", "scribble"), ("ustm", "scribble")])
def test_build_with_host_augmentation_runs_a_step(acdc_tree, monkeypatch,
                                                  method, sup_type):
    """build(cfg) with aug_mode "host": the bundle's first batch is the
    JAX package's first host batch, as tensors; one step takes it as it
    comes (no on-device augment call) to a finite loss."""
    calls = []
    augment = augment_device._augment.augment_batch
    monkeypatch.setattr(augment_device._augment, "augment_batch",
                        lambda *a: calls.append(1) or augment(*a))
    cfg = TrainConfig(method=method, device="cpu", root_path=acdc_tree,
                      sup_type=sup_type, patch_size=(64, 64), batch_size=4,
                      seed=3, aug_mode="host", compute_dtype="float32",
                      model="unet_cct" if method == "dmpls" else "unet")
    bundle = get_method(method).build(cfg)
    batch = next(bundle.data_iter)
    (_, want), = _first_batches(acdc_tree, sup_type, 1)
    for k in ("image", "label"):
        assert isinstance(batch[k], torch.Tensor)
        np.testing.assert_array_equal(batch[k].numpy(), want[k])
    metrics = bundle.step_fn(bundle.state, batch, split_rngs(3, 0, "cpu"),
                             bundle.aux)
    assert np.isfinite(float(metrics["total_loss"]))
    assert bundle.state.step == 1 and not calls
