"""The port's offline test path against the JAX package's (on the CPU,
f32): ASD and the (dice, hd95, asd) metric at anisotropic spacing, NIfTI
files across the two packages' readers and writers, inference checkpoints
the JAX package writes (flax msgpack) loaded into the port's models, the
port's own inference checkpoints, and inference_fold from one JAX
checkpoint over a synthetic fold in both packages (a narrow UNet; the
reference's 256x256 inference size)."""

import functools
import gzip
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

import wsl4mis_tpu.eval.infer as jinfer  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.data import nifti as jnifti  # noqa: E402
from wsl4mis_tpu.eval import metrics as jmetrics  # noqa: E402
from wsl4mis_tpu.utils.checkpoint import (  # noqa: E402
    save_model_checkpoint as jax_save_model_checkpoint,
)
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.data import nifti as tnifti  # noqa: E402
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.eval import infer as tinfer  # noqa: E402
from wsl4mis_torch.eval import metrics as tmetrics  # noqa: E402
from wsl4mis_torch.eval.val2d import _zoom_index, _zoom_stack  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.checkpoint import (  # noqa: E402
    load_jax_checkpoint,
    load_model_checkpoint,
    save_model_checkpoint,
)

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
SPACING = (1.25, 1.6, 10.0)  # (sx, sy, sz): sx != sy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _masks(seed, shape=(6, 30, 34)):
    rs = np.random.RandomState(seed)
    pred = np.zeros(shape, bool)
    gt = np.zeros(shape, bool)
    pred[1:5, 4:20, 6:25] = True
    gt[2:6, 8:26, 3:22] = True
    return pred ^ (rs.rand(*shape) > 0.93), gt ^ (rs.rand(*shape) > 0.95)


@pytest.mark.parametrize("seed", range(4))
def test_asd_and_spacing_metric_match_the_jax_package(seed):
    pred, gt = _masks(seed)
    spacing = (SPACING[2], SPACING[0], SPACING[1])  # (sz, sx, sy)
    assert abs(tmetrics.asd(pred, gt, spacing)
               - jmetrics.asd(pred, gt, spacing)) <= 1e-12
    got = tmetrics.calculate_metric_percase_spacing(pred, gt, spacing)
    want = jmetrics.calculate_metric_percase_spacing(pred, gt, spacing)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the metric reads the spacing per axis
    swapped = (SPACING[2], SPACING[1], SPACING[0])
    assert tmetrics.asd(pred, gt, swapped) != tmetrics.asd(pred, gt, spacing)


def test_spacing_metric_is_zero_on_an_empty_mask():
    pred, gt = _masks(0)
    empty = np.zeros_like(pred)
    for a, b in ((pred, empty), (empty, gt), (empty, empty)):
        assert tmetrics.calculate_metric_percase_spacing(a, b, SPACING) == \
            (0.0, 0.0, 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_nifti_files_cross_between_the_packages(tmp_path, dtype):
    """A file one package writes reads back in the other, array and
    spacing equal; the two writers' decompressed bytes are equal (gzip
    stamps a time in its header)."""
    arr = (np.random.RandomState(3).rand(5, 7, 9) * 100).astype(dtype)
    ours, theirs = tmp_path / "port.nii.gz", tmp_path / "jax.nii.gz"
    tnifti.write_nifti(str(ours), arr, SPACING)
    jnifti.write_nifti(str(theirs), arr, SPACING)
    for path, reader in ((ours, jnifti.read_nifti),
                         (theirs, tnifti.read_nifti)):
        img = reader(str(path))
        np.testing.assert_array_equal(img.array_zyx, arr)
        assert img.array_zyx.dtype == arr.dtype
        assert img.spacing == tuple(float(np.float32(s)) for s in SPACING)
    assert tnifti.read_spacing(str(theirs)) == jnifti.read_spacing(str(ours))
    with gzip.open(ours) as a, gzip.open(theirs) as b:
        assert a.read() == b.read()


def _jax_model(name, seed=0):
    cls = {"unet": junet.UNet, "unet_cct": junet.UNetCCT}[name]
    model = cls(features=FEATURES, dropout=NO_DROPOUT, dtype=jnp.float32)
    key = jax.random.key(seed)
    variables = model.init({"params": key, "dropout": key,
                            "feature_perturb": key},
                           jnp.zeros((1, 32, 32, 1)), train=False)
    rs = np.random.RandomState(seed + 1)
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + rs.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return model, variables


def _port_model(name):
    return net_factory(name, 4, dtype=torch.float32, features=FEATURES,
                       dropout=NO_DROPOUT)


def _jax_state(variables, step=7, extra=None):
    return types.SimpleNamespace(params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 step=jnp.asarray(step), extra=extra or {})


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


@pytest.mark.parametrize("name", ["unet", "unet_cct"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, name):
    """save_model_checkpoint of the JAX package, loaded by the port: the
    step, and eval logits (every head) within 1e-5 of the largest."""
    model, variables = _jax_model(name)
    path = str(tmp_path / "iter_7.pth")
    jax_save_model_checkpoint(path, _jax_state(variables))
    port = _port_model(name)
    assert load_model_checkpoint(path, port) == 7
    x = np.random.RandomState(2).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=False)
    pairs = list(zip(got, want)) if name == "unet_cct" else [(got, want)]
    for g, w in pairs:
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_jax_checkpoint_carries_class_memory_and_bf16(tmp_path):
    """A top-level class_memory collection (ScribbleVC's) lands in the
    state_extra tensors in place; a bfloat16 leaf widens exactly."""
    _, variables = _jax_model("unet")
    memory = {"rep_1": np.arange(6, dtype=np.float32).reshape(2, 3),
              "initialized": np.ones((1,), np.float32)}
    path = str(tmp_path / "unet_best_model.pth")
    jax_save_model_checkpoint(path, _jax_state(
        variables, extra={"class_memory": memory}))
    dst = {k: torch.zeros(v.shape) for k, v in memory.items()}
    load_model_checkpoint(path, _port_model("unet"), {"class_memory": dst})
    for k, v in memory.items():
        np.testing.assert_array_equal(dst[k].numpy(), v)
    x = jnp.asarray(np.random.RandomState(4).standard_normal((3, 5)),
                    jnp.bfloat16)
    bf16 = tmp_path / "bf16.msgpack"
    bf16.write_bytes(serialization.to_bytes({"x": x, "s": np.float32(2.5)}))
    tree = load_jax_checkpoint(str(bf16))
    np.testing.assert_array_equal(tree["x"], np.asarray(x, np.float32))
    assert tree["s"] == 2.5


def test_port_checkpoint_round_trips(tmp_path):
    model = _port_model("unet")
    memory = {"rep": torch.arange(4.0)}
    state = TrainState(model=model, opt=ReferenceSGD(model.parameters(),
                                                     0.01, 10),
                       step=5, extra={"class_memory": memory})
    path = str(tmp_path / "iter_5.pth")
    save_model_checkpoint(path, state, eval_extra=("class_memory",))
    fresh = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        generator=torch.Generator().manual_seed(9))
    dst = {"rep": torch.zeros(4)}
    assert load_model_checkpoint(path, fresh, {"class_memory": dst}) == 5
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(dst["rep"], memory["rep"], rtol=0, atol=0)


def test_a_missing_entry_raises(tmp_path):
    """A parameter missing from either format, or an eval extra the file
    lacks, fails the load."""
    _, variables = _jax_model("unet")
    del variables["params"]["Decoder_0"]
    path = str(tmp_path / "jax.pth")
    jax_save_model_checkpoint(path, _jax_state(variables))
    with pytest.raises(RuntimeError):
        load_model_checkpoint(path, _port_model("unet"))
    model = _port_model("unet")
    state = TrainState(model=model, opt=None, step=1)
    path = str(tmp_path / "port.pth")
    save_model_checkpoint(path, state)
    payload = torch.load(path, weights_only=True)
    del payload["model"][next(iter(payload["model"]))]
    torch.save(payload, path)
    with pytest.raises(RuntimeError):
        load_model_checkpoint(path, _port_model("unet"))
    save_model_checkpoint(path, state)
    with pytest.raises(KeyError):
        load_model_checkpoint(path, _port_model("unet"),
                              {"class_memory": {"rep": torch.zeros(1)}})


def _fold(tmp_path):
    """fold1's val volumes of patients 1-2 (3x40x48), their raw NIfTI at
    SPACING, and a JAX UNet checkpoint saved as unet_best_model.pth (the
    test's iter_60000.pth is absent: both packages fall back)."""
    root = tmp_path / "acdc"
    (root / "ACDC_training_volumes").mkdir(parents=True)
    raw = tmp_path / "raw"
    raw.mkdir()
    data = synthetic_slices(6, (40, 48), seed=7)
    for p in (1, 2):
        case = f"patient{p:03d}_frame01"
        with h5py.File(root / "ACDC_training_volumes" / f"{case}.h5",
                       "w") as f:
            f["image"] = data.images[3 * p - 3:3 * p]
            f["label"] = data.labels[3 * p - 3:3 * p].astype(np.uint8)
        jnifti.write_nifti(str(raw / f"{case}.nii.gz"),
                           data.images[3 * p - 3:3 * p], SPACING)
    model, variables = _jax_model("unet", seed=3)
    snap = tmp_path / "model"
    jax_save_model_checkpoint(
        str(snap / "ACDC_fold1" / "scribble" / "unet_best_model.pth"),
        _jax_state(variables))
    return str(root), str(raw), str(snap), model, variables


def _jax_gap(model, variables, image):
    """JAX's top-two logit gap at each native voxel of a volume, through
    the predictor's zoom to 256x256 and back."""
    d, h, w = image.shape
    zoomed = _zoom_stack(image, (256, 256))[..., None]
    logits = np.asarray(model.apply(variables, jnp.asarray(zoomed),
                                    train=False))
    top = np.sort(logits, axis=-1)
    gap = top[..., -1] - top[..., -2]
    return gap[:, _zoom_index(h, 256)[:, None], _zoom_index(w, 256)[None, :]]


def test_inference_fold_matches_the_jax_package(tmp_path, monkeypatch):
    """inference_fold of both packages from one JAX checkpoint over a
    synthetic fold (f32, data_limit 2, raw NIfTI at sx != sy): equal
    predictions except where JAX's top-two logit gap is under 1e-4 (few
    voxels at most), and equal (3, 3) [dice, hd95, asd] to 1e-6 for every
    class whose masks agree; then the test command over the same files,
    whose NIfTI files read back in JAX with the spacing written."""
    root, raw, snap, model, variables = _fold(tmp_path)
    monkeypatch.setattr(jinfer, "net_factory",
                        lambda name, classes, dtype: junet.UNet(
                            features=FEATURES, dropout=NO_DROPOUT,
                            dtype=dtype))
    narrow = functools.partial(net_factory, features=FEATURES,
                               dropout=NO_DROPOUT)
    monkeypatch.setattr(tinfer, "net_factory", narrow)
    kw = dict(root_path=root, exp="ACDC", model="unet", sup_type="scribble",
              snapshot_root=snap, raw_data_path=raw, compute_dtype="float32",
              data_limit=2)
    want = jinfer.inference_fold(jinfer.InferenceConfig(**kw), "fold1")
    pred_dir = os.path.join(snap, "ACDC_fold1", "scribble",
                            "unet_predictions")
    cases = [f"patient{p:03d}_frame01" for p in (1, 2)]

    def preds():
        return [jnifti.read_nifti(os.path.join(pred_dir, f"{c}_pred.nii.gz"))
                for c in cases]

    jax_preds = preds()
    got = tinfer.inference_fold(
        tinfer.InferenceConfig(device="cpu", **kw), "fold1")
    port_preds = preds()
    assert got.shape == want.shape == (3, 3)
    mismatched, agree = 0, np.ones(3, bool)
    for case, jp, tp in zip(cases, jax_preds, port_preds):
        assert tp.spacing == jp.spacing == tuple(
            float(np.float32(s)) for s in SPACING)
        with h5py.File(os.path.join(root, "ACDC_training_volumes",
                                    f"{case}.h5")) as f:
            image = f["image"][:]
        diff = jp.array_zyx != tp.array_zyx
        assert (_jax_gap(model, variables, image)[diff] < 1e-4).all()
        mismatched += int(diff.sum())
        for c in range(1, 4):
            agree[c - 1] &= np.array_equal(jp.array_zyx == c,
                                           tp.array_zyx == c)
    assert mismatched <= 10
    assert agree.any()
    np.testing.assert_allclose(got[agree], want[agree], rtol=0, atol=1e-6)
    mean_dice = cli.test_main([
        "--root_path", root, "--exp", "ACDC", "--fold", "fold1",
        "--snapshot_root", snap, "--raw_data_path", raw,
        "--compute_dtype", "float32", "--data_limit", "2", "--device", "cpu"])
    assert abs(mean_dice - got.mean(axis=0)[0]) <= 1e-12
    for jp, tp in zip(port_preds, preds()):
        np.testing.assert_array_equal(tp.array_zyx, jp.array_zyx)
