"""The port's offline data tools against the JAX package's, on the same
numpy inputs and seeds, bit for bit (host numpy and scipy on both sides):
ACDC preprocessing (``convert_acdc`` on a two-case NIfTI tree, compared
file by file), scribble simulation, CTAugment and the weak/strong
transforms, and seg_utils. The inputs follow tests/test_data_tools.py,
tests/test_weak_strong.py and tests/test_misc_components.py."""

import os
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import wsl4mis_tpu.data.preprocess as jpre  # noqa: E402
import wsl4mis_tpu.data.scribble_sim as jsim  # noqa: E402
import wsl4mis_tpu.data.weak_strong as jws  # noqa: E402
import wsl4mis_tpu.utils.seg_utils as jseg  # noqa: E402
import wsl4mis_torch.data.preprocess as tpre  # noqa: E402
import wsl4mis_torch.data.scribble_sim as tsim  # noqa: E402
import wsl4mis_torch.data.weak_strong as tws  # noqa: E402
import wsl4mis_torch.utils.seg_utils as tseg  # noqa: E402
from wsl4mis_torch.data.nifti import write_nifti  # noqa: E402


def _equal(a, b):
    """Bit-equal arrays (dtype and shape too), or equal Python values."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8) if a.dtype.kind == "f"
                                      else a, b.view(np.uint8)
                                      if b.dtype.kind == "f" else b)
    else:
        assert a == b


def _heart(d=3, h=40, w=48, seed=0):
    """A (D, H, W) label volume of nested blobs (classes 0-3) and an image
    over it with a few bright outliers (the percentile clip's case)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    label = np.zeros((d, h, w), np.uint8)
    for z in range(d):
        cy, cx = h / 2 + rs.randint(-3, 4), w / 2 + rs.randint(-3, 4)
        r = np.hypot(yy - cy, xx - cx)
        label[z][r < 16 - z] = 1
        label[z][r < 11 - z] = 2
        label[z][r < 6] = 3
    image = label * 40.0 + rs.standard_normal(label.shape) * 5 + 100
    image.flat[rs.choice(image.size, 6, replace=False)] = 5000.0
    return image.astype(np.float32), label


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """Two ACDC cases as NIfTI ({case}.nii.gz, _gt, _scribble)."""
    root = tmp_path_factory.mktemp("acdc_raw")
    for i, case in enumerate(("patient001_frame01", "patient002_frame12")):
        image, label = _heart(3 + i, seed=i)
        scribble = np.where(jsim.generate_scribble(label, (1, 2), seed=i) >
                            0, label, 4).astype(np.uint8)
        spacing = (1.5, 1.5, 10.0)
        write_nifti(str(root / f"{case}.nii.gz"), image, spacing)
        write_nifti(str(root / f"{case}_gt.nii.gz"), label, spacing)
        write_nifti(str(root / f"{case}_scribble.nii.gz"), scribble, spacing)
    return str(root)


def _h5_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            with h5py.File(path, "r") as f:
                out[os.path.relpath(path, root)] = {
                    k: (f[k][()], f[k].compression) for k in f}
    return out


def test_convert_acdc_writes_the_jax_packages_files(raw_tree, tmp_path):
    n_t = tpre.convert_acdc(raw_tree, str(tmp_path / "port"))
    n_j = jpre.convert_acdc(raw_tree, str(tmp_path / "jax"))
    assert n_t == n_j == 3 + 4
    mine, theirs = _h5_tree(tmp_path / "port"), _h5_tree(tmp_path / "jax")
    assert sorted(mine) == sorted(theirs) and len(mine) == 7 + 2
    for name, keys in theirs.items():
        assert sorted(mine[name]) == sorted(keys) == ["image", "label",
                                                      "scribble"], name
        for k, (arr, compression) in keys.items():
            _equal(mine[name][k][0], arr)
            assert mine[name][k][1] == compression == "gzip"
    # limit keeps the first cases
    assert tpre.convert_acdc(raw_tree, str(tmp_path / "one"), limit=1) == 3


def test_convert_acdc_without_h5py_names_it(raw_tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tpre.convert_acdc(raw_tree, str(tmp_path / "out"))


def test_process_case_matches(raw_tree):
    paths = [os.path.join(raw_tree, f"patient002_frame12{s}.nii.gz")
             for s in ("", "_gt", "_scribble")]
    for a, b in zip(tpre.process_case(*paths), jpre.process_case(*paths)):
        _equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_clip_and_normalize_match(seed):
    rs = np.random.RandomState(seed)
    img = rs.gamma(2.0, 30.0, (4, 20, 24))
    img.flat[rs.choice(img.size, 5)] = 1e5
    for p in (0.5, 0.99, 1.0):
        _equal(tpre.percentile_clip(img, p), jpre.percentile_clip(img, p))
    _equal(tpre.normalize(img), jpre.normalize(img))


def test_zhang_suen_and_components_match():
    yy, xx = np.mgrid[:31, :31]
    disk = ((yy - 15) ** 2 + (xx - 15) ** 2) <= 100
    _equal(tsim.zhang_suen_thin(disk), jsim.zhang_suen_thin(disk))
    img = np.zeros((20, 20), bool)
    img[1:10, 1:10] = True
    img[15:18, 15:18] = True
    img[0, 19] = True
    for a, b in zip(tsim.largest_components(img),
                    jsim.largest_components(img)):
        _equal(a, b)
    sk = jsim.zhang_suen_thin(disk)
    _equal(tsim._skeleton_longest_path(sk), jsim._skeleton_longest_path(sk))


@pytest.mark.parametrize("seed,cut_branch", [(0, True), (7, True),
                                             (2022, False)])
def test_generate_scribble_matches(seed, cut_branch):
    _, label = _heart(4, 64, 64, seed=seed)
    iters = [(1, 2), (2, 3), (1, 2), (0, 0)] if seed == 7 else (1, 3)
    got = tsim.generate_scribble(label, iters, cut_branch=cut_branch,
                                 seed=seed)
    want = jsim.generate_scribble(label, iters, cut_branch=cut_branch,
                                  seed=seed)
    _equal(got, want)
    assert set(np.unique(got)) > {0}


@pytest.mark.parametrize("seed", [0, 3])
def test_scribble_2d_matches(seed):
    """Slices over 900 pixels take the random erosion: the same draws."""
    yy, xx = np.mgrid[:96, :96]
    mask = np.stack([np.hypot(yy - 48 - seed, xx - 40) < r
                     for r in (20, 26)])
    assert (mask.sum(axis=(1, 2)) > 900).all()
    _equal(tsim.scribble_2d(mask, (4, 10), np.random.RandomState(seed)),
           jsim.scribble_2d(mask, (4, 10), np.random.RandomState(seed)))


def _sample():
    rng = np.random.default_rng(0)
    return {"image": rng.random((70, 80)).astype(np.float32),
            "label": rng.integers(0, 4, (70, 80)).astype(np.int32)}


@pytest.mark.parametrize("name", sorted(jws.OPS))
def test_cta_apply_matches_for_every_op(name):
    """Each op on an image and, where it is geometric, on a label, at three
    argument values."""
    rng = np.random.default_rng(1)
    x = rng.random((32, 40)).astype(np.float32)
    lab = np.zeros((32, 40), np.float32)
    lab[8:24, 6:30] = 3
    assert list(tws.OPS) == list(jws.OPS)
    assert tws.OPS[name][2] == jws.OPS[name][2]
    for t in (0.05, 0.5, 0.93):
        args = tuple(t for _ in jws.OPS[name][2])
        _equal(tws.cta_apply(x, [tws.OpCall(name, args)]),
               jws.cta_apply(x, [jws.OpCall(name, args)]))
        _equal(tws.cta_apply(lab, [tws.OpCall(name, args)], is_label=True),
               jws.cta_apply(lab, [jws.OpCall(name, args)], is_label=True))


def test_ctaugment_policy_and_rates_match():
    """The same policies from a seed, probing and not, the same rates after
    update_rates, and the same stats; the threshold's bin exclusion."""
    a, b = tws.CTAugment(depth=3, seed=3), jws.CTAugment(depth=3, seed=3)
    for step in range(30):
        probe = step % 3 == 0
        pa, pb = a.policy(probe=probe), b.policy(probe=probe)
        assert [(c.name, c.args) for c in pa] == [(c.name, c.args)
                                                  for c in pb]
        a.update_rates(pa, proximity=step / 30)
        b.update_rates(pb, proximity=step / 30)
    for name in jws.OPS:
        for wa, wb in zip(a.rates[name], b.rates[name]):
            _equal(wa, wb)
    assert a.stats() == b.stats()
    ws = []
    for cta in (tws.CTAugment(depth=1, seed=5), jws.CTAugment(depth=1,
                                                              seed=5)):
        (w,) = cta.rates["brightness"]
        w[:] = 1e-6
        w[4] = 1.0
        ws.append([cta._sample_arg(w, probe=False) for _ in range(10)])
    assert ws[0] == ws[1] and all(4 / 17 <= v < 5 / 17 for v in ws[0])


def test_cta_transform_matches():
    sample = _sample()
    got = tws.CTATransform((64, 64), tws.CTAugment(seed=11))(sample)
    want = jws.CTATransform((64, 64), jws.CTAugment(seed=11))(sample)
    for k in ("image_weak", "image_strong", "label_aug"):
        _equal(got[k], want[k])
    for k in ("ops_weak", "ops_strong"):
        assert [(c.name, c.args) for c in got[k]] == [
            (c.name, c.args) for c in want[k]]


@pytest.mark.parametrize("seed,strength", [(0, 1.0), (7, 0.5)])
def test_weak_strong_augment_matches(seed, strength):
    sample = _sample()
    a = tws.WeakStrongAugment((64, 64), seed=seed, strength=strength)
    b = jws.WeakStrongAugment((64, 64), seed=seed, strength=strength)
    for _ in range(4):
        got, want = a(sample), b(sample)
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])


def test_seg_utils_match():
    rs = np.random.RandomState(0)
    lab = rs.randint(0, 25, (16, 16))
    _equal(tseg.decode_segmap(lab), jseg.decode_segmap(lab))
    pred = np.zeros((2, 16, 16), int)
    pred[:, 1:4, 1:4] = 1
    pred[:, 10, 10] = 1
    pred[1, 8:14, 2:6] = 2
    pred[1, 0, 15] = 2
    for p in pred:
        _equal(tseg.post_processing(p), jseg.post_processing(p))
    logit = rs.randn(2, 8, 8, 4).astype(np.float32)
    target = rs.randint(0, 4, (2, 8, 8))
    target[0, :2] = 255
    for kw in ({}, {"weight": [1.0, 2.0, 0.5, 1.5]},
               {"size_average": False, "batch_average": False}):
        assert tseg.cross_entropy2d(logit, target, **kw) == \
            jseg.cross_entropy2d(logit, target, **kw)
    p3, g3 = rs.randint(0, 3, (2, 8, 8)), rs.randint(0, 3, (2, 8, 8))
    _equal(tseg.get_mc_dice(p3, g3, num=3), jseg.get_mc_dice(p3, g3, num=3))
    mask = np.zeros((16, 16), bool)
    mask[4:12, 3:12] = True
    for m in (mask, np.zeros_like(mask), mask[None].repeat(3, 0)):
        _equal(tseg.compute_sdf(m), jseg.compute_sdf(m))
