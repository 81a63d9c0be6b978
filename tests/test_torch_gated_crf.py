"""The port's Gated CRF loss (wsl4mis_torch/ops/gated_crf.py) on the CPU,
where the contraction runs its plain version, against the JAX package: the
scan (gated_crf_loss) and the Pallas kernel in interpret mode. Inputs come
from a numpy seed.

Tolerances. The JAX functions sum in f32; the port folds its pixel sums in
f64. At these sizes the loss is of order 1-10 and an f32 sum of its ~1e5
terms is good to ~1e-6 of it, so the loss must agree to 1e-5 + 2e-6 |loss|
(the JAX package's own scan-vs-Pallas test allows 1e-5). Gradients are of
order 1e-2 and elementwise f32: 1e-7 absolute, as in that test."""

import ctypes
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wsl4mis_tpu.ops.gated_crf import gated_crf_loss as jax_scan  # noqa: E402
from wsl4mis_tpu.ops.pallas.gated_crf_pallas import (  # noqa: E402
    gated_crf_loss_pallas,
)
from wsl4mis_torch.ops import gated_crf as tg  # noqa: E402

TWO_DESC = [{"weight": 0.9, "xy": 6.0, "rgb": 0.1},
            {"weight": 0.1, "xy": 6.0}]


def _inputs(b, h, w, c=4, seed=0, image_scale=1):
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((b, h, w, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    image = rs.rand(b, h * image_scale, w * image_scale, 1).astype(np.float32)
    return probs.astype(np.float32), image


def _torch_loss_and_grad(fn, probs, *args, **kw):
    p = torch.from_numpy(probs).requires_grad_()
    loss = fn(p, *args, **kw)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def _check(got, want, what):
    loss, grad = got
    jloss, jgrad = float(want[0]), np.asarray(want[1])
    assert abs(loss - jloss) <= 1e-5 + 2e-6 * abs(jloss), (what, loss, jloss)
    assert np.abs(grad - jgrad).max() < 1e-7, what


@pytest.mark.parametrize("name,shape,desc", [
    ("default", (2, 24, 24), tg.DEFAULT_KERNELS_DESC),
    ("two_descriptors", (2, 16, 16), TWO_DESC),
    ("image_smaller_than_window", (2, 5, 4), tg.DEFAULT_KERNELS_DESC),
])
def test_loss_and_grad_match_scan_and_pallas(name, shape, desc):
    """Radius 3 (a 7x7 window); the third case has H, W < 2r+1, so every
    pixel's window reaches the zero padding on all sides."""
    probs, image = _inputs(*shape)
    got = _torch_loss_and_grad(tg.gated_crf_loss, probs,
                               torch.from_numpy(image), desc, 3)
    jp, ji = jnp.asarray(probs), jnp.asarray(image)
    scan = jax.value_and_grad(
        lambda p: jax_scan(p, ji, kernels_desc=desc, radius=3))(jp)
    _check(got, scan, f"{name}: scan")
    pallas = jax.value_and_grad(lambda p: gated_crf_loss_pallas(
        p, ji, 3, True, kernels_desc=desc))(jp)
    _check(got, pallas, f"{name}: pallas")


def _half(x, size):
    """A custom downsampler: the top-left sample of each cell."""
    fh, fw = x.shape[1] // size[0], x.shape[2] // size[1]
    return x[:, ::fh, ::fw]


def _variants():
    rs = np.random.RandomState(5)
    mask = (rs.rand(2, 12, 12, 1) > 0.3).astype(np.float32)
    mask[0, 0, 0, 0] = np.nan  # _fix_mask zeroes NaNs
    big_mask = np.repeat(np.repeat(mask, 2, 1), 2, 2)
    compat = rs.rand(4, 4).astype(np.float32)
    return [
        ("mask_src", 1, dict(mask_src=mask)),
        ("mask_dst", 1, dict(mask_dst=mask)),
        ("both_masks_oversized", 1, dict(mask_src=big_mask, mask_dst=mask)),
        ("compatibility", 1, dict(compatibility=compat)),
        ("downsampled_modality", 2, dict()),
        ("custom_downsampler", 2,
         dict(custom_modality_downsamplers={"rgb": _half})),
    ]


@pytest.mark.parametrize("name,image_scale,kw", _variants(),
                         ids=[v[0] for v in _variants()])
def test_variants_match_the_scan(name, image_scale, kw):
    """Masks, compatibility and over-resolution modalities take the plain
    loop on any device; value and autograd gradient against the scan."""
    probs, image = _inputs(2, 12, 12, seed=2, image_scale=image_scale)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = _torch_loss_and_grad(tg.gated_crf_loss, probs,
                               torch.from_numpy(image), TWO_DESC, 2, **tkw)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jax.value_and_grad(lambda p: jax_scan(
        p, jnp.asarray(image), kernels_desc=TWO_DESC, radius=2, **jkw))(
            jnp.asarray(probs))
    _check(got, want, name)


@pytest.mark.parametrize("desc", [tg.DEFAULT_KERNELS_DESC, TWO_DESC],
                         ids=["default", "two_descriptors"])
def test_analytic_backward_equals_autograd_of_the_plain_loop(desc):
    """The Function's grad_probs = -2 g prod / (B H W) against autograd
    through the offset loop, at radius 5 on an image the window overhangs
    (9 x 14 < 11 in one direction), with an upstream factor g = 0.1."""
    probs, image = _inputs(2, 9, 14, seed=4)
    img = torch.from_numpy(image)
    l1, g1 = _torch_loss_and_grad(
        lambda p, *a: 0.1 * tg.gated_crf_loss(p, *a), probs, img, desc, 5)
    l2, g2 = _torch_loss_and_grad(
        lambda p, *a: 0.1 * tg.gated_crf_loss_plain(p, *a), probs, img, desc,
        5)
    assert abs(l1 - l2) <= 1e-6 * abs(l2)
    assert np.abs(g1 - g2).max() <= 1e-6 * np.abs(g2).max()


def test_border_kernel_counts_the_zero_padding():
    """One pixel, radius 1: all 8 neighbours are padding, so
    sum k = 8 w exp(-0.5 |f|^2) with f the pixel's own features, and prod
    is 0; a kernel that skipped outside offsets would give 0."""
    probs = torch.full((1, 1, 1, 4), 0.25)
    image = torch.full((1, 1, 1, 1), 0.05)
    feats, weights, splits = tg.stacked_features(
        image, tg.DEFAULT_KERNELS_DESC, 1, 1)
    prod, ksum = tg.gated_crf_products(probs, feats, 1, weights, splits)
    assert torch.equal(prod, torch.zeros_like(prod))
    assert ksum.dtype == torch.float64 and tuple(ksum.shape) == (1,)
    np.testing.assert_allclose(float(ksum), 8 * np.exp(-0.5 * 0.25),
                               rtol=1e-6)


def test_kernel_wrapper_checks_before_it_launches():
    """The CUDA wrapper validates in Python first: these raise on the CPU
    without a build."""
    probs = torch.zeros((1, 4, 4, 4))
    feats = torch.zeros((1, 4, 4, 3))
    with pytest.raises(ValueError, match="exceed the kernel's limits"):
        tg._products_kernel(torch.zeros((1, 4, 4, 9)), feats, 1, [1.0], [3])
    with pytest.raises(ValueError, match="exceed the kernel's limits"):
        tg._products_kernel(probs, torch.zeros((1, 4, 4, 9)), 1, [1.0], [9])
    with pytest.raises(ValueError, match="does not cover"):
        tg._products_kernel(probs, feats, 1, [1.0, 1.0], [3])
    with pytest.raises(ValueError, match="shared memory"):
        tg._products_kernel(probs, feats, 40, [1.0], [3])
    with pytest.raises(TypeError, match="float32"):
        tg._products_kernel(probs.double(), feats, 1, [1.0], [3])
    with pytest.raises(RuntimeError, match="no gated_crf implementation"):
        tg.gated_crf_products(probs.to("meta"), feats.to("meta"), 1, [1.0],
                              [3])
    assert tg.launches == {"gated_crf": 0}


@pytest.mark.parametrize("desc", [tg.DEFAULT_KERNELS_DESC, TWO_DESC],
                         ids=["default", "two_descriptors"])
def test_xy_from_sigmas_equals_the_stacked_features(desc):
    """The kernel route's inputs (split_features: the image channels and
    each descriptor's xy sigma) give, through the plain version, exactly
    the plain version on the full stacked features; and those are each
    descriptor's x, y meshes / sigma and image / sigma, built here in
    numpy."""
    probs, image = _inputs(2, 9, 13, seed=7)
    p, img = torch.from_numpy(probs), torch.from_numpy(image)
    planes, weights, nf, xy = tg.split_features(img, desc, 9, 13)
    assert planes.shape[-1] == sum(nf) == len(desc) - (desc is TWO_DESC)
    assert xy == [6.0] * len(desc)
    feats, w_full, splits = tg.stacked_features(img, desc, 9, 13)
    assert w_full == weights and splits == [3, 2][:len(desc)]
    yy, xx = np.meshgrid(np.arange(9, dtype=np.float32),
                         np.arange(13, dtype=np.float32), indexing="ij")
    want = []
    for d in desc:
        want += [np.broadcast_to(xx / np.float32(d["xy"]), (2, 9, 13)),
                 np.broadcast_to(yy / np.float32(d["xy"]), (2, 9, 13))]
        if "rgb" in d:
            want.append(image[..., 0] / np.float32(d["rgb"]))
    np.testing.assert_allclose(feats.numpy(), np.stack(want, -1), rtol=1e-6)
    got = tg.gated_crf_products(p, planes, 4, weights, nf, xy)
    ref = tg.gated_crf_products_plain(p, feats, 4, weights, splits)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_xy_from_sigmas_matches_scan_and_pallas_at_radius_5():
    """The kernel route's form of the default descriptor on a 10 x 14
    image at radius 5: its products give the loss of the JAX scan and of
    the Pallas kernel in interpret mode."""
    probs, image = _inputs(2, 10, 14, seed=8)
    p, img = torch.from_numpy(probs), torch.from_numpy(image)
    desc = tg.DEFAULT_KERNELS_DESC
    planes, weights, nf, xy = tg.split_features(img, desc, 10, 14)
    prod, ksum = tg.gated_crf_products(p, planes, 5, weights, nf, xy)
    loss = float(tg._loss_from_products(p, prod, ksum))
    jp, ji = jnp.asarray(probs), jnp.asarray(image)
    for want in (jax_scan(jp, ji, kernels_desc=desc, radius=5),
                 gated_crf_loss_pallas(jp, ji, 5, True, kernels_desc=desc)):
        assert abs(loss - float(want)) <= 1e-5 + 2e-6 * abs(float(want))


class _FakeLib:
    """Stands in for the built library: records the entry point's calls."""

    def __init__(self):
        self.calls = []

    def gated_crf_products(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(tg._build, "lib", lambda name: lib)
    monkeypatch.setattr(tg._build, "on_device", lambda t: nullcontext())
    monkeypatch.setattr(tg._build, "stream", lambda t: 0)
    return lib


def test_xy_route_wrapper_checks_before_it_launches(fake_lib):
    """With xy sigmas the wrapper rejects, in Python and before the library
    is called: sigmas that are not positive or not one per descriptor, a
    descriptor with neither xy nor a channel, mismatched shapes, devices
    and layouts, and the kernel's limits. A good call makes one call of the
    C entry point with the stored channels only, the descriptors' host
    arrays, and one f64 buffer holding sum k and then the partials."""
    probs = torch.zeros((2, 5, 7, 4))
    planes = torch.zeros((2, 5, 7, 1))
    k = tg._products_kernel
    for bad_xy in ([0.0], [-6.0], [float("nan")]):
        with pytest.raises(ValueError, match="positive"):
            k(probs, planes, 1, [1.0], [1], bad_xy)
    with pytest.raises(ValueError, match="does not cover"):
        k(probs, planes, 1, [1.0], [1], [6.0, 6.0])
    with pytest.raises(ValueError, match="does not cover"):
        k(probs, planes, 1, [0.9, 0.1], [1, 0], [6.0, None])
    with pytest.raises(ValueError, match="disagree"):
        k(probs, torch.zeros((2, 5, 6, 1)), 1, [1.0], [1], [6.0])
    with pytest.raises(ValueError, match="different devices"):
        k(probs, planes.to("meta"), 1, [1.0], [1], [6.0])
    with pytest.raises(ValueError, match="contiguous"):
        k(probs, torch.zeros((2, 7, 5, 1)).transpose(1, 2), 1, [1.0], [1],
          [6.0])
    with pytest.raises(ValueError, match="limits"):
        k(torch.zeros((65536, 1, 1, 4)), torch.zeros((65536, 1, 1, 1)), 1,
          [1.0], [1], [6.0])
    with pytest.raises(ValueError, match="shared memory"):
        k(probs, planes, 60, [1.0], [1], [6.0])
    assert fake_lib.calls == [] and tg.launches == {"gated_crf": 0}
    prod, ksum = k(probs, torch.zeros((2, 5, 7, 1)), 3, [0.9, 0.1], [1, 0],
                   [6.0, 2.0])
    (args,) = fake_lib.calls
    assert args[5:12] == (2, 5, 7, 4, 1, 3, 2)
    assert prod.shape == probs.shape and ksum.dtype == torch.float64
    assert tuple(ksum.shape) == (2,) and args[4] == ksum.data_ptr()
    assert args[3] == ksum.data_ptr() + 8 * 2  # the partials follow ksum
    w_arr, xy_arr, desc_of = tg._desc_arrays((0.9, 0.1), (1, 0), (6.0, 2.0))
    assert args[12:15] == tuple(ctypes.addressof(a)
                                for a in (w_arr, xy_arr, desc_of))
    assert list(xy_arr) == [6.0, 2.0] and list(desc_of) == [0]
    assert tg.launches == {"gated_crf": 1}
    tg.launches["gated_crf"] = 0


def test_shared_memory_limit_is_the_kernels():
    """_smem_bytes mirrors the kernel's layout at 32 x 32 tiles: float4
    probabilities (classes padded to 4 or 8) on an odd pitch, feature
    planes on a pitch of 1 mod 8, one x and one y table per descriptor; the
    default descriptor fits 3 blocks an SM at radius 5."""
    ph = pw = 42
    assert tg._smem_bytes(4, 1, 1, 5) == 4 * (4 * ph * 43 + ph * 49 + 84)
    assert tg._smem_bytes(5, 8, 4, 5) == 4 * (8 * ph * 43 + 8 * ph * 49
                                              + 4 * 84)
    assert 3 * tg._smem_bytes(4, 1, 1, 5) <= 228 * 1024
    assert tg._smem_bytes(8, 8, 4, 13) <= tg._MAX_SMEM
    assert tg._smem_bytes(8, 8, 4, 14) > tg._MAX_SMEM
