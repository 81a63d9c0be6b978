"""The port's Gated CRF loss (wsl4mis_torch/ops/gated_crf.py) on the CPU,
where the contraction runs its plain version, against the JAX package: the
scan (gated_crf_loss) and the Pallas kernel in interpret mode. Inputs come
from a numpy seed.

Tolerances. The JAX functions sum in f32; the port folds its pixel sums in
f64. At these sizes the loss is of order 1-10 and an f32 sum of its ~1e5
terms is good to ~1e-6 of it, so the loss must agree to 1e-5 + 2e-6 |loss|
(the JAX package's own scan-vs-Pallas test allows 1e-5). Gradients are of
order 1e-2 and elementwise f32: 1e-7 absolute, as in that test."""

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
