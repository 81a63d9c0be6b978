"""Parity of the port's batch augmentation (plain version, on the CPU) with
the JAX package's.

* Branches 0 (rot90 + flip) and 2 (identity) are index maps: bit-exact
  against data/augment_device._rot90_flip.
* Branch 1 is the exact inverse-map nearest rotate of
  augment_device._rotate_nearest; it matches on >= 99.9% of pixels. A
  difference can only come from cos/sin of the angle computed in f32 on two
  backends (torch vs XLA), which moves a source coordinate across a
  rounding boundary.
* Against the TPU kernel (augment_pallas, interpret mode), whose rotate is
  a 3-shear approximation, branch 1 matches on >= 97% of pixels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wsl4mis_tpu.data import augment_device as jad  # noqa: E402
from wsl4mis_tpu.ops.pallas.augment_pallas import (  # noqa: E402
    _sample_policy,
    augment_batch_pallas,
)
from wsl4mis_torch.data.augment_device import sample_policy  # noqa: E402
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.ops.augment import augment_batch  # noqa: E402


def _batch(b, h, seed=0, with_ignore=True):
    rs = np.random.RandomState(seed)
    images = rs.standard_normal((b, h, h)).astype(np.float32)
    labels = rs.randint(0, 5 if with_ignore else 4, (b, h, h)).astype(np.int32)
    return images, labels


def _run(images, labels, policy):
    img, lab = augment_batch(torch.from_numpy(images),
                             torch.from_numpy(labels),
                             torch.tensor(policy, dtype=torch.int32))
    return img.numpy(), lab.numpy()


def test_rot90_flip_and_identity_bit_exact():
    policy = [(0, k, axis, 0) for k in range(4) for axis in range(2)]
    policy.append((2, 3, 1, 7))
    images, labels = _batch(len(policy), 24)
    img, lab = _run(images, labels, policy)
    for i, (branch, k, axis, _) in enumerate(policy):
        if branch == 2:
            want_i, want_l = images[i], labels[i]
        else:
            want_i = jad._rot90_flip(jnp.asarray(images[i]), k, axis)
            want_l = jad._rot90_flip(jnp.asarray(labels[i]), k, axis)
        np.testing.assert_array_equal(img[i], np.asarray(want_i))
        np.testing.assert_array_equal(lab[i], np.asarray(want_l))


def test_rotate_matches_exact_gather():
    angles = np.arange(-20, 20)
    images, labels = _batch(len(angles), 256, seed=1)
    img, lab = _run(images, labels, [(1, 0, 0, a) for a in angles])
    rot = jax.vmap(jad._rotate_nearest, in_axes=(0, 0, None))
    want_i = np.asarray(rot(jnp.asarray(images), jnp.asarray(angles), 0.0))
    want_l = np.asarray(jax.vmap(jad._rotate_nearest)(
        jnp.asarray(labels), jnp.asarray(angles),
        jnp.full((len(angles),), 4, jnp.int32)))
    assert np.mean(img == want_i) >= 0.999
    assert np.mean(lab == want_l) >= 0.999


def test_matches_pallas_kernel_policy_by_policy():
    """Same key -> same policy. Piecewise-constant planes (phantoms, as in
    real slices): the 3-shear's one-pixel source offsets only show at
    region borders. On i.i.d. noise every offset shows, and agreement falls
    to the ~55% that tests/test_pallas_ops.py bounds."""
    rng = jax.random.key(3)
    b, h = 16, 64
    labels = synthetic_slices(b, (h, h), seed=3).labels
    images = labels.astype(np.float32) * 0.3
    branch, k, axis, angle, _ = _sample_policy(
        jax.random.split(rng, b), jnp.asarray(labels))
    policy = np.stack([np.asarray(v) for v in (branch, k, axis, angle)], 1)
    assert {0, 1} <= set(policy[:, 0].tolist())
    want_i, want_l = augment_batch_pallas(
        rng, jnp.asarray(images), jnp.asarray(labels), interpret=True)
    img, lab = _run(images, labels, policy)
    want_i, want_l = np.asarray(want_i), np.asarray(want_l)
    for i in range(b):
        if policy[i, 0] == 1:
            assert np.mean(img[i] == want_i[i]) >= 0.97
            assert np.mean(lab[i] == want_l[i]) >= 0.97
        else:
            np.testing.assert_array_equal(img[i], want_i[i])
            np.testing.assert_array_equal(lab[i], want_l[i])


@pytest.mark.parametrize("with_ignore,fill", [(True, 4), (False, 0)])
def test_label_fill_rule(with_ignore, fill):
    """Rotated-in corners: image 0; label 4 iff the label has class 4."""
    images, labels = _batch(1, 32, seed=4, with_ignore=with_ignore)
    img, lab = _run(images, labels, [(1, 0, 0, 19)])
    assert img[0, 0, 0] == 0.0 and lab[0, 0, 0] == fill
    assert lab[0, -1, -1] == fill


def test_sample_policy_distribution():
    labels = torch.zeros((20000, 2, 2), dtype=torch.int32)
    p = sample_policy(torch.Generator().manual_seed(0), labels)
    assert p.dtype == torch.int32 and p.shape == (20000, 4)
    freq = torch.bincount(p[:, 0].long(), minlength=3).double() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.25, 0.25], atol=0.02)
    assert p[:, 1].min() == 0 and p[:, 1].max() == 3
    assert set(p[:, 2].tolist()) == {0, 1}
    assert p[:, 3].min() == -20 and p[:, 3].max() == 19
