"""Weak/strong augmentation pair + CTAugment policy (SSL pipelines; the
port's copy of ``wsl4mis_tpu/data/weak_strong.py``, host numpy and scipy).

Rebuilds the reference's SSL transforms (dataset.py:86-204):

  * ``WeakStrongAugment`` — resize, then weak = random rot90+flip, strong =
    photometric jitter of the weak image; returns
    ``{image, image_weak, image_strong, label_aug}`` (dataset.py:169-199).
    The reference jitters via torchvision ColorJitter(0.8s, 0.8s, 0.8s,
    0.2s) on a grayscale tensor (dataset.py:96-104): saturation/hue are
    no-ops on one channel, so the effective transform is random
    brightness/contrast — implemented directly.
  * ``CTAugment`` — control-theory augment (FixMatch) driving the
    ``CTATransform`` pipeline (dataset.py:106-144). The reference imports a
    missing ``augmentations.ctaugment`` package (SURVEY §0.1); this is a
    self-contained numpy implementation of the published algorithm: each op
    argument has ``bins`` weight slots (init 1), training policies sample
    arguments from bins with normalized weight >= 0.2, probe policies
    sample uniformly, and ``update_rates`` EMA-updates the chosen bins
    toward the model's label-match proximity (decay 0.99).

All ops are pure numpy on float32 images in [0, 1]; geometric ops use
order-0 resampling so the same op list can be replayed on integer labels
(``apply(..., geometric_only=True)``), mirroring cta_apply on the label
(dataset.py:124-126).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage

from .acdc import _nearest_zoom2d


# ---------------------------------------------------------------------------
# ops: name -> (fn(img, *args), arg_bin_counts, geometric)


def _blend(a, b, t):
    return (1 - t) * a + t * b


def _autocontrast(x):
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else x


def _equalize(x):
    flat = np.clip(x, 0, 1).ravel()
    hist, edges = np.histogram(flat, bins=256, range=(0, 1))
    cdf = np.cumsum(hist).astype(np.float64)
    if cdf[-1] == 0:
        return x
    cdf /= cdf[-1]
    return np.interp(np.clip(x, 0, 1), edges[1:], cdf).astype(np.float32)


def _posterize(x, level):
    n = 1 + int(level * 7)  # 1..8 bits
    q = 2**n
    return np.floor(np.clip(x, 0, 1) * (q - 1) + 0.5) / (q - 1)


def _sharpness(x, t):
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    smooth = ndimage.convolve(x, k, mode="nearest")
    return _blend(smooth, x, 0.5 + t)  # t in [0,1]: blur .. oversharpen


def _shear(x, t, axis, order):
    mat = np.eye(2)
    mat[0 if axis else 1, 1 if axis else 0] = (t - 0.5) * 0.6
    c = np.array(x.shape) / 2
    return ndimage.affine_transform(
        x, mat, offset=c - mat @ c, order=order, mode="constant"
    )


def _translate(x, t, axis, order):
    shift = [0.0, 0.0]
    shift[axis] = (t - 0.5) * 0.3 * x.shape[axis]
    return ndimage.shift(x, shift, order=order, mode="constant")


def _rotate(x, t, order):
    return ndimage.rotate(x, (t - 0.5) * 60, order=order, reshape=False)


OPS: dict[str, tuple] = {
    # name: (fn(img, *args) for images, fn or None for labels, bins-per-arg)
    "identity": (lambda x: x, lambda x: x, ()),
    "autocontrast": (_autocontrast, None, ()),
    "brightness": (lambda x, t: np.clip(x * (0.1 + 1.8 * t), 0, 1), None, (17,)),
    "contrast": (
        lambda x, t: np.clip(_blend(float(x.mean()), x, 0.1 + 1.8 * t), 0, 1),
        None, (17,),
    ),
    "equalize": (_equalize, None, ()),
    "invert": (lambda x: 1.0 - x, None, ()),
    "posterize": (_posterize, None, (8,)),
    "sharpness": (_sharpness, None, (17,)),
    "solarize": (lambda x, t: np.where(x < t, x, 1 - x), None, (17,)),
    "rotate": (
        lambda x, t: _rotate(x, t, 1),
        lambda x, t: _rotate(x, t, 0),
        (17,),
    ),
    "shear_x": (
        lambda x, t: _shear(x, t, 1, 1),
        lambda x, t: _shear(x, t, 1, 0),
        (17,),
    ),
    "shear_y": (
        lambda x, t: _shear(x, t, 0, 1),
        lambda x, t: _shear(x, t, 0, 0),
        (17,),
    ),
    "translate_x": (
        lambda x, t: _translate(x, t, 1, 1),
        lambda x, t: _translate(x, t, 1, 0),
        (17,),
    ),
    "translate_y": (
        lambda x, t: _translate(x, t, 0, 1),
        lambda x, t: _translate(x, t, 0, 0),
        (17,),
    ),
}


@dataclass(frozen=True)
class OpCall:
    name: str
    args: tuple  # continuous arg values in [0, 1)


def cta_apply(image: np.ndarray, ops: list[OpCall] | None,
              is_label: bool = False) -> np.ndarray:
    """Replay an op list; labels only see the geometric ops (order 0)."""
    if ops is None:
        return image
    out = image
    for call in ops:
        img_fn, lab_fn, _ = OPS[call.name]
        if is_label:
            if lab_fn is None:
                continue
            out = lab_fn(out, *call.args)
        else:
            out = img_fn(out, *call.args)
    return out


class CTAugment:
    """Bin-weighted augmentation policy learner (FixMatch CTAugment)."""

    def __init__(self, depth: int = 2, decay: float = 0.99,
                 threshold: float = 0.2, seed: int | None = None):
        self.depth = depth
        self.decay = decay
        self.threshold = threshold
        self.rng = np.random.RandomState(seed)
        self.rates = {
            name: [np.ones(b, np.float64) for b in OPS[name][2]]
            for name in OPS
        }

    def _sample_arg(self, weights: np.ndarray, probe: bool) -> float:
        n = len(weights)
        if probe:
            return float(self.rng.uniform(0, 1))
        p = weights / max(float(weights.max()), 1e-12)
        p = np.where(p < self.threshold, 0.0, p)
        p = p / p.sum()
        b = int(self.rng.choice(n, p=p))
        return float((b + self.rng.uniform(0, 1)) / n)

    def policy(self, probe: bool) -> list[OpCall]:
        names = list(OPS)
        calls = []
        for _ in range(self.depth):
            name = names[self.rng.randint(len(names))]
            args = tuple(
                self._sample_arg(w, probe) for w in self.rates[name]
            )
            calls.append(OpCall(name, args))
        return calls

    def update_rates(self, policy: list[OpCall], proximity: float) -> None:
        """EMA the chosen bins toward the model's prediction proximity."""
        for call in policy:
            for value, weights in zip(call.args, self.rates[call.name]):
                b = min(int(value * len(weights)), len(weights) - 1)
                weights[b] = (
                    self.decay * weights[b] + (1 - self.decay) * proximity
                )

    def stats(self) -> str:
        rows = []
        for name, per_arg in self.rates.items():
            if per_arg:
                rows.append(
                    f"{name}: " + ", ".join(
                        f"{w.mean():.2f}" for w in per_arg
                    )
                )
        return "\n".join(rows)


class CTATransform:
    """CTAugment sample transform (dataset.py:106-144 semantics).

    Resizes to ``output_size``, applies the weak policy to image and label
    and additionally the strong policy to the image.
    """

    def __init__(self, output_size=(256, 256), cta: CTAugment | None = None):
        self.output_size = tuple(output_size)
        self.cta = cta or CTAugment()

    def __call__(self, sample: dict, ops_weak=None, ops_strong=None) -> dict:
        image = _nearest_zoom2d(
            sample["image"].astype(np.float32), self.output_size
        )
        label = _nearest_zoom2d(
            sample["label"].astype(np.int32), self.output_size
        )
        if ops_weak is None:
            ops_weak = self.cta.policy(probe=False)
        if ops_strong is None:
            ops_strong = self.cta.policy(probe=False)
        image_weak = cta_apply(image, ops_weak)
        image_strong = cta_apply(image_weak, ops_strong)
        label_aug = cta_apply(
            label.astype(np.float32), ops_weak, is_label=True
        )
        return {
            "image_weak": image_weak.astype(np.float32),
            "image_strong": image_strong.astype(np.float32),
            "label_aug": np.rint(label_aug).astype(np.int32),
            "ops_weak": ops_weak,
            "ops_strong": ops_strong,
        }


class WeakStrongAugment:
    """Weak (rot90+flip) / strong (photometric jitter) pair
    (dataset.py:169-199)."""

    def __init__(self, output_size=(256, 256), seed: int | None = None,
                 strength: float = 1.0):
        self.output_size = tuple(output_size)
        self.rng = np.random.RandomState(seed)
        self.strength = strength

    def _jitter(self, image: np.ndarray) -> np.ndarray:
        # grayscale ColorJitter(0.8s, 0.8s, -, -): random brightness then
        # contrast factors in [max(0, 1-0.8s), 1+0.8s]; torchvision clamps
        # to [0, 1] after each op, so the contrast blend must see the
        # clamped image (and its clamped mean) — without the intermediate
        # clip a brightness factor > 1 leaks up to ~0.06/pixel into the
        # blend (ADVICE.md). Random op order remains immaterial only
        # because each stage is clamped the same way torchvision does.
        s = 0.8 * self.strength
        b = self.rng.uniform(max(0.0, 1 - s), 1 + s)
        c = self.rng.uniform(max(0.0, 1 - s), 1 + s)
        out = np.clip(image * b, 0, 1)
        return np.clip(_blend(float(out.mean()), out, c), 0, 1)

    def __call__(self, sample: dict) -> dict:
        image = _nearest_zoom2d(
            sample["image"].astype(np.float32), self.output_size
        )
        label = _nearest_zoom2d(
            sample["label"].astype(np.int32), self.output_size
        )
        k = self.rng.randint(0, 4)
        axis = self.rng.randint(0, 2)
        image_weak = np.flip(np.rot90(image, k), axis=axis).copy()
        label_aug = np.flip(np.rot90(label, k), axis=axis).copy()
        return {
            "image": image,
            "image_weak": image_weak,
            "image_strong": self._jitter(image_weak).astype(np.float32),
            "label_aug": label_aug,
        }
