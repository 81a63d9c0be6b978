"""Host augmentation with the reference's exact semantics (port of
``wsl4mis_tpu/data/augment.py``; RandomGenerator of the reference's
dataset.py:147-166 and dataset_semi.py:146-171): a two-coin policy on the
slice at its native resolution, then an order-0 zoom to the patch size.

    if U1 > 0.5:      rot90 by k ~ randint(0, 4), then a flip along
                      axis ~ randint(0, 2)
    elif U2 > 0.5:    nearest rotate by angle ~ randint(-20, 20) degrees,
                      the label filled with cval (4 if the slice holds the
                      ignore class 4, else 0)
    zoom both to the patch size (order 0)

The draws come from one numpy RandomState in this order, so a seed gives
the JAX package's batches bit for bit. ``aug_mode="host"`` trains on it;
the default path augments on the device (``ops/augment.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from .acdc import _nearest_zoom2d


class HostRandomGenerator:
    """Callable transform of a {"image", "label"} sample dict, drawing from
    its own RandomState(seed)."""

    def __init__(self, output_size=(256, 256), seed: int | None = None):
        self.output_size = tuple(output_size)
        self.rng = np.random.RandomState(seed)

    def _rot_flip(self, image, label):
        k = self.rng.randint(0, 4)
        image = np.rot90(image, k)
        label = np.rot90(label, k)
        axis = self.rng.randint(0, 2)
        return (np.flip(image, axis=axis).copy(),
                np.flip(label, axis=axis).copy())

    def _rotate(self, image, label, cval):
        angle = self.rng.randint(-20, 20)
        image = ndimage.rotate(image, angle, order=0, reshape=False)
        label = ndimage.rotate(label, angle, order=0, reshape=False,
                               mode="constant", cval=cval)
        return image, label

    def __call__(self, sample: dict) -> dict:
        image, label = sample["image"], sample["label"]
        if self.rng.random_sample() > 0.5:
            image, label = self._rot_flip(image, label)
        elif self.rng.random_sample() > 0.5:
            cval = 4 if 4 in np.unique(label) else 0
            image, label = self._rotate(image, label, cval)
        image = _nearest_zoom2d(np.ascontiguousarray(image), self.output_size)
        label = _nearest_zoom2d(np.ascontiguousarray(label), self.output_size)
        return {"image": image.astype(np.float32),
                "label": label.astype(np.int32)}
