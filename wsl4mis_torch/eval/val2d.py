"""Volume-wise validation (port of ``wsl4mis_tpu/eval/val2d.py``).

Each slice of a volume is order-0 zoomed to the patch size, run through
the network in eval mode, turned into a class map (argmax, or the
predictor's decision rule), and zoomed back (order 0) to the native
resolution; per-class (dice, hd95) against the dense 3D label are averaged
over the volumes (or NaN-averaged, with ScribbleVC's NaN conventions).
Slices run in 64-slice chunks on the device; metrics stay on the host
(scipy EDT). Spans (``utils.profiling.span``): ``val.pass`` around a
pass, in it ``val.forward`` (a chunk's forward and decision enqueued) and
``val.copy`` (its class map to the host, which waits for the card) a
chunk, then ``val.zoom_back`` (the maps joined and zoomed back).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils.profiling import span
from .metrics import calculate_metric_percase, calculate_metric_percase_nan


def _zoom_index(n_out: int, n_in: int) -> np.ndarray:
    """Order-0 zoom source indices: i * (in-1)/(out-1), rounded half up."""
    return np.clip(
        np.floor(np.arange(n_out) * ((n_in - 1) / (n_out - 1)) + 0.5)
        .astype(np.int64), 0, n_in - 1)


def _zoom_stack(volume: np.ndarray, out_hw) -> np.ndarray:
    d, h, w = volume.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return volume
    return volume[:, _zoom_index(oh, h)[:, None], _zoom_index(ow, w)[None, :]]


class VolumePredictor:
    """Batched slice-stack inference of `model` on `device`: the class map
    is decision_fn(outputs) (B,H,W), by default the argmax of the logits
    (or of the first element of a tuple of outputs). forward_kwargs go to
    every forward (e.g. ScribbleVC's use_class_rep).

    Volumes are padded to a multiple of `bucket` slices and concatenated;
    the stack runs in `chunk`-slice calls. The val set does not change
    during a run, so its device chunks are cached, keyed on the volumes'
    identities (the cache holds the volume list, so no id is reused)."""

    def __init__(self, model, patch_size=(256, 256), device="cuda",
                 bucket: int = 8, chunk: int = 64, decision_fn=None,
                 forward_kwargs=None):
        self.model = model
        self.patch_size = tuple(patch_size)
        self.device = torch.device(device)
        self.bucket = bucket
        self.chunk = max(bucket, chunk)
        self.decision_fn = decision_fn or _argmax_decision
        self.forward_kwargs = dict(forward_kwargs or {})
        self._cache = None

    @torch.no_grad()
    def _predict(self, x: torch.Tensor, variables: dict) -> np.ndarray:
        with span("val.forward"):
            pred = self.decision_fn(self.model(
                x, train=False, **self.forward_kwargs, **variables))
        with span("val.copy"):
            return pred.to(torch.int8).cpu().numpy()

    def _zoom_back(self, pred: np.ndarray, h: int, w: int) -> np.ndarray:
        ph, pw = self.patch_size
        if (h, w) != (ph, pw):
            pred = pred[:, _zoom_index(h, ph)[:, None],
                        _zoom_index(w, pw)[None, :]]
        return pred.astype(np.int32)

    def _stack(self, images):
        """Zoomed, padded device chunks plus per-volume depths/shapes."""
        zoomed, depths, shapes = [], [], []
        for im in images:
            im = np.asarray(im)
            z = _zoom_stack(im.astype(np.float32), self.patch_size)
            pad = (-z.shape[0]) % self.bucket
            if pad:
                z = np.concatenate(
                    [z, np.zeros((pad, *self.patch_size), np.float32)])
            zoomed.append(z)
            depths.append((im.shape[0], z.shape[0]))
            shapes.append(im.shape[1:])
        big = np.concatenate(zoomed)
        pad = (-big.shape[0]) % self.chunk
        if pad:
            big = np.concatenate(
                [big, np.zeros((pad, *self.patch_size), np.float32)])
        chunks = [
            torch.from_numpy(big[i:i + self.chunk][..., None].copy())
            .to(self.device)
            for i in range(0, big.shape[0], self.chunk)
        ]
        return chunks, depths, shapes

    def _run(self, chunks, depths, shapes, variables=None):
        with span("val.pass"):
            maps = [self._predict(x, variables or {}) for x in chunks]
            with span("val.zoom_back"):
                flat = np.concatenate(maps)
                preds, off = [], 0
                for (h, w), (d, dp) in zip(shapes, depths):
                    preds.append(self._zoom_back(flat[off:off + d], h, w))
                    off += dp
        return preds

    def predict_volumes(self, images, variables=None) -> list[np.ndarray]:
        """Per-volume (D, H, W) int32 predictions of a cached val set;
        variables: more forward kwargs for this prediction."""
        key = tuple(id(im) for im in images)
        if self._cache is None or self._cache[0] != key:
            self._cache = (key, list(images), *self._stack(images))
        return self._run(*self._cache[2:], variables)

    def predict_volume(self, image: np.ndarray) -> np.ndarray:
        """(D, H, W) int32 prediction of one volume (not cached)."""
        return self._run(*self._stack([image]))[0]


def _argmax_decision(out):
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out.argmax(-1)


def volume_metrics(pred: np.ndarray, label, classes: int,
                   metric_fn=calculate_metric_percase) -> list:
    """metric_fn(pred == i, label == i) for each foreground class i."""
    label = np.asarray(label)
    return [metric_fn(pred == i, label == i) for i in range(1, classes)]


def test_single_volume(image, label, predictor: VolumePredictor,
                       classes: int, metric_fn=calculate_metric_percase):
    """Per-class [dice, hd95] of one volume (val_2D.py:18-50) through
    predictor.predict_volume. The JAX package's function also takes the
    model's variables; the port's predictor holds its model, so it takes
    none."""
    return volume_metrics(predictor.predict_volume(image), label, classes,
                          metric_fn)


def evaluate_fold(predictor: VolumePredictor, volumes, classes: int,
                  nan_aware: bool = False, variables=None) -> np.ndarray:
    """Mean over volumes of the (classes-1, 2) per-class [dice, hd95];
    with nan_aware, ScribbleVC's conventions: a class absent from a volume
    scores NaN there and the mean is a NaN-mean
    (train_ACDC_scribblevc.py:273-288)."""
    metric = (calculate_metric_percase_nan if nan_aware
              else calculate_metric_percase)
    preds = predictor.predict_volumes([vol["image"] for vol in volumes],
                                      variables)
    per_volume = np.asarray([
        volume_metrics(pred, vol["label"], classes, metric)
        for pred, vol in zip(preds, volumes)], np.float64)
    return nanmean(per_volume) if nan_aware else per_volume.mean(axis=0)


def nanmean(a: np.ndarray) -> np.ndarray:
    """np.nanmean over axis 0, NaN without a warning where a column is all
    NaN (a class absent from every volume)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(a, axis=0)
