"""Inputs made from the seed, on the device, in a few large calls.

* ``seed_of(seed, purpose)``: an independent 63-bit seed for each use of
  the run's ``--seed`` (any whole number: SeedSequence takes big ones).
* ``phantoms``: the recipe of ``wsl4mis_torch/data/synthetic.py`` (nested
  ellipses: class 3 inside the ring of class 2, class 1 to one side, on
  background 0; per-class intensity plus Gaussian noise), copied here so
  that the traffic stays fixed whatever the program's copy becomes, and
  drawn on the device from a torch.Generator there.
* ``scribble``: the label kept on the diagonal grid (i + j) % 12 == 0,
  the rest the ignore class 4.
* ``slices``: a training dataset of the traffic, with its labels.
* ``weights``: every leaf of a reference model's list from one uniform
  draw, in f32 (the type the port keeps its parameters in).
"""

from __future__ import annotations

import numpy as np
import torch

INTENSITY = (0.1, 0.5, 0.7, 0.9)
CHUNK = 256  # slices per call of the phantom draw


def seed_of(seed: int, purpose: str) -> int:
    words = [int(seed) & (2 ** 64 - 1)] + [ord(c) for c in purpose]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        seed_of(seed, purpose))


def _phantom_chunk(gen, n, h, w, device):
    yy = torch.linspace(-1.0, 1.0, h, device=device).view(1, h, 1)
    xx = torch.linspace(-1.0, 1.0, w, device=device).view(1, 1, w)
    u = torch.rand((n, 5), generator=gen, device=device)
    cy, cx = (-0.2 + 0.4 * u[:, 0]).view(n, 1, 1), \
        (-0.2 + 0.4 * u[:, 1]).view(n, 1, 1)
    ay, ax = (0.2 + 0.15 * u[:, 2]).view(n, 1, 1), \
        (0.2 + 0.15 * u[:, 3]).view(n, 1, 1)
    side = torch.where(u[:, 4] > 0.5, 1.0, -1.0).view(n, 1, 1)
    r = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2
    r1 = ((yy - cy) / (1.2 * ay)) ** 2 \
        + ((xx - cx - side * 1.3 * ax) / (0.7 * ax)) ** 2
    labels = torch.zeros((n, h, w), dtype=torch.uint8, device=device)
    labels[r1 < 1.0] = 1
    labels[r < 1.0] = 2
    labels[r < 0.45] = 3
    table = torch.tensor(INTENSITY, device=device)
    images = table[labels.long()] + 0.1 * torch.randn(
        (n, h, w), generator=gen, device=device)
    return images, labels


def phantoms(seed: int, purpose: str, n: int, h: int, w: int, device):
    """(images (n,h,w) f32, dense labels (n,h,w) uint8) on `device`."""
    gen = generator(seed, purpose, device)
    images = torch.empty((n, h, w), dtype=torch.float32, device=device)
    labels = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        images[s:e], labels[s:e] = _phantom_chunk(gen, e - s, h, w, device)
    return images, labels


def scribble(labels: torch.Tensor) -> torch.Tensor:
    h, w = labels.shape[-2:]
    i = torch.arange(h, device=labels.device).view(h, 1)
    j = torch.arange(w, device=labels.device).view(1, w)
    keep = (i + j) % 12 == 0
    return torch.where(keep, labels, torch.full_like(labels, 4))


def slices(seed: int, i: int, dataset: dict, h: int, w: int,
           device) -> dict:
    """A traffic's i-th training dataset, {"slices": n, "labels":
    "scribble" | "label", "dense_labels": bool}: {"images" (n,h,w) f32,
    "labels" (n,h,w) uint8 (the supervision), "dense" (the dense labels
    where asked for, else None)} on `device`."""
    images, dense = phantoms(seed, "slices" if i == 0 else f"slices{i}",
                             dataset["slices"], h, w, device)
    kind = dataset["labels"]
    if kind not in ("scribble", "label"):
        raise ValueError(f"unknown labels {kind!r}")
    labels = scribble(dense) if kind == "scribble" else dense
    return {"images": images, "labels": labels,
            "dense": dense if dataset.get("dense_labels") else None}


def weights(leaves, seed: int, device) -> dict:
    """{name: f32 tensor} for `leaves` [(name, shape, init, kind)], init one of
    ("uniform", bound), ("ones",), ("zeros",): every uniform leaf cut from
    one draw on the device."""
    gen = generator(seed, "weights", device)
    sizes = [int(np.prod(shape)) for _, shape, init, _ in leaves
             if init[0] == "uniform"]
    flat = torch.rand((sum(sizes),), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init, _ in leaves:
        if init[0] == "uniform":
            k = int(np.prod(shape))
            out[name] = ((flat[off:off + k] * 2.0 - 1.0) * init[1]).view(
                shape)
            off += k
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
