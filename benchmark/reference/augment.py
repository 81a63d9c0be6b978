"""The reference scripts' augmentation (RandomGenerator: random_rot_flip
or random_rotate, each with probability one half), sample by sample, as
the train command applies it on the device:

* branch 0: ``np.rot90(x, k)`` then ``np.flip`` along `axis`;
* branch 1: rotation by the integer angle about the plane's centre,
  nearest neighbour, the inverse map worked out in f32 (cos and sin of
  angle * f32(pi/180); source = R^-1 (p - c) + c, each product and sum
  rounded apart, then rounded half up); a source outside the plane gives
  0 in the image and, in the label, 4 where the label holds the ignore
  class 4, else 0;
* branch 2: the slice as it is.
"""

from __future__ import annotations

import math

import torch


def _rotate(x, y, c, s):
    h, w = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, device=x.device, dtype=torch.float32) - cy
          ).view(h, 1)
    xx = (torch.arange(w, device=x.device, dtype=torch.float32) - cx
          ).view(1, w)
    sy = c * yy + s * xx + cy
    sx = (-s) * yy + c * xx + cx
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    si = torch.floor(sy + 0.5).long().clamp(0, h - 1)
    sj = torch.floor(sx + 0.5).long().clamp(0, w - 1)
    fill = 4 if bool((y == 4).any()) else 0
    xo = torch.where(inside, x[si, sj], torch.zeros((), device=x.device))
    yo = torch.where(inside, y[si, sj],
                     torch.full((), fill, dtype=y.dtype, device=y.device))
    return xo, yo


def augment(images, labels, policy):
    """images (B,H,W) f32, labels (B,H,W) int, policy (B,4) int rows of
    (branch, k, axis, angle) -> the augmented pair."""
    theta = policy[:, 3].float() * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    xs, ys = [], []
    for b, (branch, k, axis, _) in enumerate(policy.tolist()):
        x, y = images[b], labels[b]
        if branch == 0:
            x = torch.flip(torch.rot90(x, k, (0, 1)), (axis,))
            y = torch.flip(torch.rot90(y, k, (0, 1)), (axis,))
        elif branch == 1:
            x, y = _rotate(x, y, cos[b], sin[b])
        xs.append(x)
        ys.append(y)
    return torch.stack(xs), torch.stack(ys)
