"""Scribble simulation from dense masks — no skimage/PIL (the port's copy
of ``wsl4mis_tpu/data/scribble_sim.py``; host numpy and scipy, the same
``np.random.RandomState`` draws, so a seed gives the same scribble).

Capability parity with the reference's code/scribbles_generator.py: for each
class and slice, erode the mask (random 4-10 iterations when the region is
large), thin it to a 1-pixel skeleton, prune to a single curve, jitter it
with a random shift/rotation constrained to stay inside the object, and
emit a labeled scribble map (background scribble takes id class_num; the
reference finally remaps 0 -> ignore).

Original algorithm choices (documented divergences, same intent):
  * thinning: Zhang-Suen two-subiteration thinning instead of skimage's
    Lee94 (`skeletonize(method='lee')`, scribbles_generator.py:228) — both
    produce 1-px medial curves;
  * branch pruning: BFS longest-path extraction over the skeleton graph
    instead of the reference's recursive endpoint walk
    (Cutting_branch, scribbles_generator.py:113-210) — both reduce the
    skeleton to one open curve.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

_STRUCT8 = ndimage.generate_binary_structure(2, 2)


def zhang_suen_thin(mask: np.ndarray) -> np.ndarray:
    """Classic Zhang-Suen thinning of a binary 2D mask."""
    img = np.asarray(mask, dtype=np.uint8).copy()
    changed = True
    while changed:
        changed = False
        for step in (0, 1):
            p = np.pad(img, 1)
            p2 = p[:-2, 1:-1]
            p3 = p[:-2, 2:]
            p4 = p[1:-1, 2:]
            p5 = p[2:, 2:]
            p6 = p[2:, 1:-1]
            p7 = p[2:, :-2]
            p8 = p[1:-1, :-2]
            p9 = p[:-2, :-2]
            neighbors = [p2, p3, p4, p5, p6, p7, p8, p9]
            b = sum(neighbors)
            ring = neighbors + [p2]
            a = sum(
                ((ring[k] == 0) & (ring[k + 1] == 1)).astype(np.uint8)
                for k in range(8)
            )
            if step == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            remove = (img == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
            if remove.any():
                img[remove] = 0
                changed = True
    return img.astype(np.int32)


def largest_components(mask: np.ndarray, keep_two_ratio: float = 10.0):
    """Largest (or two largest, when comparable) 8-connected components.

    Mirrors get_largest_two_component_2D (scribbles_generator.py:63-111):
    the second component is kept only if 10x its size exceeds the first's.
    """
    labeled, n = ndimage.label(mask, _STRUCT8)
    if n <= 1:
        return [np.asarray(mask, bool)]
    sizes = ndimage.sum(mask, labeled, range(1, n + 1))
    order = np.argsort(sizes)[::-1]
    first = labeled == (order[0] + 1)
    if sizes[order[1]] * keep_two_ratio > sizes[order[0]]:
        return [first, labeled == (order[1] + 1)]
    return [first]


def _skeleton_longest_path(skel: np.ndarray) -> np.ndarray:
    """Keep only the longest 8-connected path through a skeleton."""
    pts = np.argwhere(skel)
    if len(pts) <= 2:
        return skel.astype(np.int32)
    index = {tuple(p): i for i, p in enumerate(pts)}
    nbrs = [[] for _ in range(len(pts))]
    for i, (y, x) in enumerate(pts):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == dx == 0:
                    continue
                j = index.get((y + dy, x + dx))
                if j is not None:
                    nbrs[i].append(j)

    def bfs(start):
        dist = {start: 0}
        parent = {start: -1}
        queue = [start]
        far = start
        while queue:
            cur = queue.pop(0)
            for j in nbrs[cur]:
                if j not in dist:
                    dist[j] = dist[cur] + 1
                    parent[j] = cur
                    queue.append(j)
                    if dist[j] > dist[far]:
                        far = j
        return far, parent

    # double-BFS longest path within the largest connected piece
    a, _ = bfs(0)
    b, parent = bfs(a)
    keep = np.zeros(len(pts), bool)
    cur = b
    while cur != -1:
        keep[cur] = True
        cur = parent[cur]
    out = np.zeros_like(skel, dtype=np.int32)
    ys, xs = pts[keep, 0], pts[keep, 1]
    out[ys, xs] = 1
    return out


def _jitter_within(scribble: np.ndarray, mask: np.ndarray, rng,
                   max_shift: int = 6, max_angle: float = 15.0,
                   tries: int = 8) -> np.ndarray:
    """Random shift/rotate of the scribble, constrained inside the mask
    (the reference shifts/rotates the cut branch, Cutting_branch
    :204-208). Falls back to the unjittered scribble."""
    h, w = scribble.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.nonzero(scribble)
    if ys.size == 0:
        return scribble
    for _ in range(tries):
        ang = math.radians(rng.uniform(-max_angle, max_angle))
        dy = rng.randint(-max_shift, max_shift + 1)
        dx = rng.randint(-max_shift, max_shift + 1)
        c, s = math.cos(ang), math.sin(ang)
        ny = np.round(c * (ys - cy) - s * (xs - cx) + cy + dy).astype(int)
        nx = np.round(s * (ys - cy) + c * (xs - cx) + cx + dx).astype(int)
        if (ny < 0).any() or (ny >= h).any() or (nx < 0).any() or (nx >= w).any():
            continue
        if mask[ny, nx].all():
            out = np.zeros_like(scribble)
            out[ny, nx] = 1
            return out
    return scribble


def scribble_2d(label: np.ndarray, iteration=(4, 10), rng=None) -> np.ndarray:
    """Per-slice skeleton scribbles of a binary (D, H, W) mask.

    Parity with scrible_2d (scribbles_generator.py:213-230): erode with a
    random number of iterations in [lo, hi] when the slice area > 900.
    """
    rng = rng or np.random.RandomState(0)
    out = np.zeros_like(label, dtype=np.int32)
    for i in range(label.shape[0]):
        sl = label[i].astype(bool)
        if not sl.any():
            continue
        if sl.sum() > 900 and iteration not in (0, [0], None):
            iters = math.ceil(
                iteration[0] + rng.random_sample() * (iteration[1] - iteration[0])
            )
            eroded = ndimage.binary_erosion(sl, structure=_STRUCT8,
                                            iterations=iters)
            sl = eroded if eroded.any() else sl
        out[i] = zhang_suen_thin(sl)
    return out


def scribble_for_class(label: np.ndarray, class_id: int, class_num: int,
                       iteration=(4, 10), cut_branch: bool = True,
                       rng=None) -> np.ndarray:
    """scribble4class parity (scribbles_generator.py:233-245)."""
    rng = rng or np.random.RandomState(0)
    mask = label == class_id
    sk = scribble_2d(mask, iteration=iteration, rng=rng)
    if cut_branch and class_id != 0:
        for i in range(sk.shape[0]):
            if sk[i].sum() < 1:
                continue
            pruned = _skeleton_longest_path(sk[i])
            sk[i] = _jitter_within(pruned, mask[i], rng)
    out_id = class_num if class_id == 0 else class_id
    return sk * out_id


def generate_scribble(label: np.ndarray, iterations=(4, 10),
                      cut_branch: bool = True, seed: int = 2022) -> np.ndarray:
    """Dense (D, H, W) label volume -> simulated scribble volume.

    Classes 1..C-1 keep their ids; the background scribble takes id C
    (generate_scribble, scribbles_generator.py:248-256). The caller remaps
    unscribbled 0 to the ignore id per its convention (the reference
    __main__ uses 0 -> 255, the ACDC data uses 4).
    """
    rng = np.random.RandomState(seed)
    class_num = int(np.max(label)) + 1
    out = np.zeros_like(label, dtype=np.uint8)
    for c in range(class_num):
        it = iterations[c] if isinstance(iterations, list) else iterations
        out += scribble_for_class(
            label, c, class_num, it, cut_branch=cut_branch, rng=rng
        ).astype(np.uint8)
    return out
