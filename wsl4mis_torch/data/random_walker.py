"""Random-walker segmentation (Grady 2006) on scipy.sparse, no skimage
(port of ``wsl4mis_tpu/data/random_walker.py``, the same numpy and scipy
code: the two give the same labels bit for bit).

Used for ACDC random-walker pseudo labels
(acdc_pseudo_label_random_walker.py:9-26 of the reference): scribble seeds
propagate through the image via the graph Laplacian with Gaussian edge
weights; an unseeded pixel gets the label whose seeds it is most likely to
reach first.

It follows skimage.segmentation.random_walker(mode='bf'): edge weight
w = exp(-beta * (dI)^2 / (10 * std(dI^2))), a Dirichlet solve per label
with a direct sparse factorization. scipy is imported by the functions
that need it.
"""

from __future__ import annotations

import os

import numpy as np


def _edge_weights(data: np.ndarray, beta: float, eps: float = 1.0e-10):
    """Per-axis forward-difference weights, skimage-style normalization."""
    grads = []
    for ax in range(data.ndim):
        grads.append(np.diff(data, axis=ax).ravel() ** 2)
    all_sq = np.hstack(grads)
    # skimage scales beta by 10 * std of the gradient magnitudes so the
    # parameter is intensity-range independent
    scale = 10.0 * np.sqrt(all_sq.std()) if all_sq.std() > 0 else 1.0
    weights = [np.exp(-beta * g / scale) + eps for g in grads]
    return weights


def _laplacian(data: np.ndarray, beta: float):
    """The graph Laplacian D - W, scipy.sparse CSR."""
    from scipy import sparse

    n = data.size
    idx = np.arange(n).reshape(data.shape)
    weights = _edge_weights(data.astype(np.float64), beta)
    rows, cols, vals = [], [], []
    for ax, w in enumerate(weights):
        sl_a = [slice(None)] * data.ndim
        sl_b = [slice(None)] * data.ndim
        sl_a[ax] = slice(0, -1)
        sl_b[ax] = slice(1, None)
        a = idx[tuple(sl_a)].ravel()
        b = idx[tuple(sl_b)].ravel()
        rows.append(a)
        cols.append(b)
        vals.append(w)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    W = sparse.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    ).tocsr()
    d = np.asarray(W.sum(axis=1)).ravel()
    return sparse.diags(d) - W


def random_walker(data: np.ndarray, markers: np.ndarray, beta: float = 100.0):
    """markers: 0 = unlabeled; 1..K = seed labels. Returns labels 1..K."""
    from scipy.sparse.linalg import spsolve

    data = np.asarray(data, dtype=np.float64)
    markers = np.asarray(markers)
    labels = np.unique(markers)
    labels = labels[labels > 0]
    if labels.size == 0:
        raise ValueError("random_walker needs at least one seed")
    if labels.size == 1:
        return np.full_like(markers, labels[0])

    L = _laplacian(data, beta).tocsr()
    unseeded = (markers == 0).ravel()
    seeded = ~unseeded
    if not unseeded.any():
        return markers.copy()

    L_uu = L[unseeded][:, unseeded]
    B = L[unseeded][:, seeded]
    m_seeded = markers.ravel()[seeded]

    probs = np.zeros((unseeded.sum(), labels.size))
    for i, lab in enumerate(labels[:-1]):
        rhs = -B @ (m_seeded == lab).astype(np.float64)
        probs[:, i] = spsolve(L_uu.tocsc(), rhs)
    probs[:, -1] = 1.0 - probs[:, :-1].sum(axis=1)

    out = markers.ravel().copy()
    out[unseeded] = labels[np.argmax(probs, axis=1)]
    return out.reshape(markers.shape)


def _rescale_intensity(img: np.ndarray, in_range, out_range):
    """skimage.exposure.rescale_intensity for explicit ranges."""
    lo, hi = in_range
    olo, ohi = out_range
    x = np.clip(img.astype(np.float64), lo, hi)
    return (x - lo) / (hi - lo) * (ohi - olo) + olo


def pseudo_label_generator_acdc(data: np.ndarray, seed: np.ndarray,
                                beta: float = 100.0) -> np.ndarray:
    """Scribble -> random-walker pseudo label for one ACDC slice.

    Parity (acdc_pseudo_label_random_walker.py:9-26): requires all three
    foreground scribble classes present (else all-zero); marker ids are
    scribble class + 1 with the unknown class (4) unseeded; intensities
    rescaled from (-0.35, 1.35) to (-1, 1); result shifted back by -1.
    """
    present = np.unique(seed)
    if 1 not in present or 2 not in present or 3 not in present:
        return np.zeros_like(seed)
    markers = np.ones_like(seed)
    markers[seed == 4] = 0
    for c in range(4):
        markers[seed == c] = c + 1
    sigma = 0.35
    scaled = _rescale_intensity(data, (-sigma, 1 + sigma), (-1, 1))
    segmentation = random_walker(scaled, markers, beta=beta)
    return (segmentation - 1).astype(seed.dtype)


def pseudo_label_generator_prostate(data: np.ndarray, seed: np.ndarray,
                                    beta: float = 100.0) -> np.ndarray:
    """Scribble -> random-walker pseudo label, Prostate variant.

    Parity (dataset_scribblevc.py:20-36): requires foreground classes 1 and
    2 present (else all-zero); markers seeded for classes {0, 1, 2} with the
    unknown class (4) unseeded; same intensity rescale as the ACDC variant.
    """
    present = np.unique(seed)
    if 1 not in present or 2 not in present:
        return np.zeros_like(seed)
    markers = np.ones_like(seed)
    markers[seed == 4] = 0
    for c in range(3):
        markers[seed == c] = c + 1
    sigma = 0.35
    scaled = _rescale_intensity(data, (-sigma, 1 + sigma), (-1, 1))
    segmentation = random_walker(scaled, markers, beta=beta)
    return (segmentation - 1).astype(seed.dtype)


def generate_pseudo_label_volumes(base_dir: str, out_key: str = "random_walker",
                                  limit: int | None = None) -> int:
    """Add a `random_walker` dataset to every bundled H5 slice/volume file.

    The H5 counterpart of the reference's NIfTI-to-NIfTI loop
    (acdc_pseudo_label_random_walker.py:44-59): the pseudo labels are
    written into (a copy of) the H5 tree so `sup_type="random_walker"`
    reads them.

    Returns the number of files augmented. Requires write access to
    base_dir (prepare_random_walker_tree builds a writable copy).
    """
    import glob
    import os

    import h5py

    n = 0
    files = sorted(glob.glob(os.path.join(base_dir, "ACDC_training_slices", "*.h5")))
    if limit:
        files = files[:limit]
    for path in files:
        with h5py.File(path, "r+") as f:
            if out_key in f:
                n += 1
                continue
            img = f["image"][:]
            scr = f["scribble"][:].astype(np.int32)
            pseudo = pseudo_label_generator_acdc(img, scr)
            f.create_dataset(out_key, data=pseudo.astype(np.uint8),
                             compression="gzip")
        n += 1
    return n


def prepare_random_walker_tree(src: str, out: str, *,
                               limit: int | None = None,
                               cases: list[str] | None = None) -> int:
    """Build a writable ACDC copy at ``out`` with ``random_walker`` keys.

    Equivalent of the reference's offline pseudo-label pass
    (acdc_pseudo_label_random_walker.py:44-59) over the H5 tree: copies
    slice/volume files from ``src`` (optionally only ``cases`` patients
    and/or the first ``limit`` slice files) and adds a ``random_walker``
    dataset to each. Volume files get the per-slice stack when every slice
    of the case was processed. Returns the number of slices solved.
    """
    import glob
    import shutil

    import h5py

    def _wanted(name: str) -> bool:
        return cases is None or name.split("_")[0] in set(cases)

    for sub in ("ACDC_training_slices", "ACDC_training_volumes"):
        src_sub = os.path.join(src, sub)
        out_sub = os.path.join(out, sub)
        os.makedirs(out_sub, exist_ok=True)
        names = sorted(f for f in os.listdir(src_sub) if _wanted(f))
        if sub.endswith("slices") and limit is not None:
            names = names[:limit]
        for name in names:
            dst = os.path.join(out_sub, name)
            if not os.path.exists(dst):
                shutil.copy(os.path.join(src_sub, name), dst)

    n = 0
    slice_files = sorted(
        glob.glob(os.path.join(out, "ACDC_training_slices", "*.h5"))
    )
    for path in slice_files:
        with h5py.File(path, "r+") as f:
            if out_key_missing := ("random_walker" not in f):
                img = f["image"][:]
                scr = f["scribble"][:].astype(np.int32)
                pseudo = pseudo_label_generator_acdc(img, scr)
                f.create_dataset("random_walker",
                                 data=pseudo.astype(np.uint8),
                                 compression="gzip")
        n += out_key_missing

    vol_files = sorted(
        glob.glob(os.path.join(out, "ACDC_training_volumes", "*.h5"))
    )
    for path in vol_files:
        case = os.path.basename(path).replace(".h5", "")
        with h5py.File(path, "r+") as f:
            if "random_walker" in f:
                continue
            stack = []
            for ind in range(f["image"].shape[0]):
                sp = os.path.join(
                    out, "ACDC_training_slices", f"{case}_slice_{ind}.h5"
                )
                if not os.path.exists(sp):
                    stack = None
                    break
                with h5py.File(sp, "r") as sf:
                    if "random_walker" not in sf:
                        stack = None
                        break
                    stack.append(sf["random_walker"][:])
            if stack is not None:
                f.create_dataset("random_walker", data=np.stack(stack),
                                 compression="gzip")
    return n
