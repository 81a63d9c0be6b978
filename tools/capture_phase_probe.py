#!/usr/bin/env python3
"""chip_smoke's phase 10 runs of captured calls, without the other phases.

    python3 tools/capture_phase_probe.py [--methods m1,m2] [--no-remat]
        [--seed N] [--out FILE]

Run from the repository root on a machine with one CUDA card. Builds the
kernels, chip_smoke's phase-3 phantoms (256x256, bf16), then for each
named method (default: all 17) chip_smoke.capture_run at its phase-3 cell
with the start and calls of capture_spec (s2l and scribblevc across their
gates, ustm over 12 steps and four rotations), and the remat part
(chip_smoke.remat_part). The train command's captured run and the
profile-steps check need phase 5's eager Dice and are left to chip_smoke.
Prints chip_smoke's captured-run lines and one JSON line of the phase's
records (also written to --out); a failed check raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--methods", default=None,
                    help="comma-separated methods (default: all 17)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "chip_smoke", "capture_phase_probe.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("capture_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from wsl4mis_torch.data import (
        ArraySliceDataset,
        synthetic_slices,
        synthetic_volumes,
    )
    from wsl4mis_torch.data.random_walker import pseudo_label_generator_acdc
    from wsl4mis_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_all()
    seed = args.seed
    data = synthetic_slices(480, (cs.HW, cs.HW), seed=seed)
    scribbles = synthetic_slices(480, (cs.HW, cs.HW), seed=seed,
                                 sup_type="scribble")
    val = synthetic_volumes(2, 10, 216, 256, seed=seed + 1)
    rw = np.stack([pseudo_label_generator_acdc(im, sc) for im, sc in zip(
        scribbles.images[:cs.RW_SLICES], scribbles.labels[:cs.RW_SLICES])])
    datasets = {"dense": data, "scribble": scribbles,
                "random_walker": ArraySliceDataset(
                    scribbles.images[:cs.RW_SLICES], rw),
                "semi": (ArraySliceDataset(data.images[:48],
                                           data.labels[:48]),
                         ArraySliceDataset(data.images[48:],
                                           data.labels[48:])),
                "svc": synthetic_slices(cs.SVC_SLICES, (cs.HW, cs.HW),
                                        seed=seed + 2, sup_type="scribble")}
    wanted = None if args.methods is None else set(args.methods.split(","))
    runs = []
    for method, model_name, batch, key in cs.CAPTURE_RUNS:
        if wanted is not None and method not in wanted:
            continue
        runs.append(cs.capture_run(
            method, model_name, batch, datasets[key], seed, "cuda", cs.HW,
            **cs.capture_spec(method, batch, seed, len(datasets[key]))))
        torch.cuda.empty_cache()
    remat = None if args.no_remat else cs.remat_part(
        seed, datasets["svc"], val, "cuda", cs.HW)
    out = {"runs": runs, "remat": remat, "s": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("capture-probe " + json.dumps(
        {"runs": [{k: r[k] for k in ("method", "variants", "graphs",
                                      "leaves_differing", "metrics_differing",
                                      "eager_ms_per_step",
                                      "captured_ms_per_step", "capture_s",
                                      "run_s")} for r in runs],
         "remat": remat and {"cells": [{k: v for k, v in c.items()
                                        if k not in ("launches", "expected")}
                                       for c in remat["cells"]],
                             "cli_leaves_differing":
                             remat["cli"]["leaves_differing"]},
         "s": out["s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
