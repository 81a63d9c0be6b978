#!/usr/bin/env python3
"""chip_smoke's phase 11 (host-fed batches and debug_nans), without the
other phases.

    python3 tools/device_data_probe.py [--methods m1,m2] [--seed N]
        [--out FILE]

Run from the repository root on a machine with one CUDA card. Builds the
kernels and chip_smoke's phase-3 phantoms (256x256, bf16), then runs
chip_smoke.device_data_phase over the named methods (default: all 17):
each method's host-fed steps, eager and captured, against its staged
steps; the train command with --device_data 0 --steps_per_call 4 (its
Dice held to phase 5's LEARN_RUNS bound only: the equality with phase 5's
eager run needs that run, which chip_smoke makes); two gloo ranks on
cuda:0 with device_data 0; debug_nans. Prints chip_smoke's
device-data-run, debug-nans and device_data lines and writes the phase's
records to --out; a failed check raises.
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "chip_smoke", "device_data_probe.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("device_data_probe: no CUDA device", file=sys.stderr)
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
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
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
    runs = tuple(r for r in cs.CAPTURE_RUNS
                 if wanted is None or r[0] in wanted)
    out = cs.device_data_phase(seed, datasets, val, card, None, runs=runs)
    out["s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"device-data-probe: {out['s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
