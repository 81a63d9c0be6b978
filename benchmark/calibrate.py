#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the
card, at the cell's own size:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--modes program,control,half,...] [--out FILE]

For each seed and mode, one JSON line of the numbers ``correct`` compares:

* ``program``: the program as a run drives it (training: set-up and the
  first steps through the Trainer's call; validation: a few passes), the
  reference followed in f32; the lower readings;
* ``control``: the reference in the program's place, computed a step
  below the cell's precision (bfloat16 -> fp8 operands, float32 -> TF32);
* a fault of ``faults.py`` planted under the program (training: half;
  validation: half, altered). A state left unchanged reads 1 in grad
  and change by their measure and needs no run.

The benchmark's own runs do not run this. Readings go to standard output
and, with --out, to a file; a summary (each number's largest program
reading and smallest reading of each other mode) ends the output.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LOWER = {"bfloat16": "fp8", "float32": "tf32"}
PASSES = 3


def readings(cell, seed, mode, device, root=ROOT):
    """The numbers `correct` compares, for one seed and mode, on `device`
    (the card; the CPU tests call it on the CPU)."""
    import contextlib

    import faults
    from harness import check, infer, train

    kind = cell.traffic["kind"]
    lower = LOWER[cell.traffic["compute_dtype"]]
    plant = (contextlib.nullcontext() if mode in ("program", "control")
             else faults.planted(kind, mode))
    with plant:
        if kind == "train":
            s = train.Setup(cell, seed, device,
                            train.snapshot_root(root, cell))
            if mode == "control":  # the batches the program would take
                s.take_batches()
            else:
                prog = s.first_steps()
        else:
            s = infer.Setup(cell, seed, device)
            kept = (s.passes(PASSES, keep=range(PASSES))[1]
                    if mode != "control" else None)
        s.release()
    if kind == "train":
        if mode == "control":
            prog = s.follow(lower)
        return check.training_numbers(prog, s.follow())
    if kept is None:
        from reference.infer import volume_logits
        from reference.layers import Precision

        kept = {0: [volume_logits(s.reference, s.weights, s.image(v),
                                  cell.config, Precision(lower)
                                  ).argmax(-1).cpu().numpy()
                    for v in range(len(s.volumes))]}
    return {"logit_gap": s.judge(kept)[0]}


def summary(lines):
    out = {}
    for ln in lines:
        for k, v in ln["numbers"].items():
            if k.startswith("_"):
                continue
            key = (ln["mode"], k)
            pick = max if ln["mode"] == "program" else min
            out[key] = v if key not in out else pick(out[key], v)
    return {f"{m}:{k}": v for (m, k), v in sorted(out.items())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run

    run.environment(ROOT)
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: limits are set from readings on the card, and "
              "this machine has none", file=sys.stderr)
        return 3
    cell = spec.find_cell(args.workload, ROOT)
    lines = []
    for mode in args.modes.split(","):
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.time()
            numbers = readings(cell, seed, mode, "cuda")
            ln = {"workload": cell.name, "seed": seed, "mode": mode,
                  "seconds": time.time() - t0, "numbers": numbers}
            lines.append(ln)
            text = json.dumps(ln)
            print("reading " + text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    print("summary " + json.dumps(summary(lines)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
