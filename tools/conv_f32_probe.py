#!/usr/bin/env python3
"""The f32 conv launches of one fully_supervised UNet b24 step, and that
step at --compute_dtype float32, timed on the card for the port of a given
tree, with this checkout's chip_smoke.py as the yardstick.

    python3 tools/conv_f32_probe.py [--tree DIR] [--no-cell] [--seed N]
        [--out FILE]

Run on a machine with one CUDA card. --tree names the root of the tree
whose wsl4mis_torch is timed (default: this checkout), e.g. a parent
unpacked with git archive under build/, so that two trees are timed in
turns in one call. The measurement is chip_smoke's own: check_conv(...,
"float32", timed=True, repeat=True) at each conv of the step (a failed
check raises), conv_step_sums over the step's launches (per role: call
ms, plain ms, bound ms, cuDNN with TF32 off and on), and, unless
--no-cell, f32_cell (eager steps and one captured call, bit-equal; ms/step,
device busy share, the conv kernels' traced ms a step). Prints one JSON
line ("conv-f32-probe ...") and writes every record to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the tree whose wsl4mis_torch to time")
    ap.add_argument("--no-cell", action="store_true",
                    help="time the launches only, not the f32 step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("conv_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    from wsl4mis_torch.data import synthetic_slices
    from wsl4mis_torch.ops import _build

    if not os.path.realpath(_build.__file__).startswith(
            os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_all()
    out = {"tree": tree, "card": card, "build_s": time.perf_counter() - t0}
    recs = []
    for name, c, o, h in cs.unet_convs():
        recs += cs.check_conv(name, c, o, h, "float32", cs.N, timed=True,
                              repeat=True)
    out["sums"] = cs.conv_step_sums(recs, "float32")
    if not args.no_cell:
        data = synthetic_slices(480, (cs.HW, cs.HW), seed=args.seed)
        out["cell"] = cs.f32_cell(args.seed, data, card,
                                  out["sums"]["all"]["bound_ms"])
    out["s"] = time.perf_counter() - t0
    line = {k: v for k, v in out.items() if k != "cell"}
    if "cell" in out:
        line["cell"] = {part: {k: out["cell"][part][k] for k in (
            "ms_per_step", "device_busy_ms_per_step", "device_busy_share",
            "conv_ms_per_step")} for part in ("eager", "captured")}
    print("conv-f32-probe " + json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**out, "checks": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
