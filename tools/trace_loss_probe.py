#!/usr/bin/env python3
"""How often a torch.profiler window loses kernel records on the card, and
whether chip_smoke's marked segment (``traced_window``) keeps them.

    python3 tools/trace_loss_probe.py [--windows 30] [--seed N]

Run from the repository root on a machine with one CUDA card. A
fully_supervised UNet at batch 24 (full width, bf16, chip_smoke's
phantoms) takes 8 steps a window, eagerly and as two captured 4-step calls
(engine.graph.CapturedStep), in `--windows` windows of each of two kinds:
plain (the profiler opened right before the steps) and marked (a padding
step, a marker kernel, the steps, a marker kernel, a padding step). Each
window's launches of the port's kernels, read from the trace
(chip_smoke.trace_launches), are held to per_step_counts x 8: the plain
window's whole trace, the marked window's segment between the markers and,
apart, its whole trace (10 steps). Prints one JSON line: the card, and per
mode the windows that lost records and the launches they read.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 8  # steps a window
K = 4  # steps a captured call


def _timed_events(prof):
    import torch

    return sorted((e.start_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_loss_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from wsl4mis_torch.data import synthetic_slices
    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.graph import CapturedStep
    from wsl4mis_torch.engine.methods.common import split_rngs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    data = synthetic_slices(4 * cs.N, (cs.HW, cs.HW), seed=args.seed)
    cfg = TrainConfig(method="fully_supervised", model="unet",
                      batch_size=cs.N, max_iterations=10 ** 4,
                      compute_dtype="bfloat16", seed=args.seed,
                      device="cuda", sup_type="label")
    bundle, new_batches = cs.method_bundle(cfg, data, None)
    state, step_fn, aux = bundle.state, bundle.step_fn, bundle.aux
    it = new_batches()
    batches = [next(it) for _ in range(K)]

    def eager(n):
        for i in range(n):
            step_fn(state, batches[i % K],
                    split_rngs(args.seed, state.step, "cuda"), aux)

    captured = CapturedStep(step_fn, state, aux, args.seed)
    captured(batches)
    eager(K)
    per = cs.per_step_counts("unet", "fully_supervised")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": card, "windows": args.windows, "steps": STEPS}
    for mode in ("eager", "captured"):
        if mode == "eager":
            fn, pad = (lambda: eager(STEPS)), (lambda: eager(1))
        else:
            fn = lambda: [captured(batches) for _ in range(STEPS // K)]  # noqa: E731
            pad = lambda: captured(batches[:1])  # noqa: E731
        plain, segment, whole = [], [], []
        for w in range(args.windows):
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
            got = cs.trace_launches([(n, 0) for _, n in _timed_events(prof)])
            if got != {k: v * STEPS for k, v in per.items()}:
                plain.append({"window": w, "launches": got})
            with profile(activities=activities) as prof:
                pad()
                torch.cuda.synchronize()
                torch.cuda._sleep(100)
                fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(100)
                pad()
                torch.cuda.synchronize()
            names = [n for _, n in _timed_events(prof)]
            marks = [i for i, n in enumerate(names)
                     if cs.MARKER_KERNEL in n]
            got = cs.trace_launches(
                [(n, 0) for n in names[marks[0] + 1:marks[-1]]])
            if len(marks) != 2 or got != {k: v * STEPS
                                           for k, v in per.items()}:
                segment.append({"window": w, "markers": len(marks),
                                "launches": got})
            got = cs.trace_launches([(n, 0) for n in names])
            if got != {k: v * (STEPS + 2) for k, v in per.items()}:
                whole.append({"window": w, "launches": got})
        out[mode] = {"plain_losing": plain, "segment_losing": segment,
                     "marked_whole_losing": whole}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
