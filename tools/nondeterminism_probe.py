#!/usr/bin/env python3
"""Which PyTorch op keeps a method's training steps from repeating bit for
bit on the card.

    python3 tools/nondeterminism_probe.py [--method scribblevc] [--seed N]

Run from the repository root on a machine with one CUDA card. The method
(one of chip_smoke.resume_runs(): fully_supervised, uamt,
deep_adversarial, s2l, scribblevc) is built at full width on chip_smoke's
phantoms and its cell's batch, under the train command's cuDNN setting
(--deterministic 1), and takes chip_smoke's steps before a checkpoint
(scribblevc: up to the step after its memory gate opens); its state is
saved. Then the next 2 steps run twice from that state and the states
after them are compared leaf by leaf: with PyTorch's deterministic
algorithms on, off, and on for every op but one, for each op (aten
overload packet) that one step dispatches. An op whose exclusion alone
makes the two runs differ is a source of the method's nondeterminism.
Prints one JSON line (the card, the ops and the leaves that differ in
each case).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="scribblevc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nondeterminism_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke as cs
    from wsl4mis_torch import cli
    from wsl4mis_torch.data import ArraySliceDataset, synthetic_slices
    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.methods.common import split_rngs
    from wsl4mis_torch.utils import checkpoint as ck

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cli.set_deterministic(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = {m: (model, batch, kind) for m, model, batch, kind in
            cs.resume_runs()}
    model_name, batch, kind = runs[args.method]
    hw = cs.HW
    if kind == "svc":
        data = synthetic_slices(cs.SVC_SLICES, (hw, hw), seed=args.seed + 2,
                                sup_type="scribble")
    else:
        dense = kind in ("dense", "semi")
        data = synthetic_slices(480, (hw, hw), seed=args.seed,
                                sup_type="label" if dense else "scribble")
        if kind == "semi":
            data = (ArraySliceDataset(data.images[:48], data.labels[:48]),
                    ArraySliceDataset(data.images[48:], data.labels[48:]))
    before = cs.RESUME_BEFORE
    flags = {}
    if args.method == "scribblevc":
        before = cs.svc_gate_step(len(data), batch) + 1
    if args.method == "s2l":
        flags = dict(thr_iter=before, thr_conf=0.04)
    snap = os.path.join(ROOT, "build", "nondeterminism_probe")
    cfg = TrainConfig(
        method=args.method, model=model_name, batch_size=batch,
        labeled_bs=batch // 2, max_iterations=100, compute_dtype="bfloat16",
        snapshot_root=snap, seed=args.seed, device="cuda",
        patch_size=(hw, hw), sup_type=cs.sup_type_of(args.method), **flags)
    bundle, new_batches = cs.method_bundle(cfg, data, None)
    it = new_batches()
    batches = [next(it) for _ in range(before + 2)]

    def take(ts):
        for t in ts:
            bundle.step_fn(bundle.state, batches[t],
                           split_rngs(cfg.seed, bundle.state.step, "cuda"),
                           bundle.aux)
        torch.cuda.synchronize()

    take(range(before))
    path = os.path.join(snap, "state.ckpt")
    ck.save_train_state(path, bundle.state)

    class Ops(TorchDispatchMode):
        """Records the ops dispatched; with `but`, runs every op under
        the deterministic algorithms except that one."""

        def __init__(self, but=None):
            super().__init__()
            self.but, self.seen = but, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.seen.add(name)
            if self.but is None:
                return func(*args, **(kwargs or {}))
            torch.use_deterministic_algorithms(name != self.but,
                                               warn_only=True)
            try:
                return func(*args, **(kwargs or {}))
            finally:
                torch.use_deterministic_algorithms(True, warn_only=True)

    def differing(mode=None, deterministic=False):
        """Leaves that differ between two runs of the next 2 steps."""
        out = []
        for _ in range(2):
            ck.restore_train_state(path, bundle.state)
            torch.use_deterministic_algorithms(deterministic,
                                               warn_only=True)
            try:
                if mode is None:
                    take(range(before, before + 2))
                else:
                    with mode:
                        take(range(before, before + 2))
            finally:
                torch.use_deterministic_algorithms(False)
            out.append(cs._snapshot(cs.state_leaves(bundle.state)))
        return len(cs.leaves_diff(*out)[0])

    seen = Ops()
    ck.restore_train_state(path, bundle.state)
    with seen:
        take([before])
    ops = sorted(seen.seen)
    rec = {"card": card, "method": args.method, "batch": batch,
           "steps_before": before, "ops": len(ops),
           "differing_all_deterministic": differing(deterministic=True),
           "differing_default": differing(deterministic=False)}
    rec["differing_all_but"] = {op: differing(Ops(op)) for op in ops}
    rec["sources"] = sorted(op for op, n in rec["differing_all_but"].items()
                            if n)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
