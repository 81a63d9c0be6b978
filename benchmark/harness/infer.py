"""Validation cells: the Trainer's validation pass, ``VolumePredictor.
predict_volumes`` over a fold's validation volumes, repeated.

A run:

1. set-up: the volumes (phantoms from the seed, made on the device and
   handed to the predictor as host arrays, as the Trainer hands it the
   val set), the benchmark's weights with BN statistics set from one
   batch (an untrained network's running statistics would leave its
   logits at the scale of its biases), the model in the served dtype,
   the predictor at its defaults; two passes warm it (the first stacks,
   zooms and caches the device chunks, as the first validation of a run
   does);
2. a calibration pass sets the number of passes so that the window lasts
   about --seconds;
3. the window: that many passes; ``infer_slices_per_s`` counts the real
   (unpadded) slices predicted over its wall time; the class maps of two
   passes drawn from the seed and of the last are kept;
4. with --trace 1, a traced segment of ``traced_passes``;
5. the peak memory is read, the program freed, and the reference runs
   each volume in f32 and judges every kept class map by its logits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import check, inputs, trace as tr, work
from .common import (Result, free, load_weights, marker, peak_bytes,
                     reset_peak, sync)

STATS_SLICES = 32
SAMPLED = 2  # kept passes drawn from the seed among the first eight


def padded_chunks(traffic) -> int:
    """Chunks a pass runs: each volume padded to the bucket, the stack to
    the chunk."""
    d, b, c = traffic["depth"], traffic["bucket"], traffic["chunk"]
    per_volume = -(-d // b) * b
    total = traffic["volumes"] * per_volume
    return -(-total // max(b, c))


class Setup:
    def __init__(self, cell, seed, device, mark=None):
        from wsl4mis_torch.engine.config import TrainConfig
        from wsl4mis_torch.engine.methods.common import make_model_and_state
        from wsl4mis_torch.eval.val2d import VolumePredictor

        from reference.infer import zoom

        mark = mark or (lambda name: None)
        mark("program imported")
        t, c = cell.traffic, cell.config
        self.cell, self.seed, self.device = cell, seed, device
        n, d, h, w = t["volumes"], t["depth"], t["height"], t["width"]
        images, _ = inputs.phantoms(seed, "volumes", n * d, h, w, device)
        self.volumes = list(images.view(n, d, h, w).cpu().numpy())
        self.reference = cell.reference_model()
        self.leaves = self.reference.leaves(c)
        self.weights = inputs.weights(self.leaves, seed, device)
        stats_x = zoom(images[:STATS_SLICES], c["patch_size"])[..., None]
        self.reference.stats_pass(self.weights, stats_x, c)
        del images, stats_x  # the program's peak holds none of them
        mark("inputs and weights")
        reset_peak(device)
        cfg = TrainConfig(model=c["model"], num_classes=c["class_num"],
                          patch_size=tuple(c["patch_size"]), seed=seed,
                          compute_dtype=t["compute_dtype"], device=device)
        model, _ = make_model_and_state(cfg, model_name=c["model"])
        load_weights(model, self.weights)
        self.predictor = VolumePredictor(model, c["patch_size"],
                                         device=device, bucket=t["bucket"],
                                         chunk=t["chunk"])
        mark("program objects")
        for _ in range(2):
            self.predictor.predict_volumes(self.volumes)

    def passes(self, n: int, keep=()) -> tuple[float, dict]:
        """Wall seconds of n passes, and the class maps of the passes in
        `keep` (and of the last)."""
        kept = {}
        sync(self.device)
        t0 = time.perf_counter()
        for i in range(n):
            preds = self.predictor.predict_volumes(self.volumes)
            if i in keep or i == n - 1:
                kept[i] = preds
        sync(self.device)
        return time.perf_counter() - t0, kept

    def release(self) -> None:
        self.predictor = None
        free(self.device)

    def image(self, v: int) -> torch.Tensor:
        """Volume v on the device, from the host arrays the program was
        given."""
        return torch.from_numpy(self.volumes[v]).to(self.device)

    def judge(self, kept: dict, precision: str = "float32") -> tuple:
        """(widest logit gap over every kept class map, [(pass, volume,
        gap)])."""
        from reference.infer import volume_logits
        from reference.layers import Precision

        rows = []
        for v in range(len(self.volumes)):
            logits = volume_logits(self.reference, self.weights,
                                   self.image(v), self.cell.config,
                                   Precision(precision))
            for i, preds in kept.items():
                pred = torch.as_tensor(np.asarray(preds[v]),
                                       device=self.device)
                rows.append((i, v, check.logit_gap(logits, pred)))
            del logits
        return max(g for _, _, g in rows), rows


def sampled_passes(seed: int) -> set:
    rng = np.random.Generator(np.random.PCG64(inputs.seed_of(seed, "kept")))
    return set(int(i) for i in rng.choice(8, SAMPLED, replace=False))


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device, snapshot_root: str, marks: list) -> Result:
    t, c = cell.traffic, cell.config
    mark = marker(marks, t_start)
    s = Setup(cell, seed, device, mark)
    mark("warm passes")
    per_pass, _ = s.passes(1)
    mark("calibration")
    n = max(1, int(round(seconds / per_pass)))
    setup_s = time.time() - t_start
    window_s, kept = s.passes(n, keep=sampled_passes(seed))
    peak = peak_bytes(device)
    traced = None
    if trace:
        traced = tr.traced(lambda: s.passes(1),
                           lambda: s.passes(t["traced_passes"]), device)
    s.release()

    gap, rows = s.judge(kept)
    numbers = {"logit_gap": gap}
    ok, checks = check.verdict(numbers, cell.limits)
    limit = cell.limits.get("logit_gap", {}).get("limit")
    failed = sum(1 for _, _, g in rows if limit is None or not g <= limit)
    real = t["volumes"] * t["depth"]
    chunks = padded_chunks(t)
    dtype = t["compute_dtype"]
    context = {
        "window_s": window_s, "units": n,
        "work": real * s.reference.forward_flops(c),
        "peak_flops": work.PEAK_FLOPS[dtype],
        "conv_bound_s": chunks * work.launches_bound_s(
            s.reference.conv_launches(c, t["chunk"], dtype, False), dtype),
        "trace": traced, "traced_units": t["traced_passes"],
        "setup_marks": marks,
    }
    return Result(
        correct=ok, attempted=n * t["volumes"], failed=failed,
        end_to_end={"infer_slices_per_s": n * real / window_s,
                    "setup_s": setup_s},
        context=context, memory_peak_bytes=peak, checks=checks,
        numbers=numbers, trace=traced)
