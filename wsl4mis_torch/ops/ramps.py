"""Consistency-weight ramp schedules (port of ``wsl4mis_tpu/ops/ramps.py``);
host-side floats."""

from __future__ import annotations

import numpy as np


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 * (1 - t)^2) with t = clip(current, 0, length) / length."""
    if rampup_length == 0:
        return 1.0
    current = np.clip(current, 0.0, rampup_length)
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return float(np.clip(current, 0.0, rampup_length) / rampup_length)


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    if not 0 <= current <= rampdown_length:
        raise ValueError(f"cosine_rampdown: {current} outside "
                         f"[0, {rampdown_length}]")
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))
