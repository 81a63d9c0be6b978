"""What the drivers of every kind of cell share."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def marker(marks: list, t_start: float):
    """A function that notes (name, seconds since t_start) in `marks`: the
    parts of set-up."""
    return lambda name: marks.append((name, time.time() - t_start))


def load_weights(model, weights: dict) -> None:
    """Copy the benchmark's weights into the program's model: the same
    names and shapes, or the configuration and the program disagree."""
    have = model.state_dict()
    if set(have) != set(weights):
        raise ValueError(
            f"the program's model and the configuration's reference differ: "
            f"only the program has {sorted(set(have) - set(weights))[:8]}, "
            f"only the reference {sorted(set(weights) - set(have))[:8]}")
    for k, v in weights.items():
        if tuple(have[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the program's shape {tuple(have[k].shape)}"
                             f", the configuration's {tuple(v.shape)}")
    model.load_state_dict({k: v.detach().clone() for k, v in
                           weights.items()})


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@dataclass
class Result:
    """A run's outcome: its verdict, counts, end-to-end values, what the
    per-layer readers read, and the numbers compared."""

    correct: bool
    attempted: int
    failed: int
    end_to_end: dict
    context: dict
    memory_peak_bytes: int
    checks: list = field(default_factory=list)
    numbers: dict = field(default_factory=dict)
    trace: object = None
