"""Device resolution: entry points run on the card unless asked otherwise;
a rank of a data-parallel run on its own card (``parallel.make_mesh`` makes
it the current one)."""

from __future__ import annotations

import torch

from .. import parallel


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own). Under a process
    group, "cuda" is the rank's card, the current one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None and parallel.active():
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a CUDA graph: a step
    then reads its per-step host values from the buffers the replay's
    caller fills (``engine.graph``), instead of filling them itself."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
