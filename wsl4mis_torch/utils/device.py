"""Device resolution: entry points run on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
