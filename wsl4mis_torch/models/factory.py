"""Model factory (port of ``wsl4mis_tpu/models/factory.py``).

This slice has UNet, UNet_CCT and ScribbleVC; the rest of the zoo is
ROADMAP Queue 1, item 14.
"""

from __future__ import annotations

import torch

from .scribblevc import ScribbleVC
from .unet import UNet, UNetCCT

_REGISTRY = {"unet": UNet, "unet_cct": UNetCCT, "scribblevc": ScribbleVC}
_NOT_YET = {"unet_cct_3h", "unet_ds", "unet_urds", "pnet", "efficient_unet"}


def net_factory(net_type: str = "unet", class_num: int = 4,
                dtype=torch.bfloat16, generator=None, **kwargs):
    """Build the named model on the CPU (move it with .to(device)); its
    parameters draw from `generator` (a CPU torch.Generator)."""
    if net_type in _NOT_YET:
        raise NotImplementedError(
            f"{net_type!r} is not ported yet (ROADMAP.md Queue 1, item 14)")
    try:
        cls = _REGISTRY[net_type]
    except KeyError:
        raise KeyError(f"unknown net_type {net_type!r}; available: "
                       f"{sorted(_REGISTRY)}") from None
    return cls(num_classes=class_num, dtype=dtype, generator=generator,
               **kwargs)
