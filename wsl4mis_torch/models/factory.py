"""Model factory (port of ``wsl4mis_tpu/models/factory.py``): the 2D zoo
of the JAX package's ``net_factory`` and ScribbleVC."""

from __future__ import annotations

import torch

from .efficientunet import EffiUNet
from .pnet import PNet2D
from .scribblevc import ScribbleVC
from .unet import UNet, UNetCCT, UNetCCT3H, UNetDS, UNetURDS

_REGISTRY = {
    "unet": UNet,
    "unet_cct": UNetCCT,
    "unet_cct_3h": UNetCCT3H,
    "unet_ds": UNetDS,
    "unet_urds": UNetURDS,
    "pnet": PNet2D,
    "efficient_unet": EffiUNet,
    "scribblevc": ScribbleVC,
}

# Models whose train-mode forward draws from rngs["feature_perturb"].
PERTURBED_MODELS = {"unet_cct", "unet_cct_3h", "unet_urds", "pnet"}

# Outputs of each 2D model's forward (1: the logits alone).
MODEL_NUM_OUTPUTS = {
    "unet": 1,
    "unet_cct": 2,
    "unet_cct_3h": 3,
    "unet_ds": 4,
    "unet_urds": 4,
    "pnet": 1,
    "efficient_unet": 1,
}


def net_factory(net_type: str = "unet", class_num: int = 4,
                dtype=torch.bfloat16, generator=None, **kwargs):
    """Build the named model on the CPU (move it with .to(device)); its
    parameters draw from `generator` (a CPU torch.Generator).
    ``efficient_unet`` has the efficientnet-b3 encoder unless kwargs name
    another (net_factory.py:16)."""
    try:
        cls = _REGISTRY[net_type]
    except KeyError:
        raise KeyError(f"unknown net_type {net_type!r}; available: "
                       f"{sorted(_REGISTRY)}") from None
    if net_type == "efficient_unet":
        kwargs.setdefault("encoder_name", "efficientnet-b3")
    return cls(num_classes=class_num, dtype=dtype, generator=generator,
               **kwargs)
