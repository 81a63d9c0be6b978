"""Model factory (port of ``wsl4mis_tpu/models/factory.py``): the 2D zoo
of the JAX package's ``net_factory`` and ScribbleVC, and ``init_model`` /
``apply_model``, the JAX package's functional calls over flax variable
trees."""

from __future__ import annotations

import functools

import torch

from ..utils.params import (
    flax_naming,
    load_flax_variables,
    to_flax,
    to_flax_variables,
)
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
    model = cls(num_classes=class_num, dtype=dtype, generator=generator,
                **kwargs)
    model.rebuild = functools.partial(net_factory, net_type, class_num,
                                      dtype, **kwargs)
    return model


def init_model(model, generator=None, input_shape=(1, 256, 256, 1)) -> dict:
    """Draw `model`'s parameters anew from `generator` (a CPU
    torch.Generator; None: the global one), with the initializers its
    construction used, in place (BN statistics back to 0 / 1), and return
    them as flax's {"params", "batch_stats"} trees of numpy arrays, the
    variables the JAX package's init_model gives and its apply_model takes.
    The model must come from net_factory or net_factory_3d (its `rebuild`).
    input_shape is the JAX signature's: the port's modules size their
    parameters at construction, so it is not read."""
    rebuild = getattr(model, "rebuild", None)
    if rebuild is None:
        raise TypeError(f"{type(model).__name__} was not built by "
                        f"net_factory / net_factory_3d: nothing to re-draw "
                        f"it with")
    model.load_state_dict(rebuild(generator=generator).state_dict())
    return to_flax_variables(model)


def apply_model(model, variables, x, *, train: bool, generator=None):
    """`model` with flax `variables` ({"params", "batch_stats"}, loaded into
    it, strictly) on x: the outputs; with train=True, (outputs,
    {"batch_stats": the updated statistics}) as flax's mutable apply
    returns them (the model keeps them too). generator: the train-mode
    draws (dropout, feature perturbation), as rngs["dropout"] and
    rngs["feature_perturb"]."""
    load_flax_variables(model, variables)
    kwargs = {}
    if generator is not None:
        kwargs["rngs"] = {"dropout": generator, "feature_perturb": generator}
    out = model(x, train=train, **kwargs)
    if not train:
        return out
    return out, {"batch_stats": to_flax(dict(model.named_buffers()),
                                        flax_naming(model))}
