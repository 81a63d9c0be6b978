"""Intermediate-activation extraction (port of
``wsl4mis_tpu/utils/feature_extractor.py``; the reference's
HookBasedFeatureExtractor, networks/utils.py:401-445): forward hooks on
the model's named submodules record their outputs during one forward,
optionally nearest-resized to a target spatial size."""

from __future__ import annotations

import torch


def resize_nearest(x, size):
    """NHWC nearest resize to size (H, W), source index floor((i + 0.5) *
    in / out) as ``jax.image.resize``'s."""
    for axis, out in zip((1, 2), size):
        n = x.shape[axis]
        if n != out:
            idx = ((torch.arange(out, device=x.device) + 0.5) * (n / out)
                   ).floor().long().clamp(max=n - 1)
            x = x.index_select(axis, idx)
    return x


def extract_features(model, x, layer_name: str | None = None,
                     upscale_to=None, **forward_kwargs):
    """Run ``model(x, **forward_kwargs)`` recording submodule outputs.

    Returns (outputs, features): features maps each named submodule's path
    (``model.named_modules()``; the top module is not included) to its
    output, a tensor or a tuple of them, kept where `layer_name` is None
    or a substring of the path. With `upscale_to` (H, W), every 4D output
    is nearest-resized to it."""
    feats = {}
    handles = []

    def hook(name):
        def record(_module, _args, out):
            feats[name] = out
        return record

    for name, module in model.named_modules():
        if name and (layer_name is None or layer_name in name):
            handles.append(module.register_forward_hook(hook(name)))
    try:
        outputs = model(x, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    if upscale_to is not None:
        feats = {k: resize_nearest(v, upscale_to)
                 if isinstance(v, torch.Tensor) and v.ndim == 4 else v
                 for k, v in feats.items()}
    return outputs, feats
