"""Bridge from the JAX package's flax variables to the port's modules.

The flax tree ``{"params": ..., "batch_stats": ...}`` (nested dicts of
numpy arrays) of a UNet, UNetCCT or FCDiscriminator maps onto the port's
state_dict by renaming alone: both store conv kernels HWIO, transposed-conv
kernels (2,2,C,O), dense kernels (in, out) and BN scale/bias/mean/var in
f32.

    Encoder_0 / ConvBlock_i            -> encoder.blocks.i
    Decoder_0 | main_decoder | aux_decoder1 -> decoder | main_decoder | aux_decoder1
    UpBlock_i                          -> ups.i
    UpBlock_i / ConvBlock_0            -> ups.i.block
    TorchConv_0 / Conv_0  (ConvBlock)  -> conv1      (Decoder: head)
    TorchConv_1 / Conv_0               -> conv2
    TorchConvTranspose_0 / ConvTranspose_0 -> up
    BatchNorm_0 | BatchNorm_1          -> bn1 | bn2
    _Conv4x4s2_i / Conv_0  (FCDiscriminator) -> convs.i
    Dense_0                            -> dense
"""

from __future__ import annotations

import numpy as np
import torch

_DECODERS = {"Decoder_0": "decoder", "main_decoder": "main_decoder",
             "aux_decoder1": "aux_decoder1"}


def _torch_key(path: tuple[str, ...]) -> str:
    out: list[str] = []
    parent = None
    i = 0
    while i < len(path):
        p = path[i]
        kind = None
        if p == "Encoder_0":
            out.append("encoder")
            kind = "encoder"
        elif p in _DECODERS:
            out.append(_DECODERS[p])
            kind = "decoder"
        elif p.startswith("UpBlock_"):
            out += ["ups", p.split("_")[1]]
            kind = "up"
        elif p.startswith("ConvBlock_"):
            out += ["block"] if parent == "up" else ["blocks", p.split("_")[1]]
            kind = "block"
        elif p in ("TorchConv_0", "TorchConv_1"):
            if parent == "decoder":
                out.append("head")
            else:
                out.append("conv1" if p == "TorchConv_0" else "conv2")
            i += 1  # the nested Conv_0
        elif p == "TorchConvTranspose_0":
            out.append("up")
            i += 1  # the nested ConvTranspose_0
        elif p in ("BatchNorm_0", "BatchNorm_1"):
            out.append("bn1" if p == "BatchNorm_0" else "bn2")
        elif p.startswith("_Conv4x4s2_"):
            out += ["convs", p.split("_")[2]]
            i += 1  # the nested Conv_0
        elif p == "Dense_0":
            out.append("dense")
        else:
            out.append(p)
        parent = kind
        i += 1
    return ".".join(out)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables_np) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree of numpy arrays -> state_dict."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(dict(variables_np.get(collection, {}))):
            state[_torch_key(path)] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return state


def load_flax_variables(model: torch.nn.Module, variables_np) -> None:
    """Fill `model` (UNet, UNetCCT or FCDiscriminator) from a flax variable
    tree; strict, so a missing or extra entry raises."""
    model.load_state_dict(from_flax(variables_np), strict=True)
