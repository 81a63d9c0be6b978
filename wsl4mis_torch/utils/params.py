"""Bridge from the JAX package's flax variables to the port's modules.

The flax tree ``{"params": ..., "batch_stats": ...}`` (nested dicts of
numpy arrays) of a UNet, UNetCCT or FCDiscriminator maps onto the port's
state_dict by renaming alone: both store conv kernels HWIO, transposed-conv
kernels (2,2,C,O), dense kernels (in, out) and BN scale/bias/mean/var in
f32.

    Encoder_0 / ConvBlock_i            -> encoder.blocks.i
    Decoder_0 | main_decoder | aux_decoder1 | aux_decoder2 -> the same
                                          names (Decoder_0: decoder)
    DecoderDS_0 | DecoderURDS_0        -> decoder, its TorchConv_k
                                          (heads, in call order) heads.k
    UpBlock_i                          -> ups.i
    UpBlock_i / ConvBlock_0            -> ups.i.block
    TorchConv_0 / Conv_0  (ConvBlock)  -> conv1      (Decoder: head)
    TorchConv_1 / Conv_0               -> conv2
    TorchConvTranspose_0 / ConvTranspose_0 -> up
    BatchNorm_0 | BatchNorm_1          -> bn1 | bn2
    _Conv4x4s2_i / Conv_0  (FCDiscriminator) -> convs.i
    Dense_0                            -> dense

A ScribbleVC tree maps by its own renaming (``scribblevc_key``, which the
model class names as its ``flax_key``), in flax's layouts too: a wrapper scope and the flax module
inside it are one module of the port (``Conv_k / Conv_0``, ``BN_k /
BatchNorm_0``, ``Dense_k / Dense_0``, ``conv_cls_conv / Conv_0``,
``trans_cls_head / Dense_0``), and

    Conv_k | BN_k | BatchNorm_k | Dense_k | LayerNorm_k -> convk | bnk | bnk | densek | normk
    TokenAttention_0 | Mlp_0 | TransBlock_0 -> attn | mlp | trans_block
    FCUDown_0 | FCUUp_0                -> fcu_down | fcu_up
    at the top: Conv_0 -> patch_embed, Conv_1 -> seg_head,
    Conv_2..Conv_5 -> trans_up.0..3, Conv_6 -> trans_head,
    UNetUpBilinear_i -> ups.i

Its ``class_memory`` collection loads into a memory dict of the model
(``ScribbleVC.init_memory``).

PNet2D, EffiUNet, the 3D nets and the legacy GAN map by ``zoo_key``:
their port modules mirror flax's module tree, each kind of submodule a
list in call order named after the kind (DHWIO kernels for the 3D nets,
(k, k, 1, C) for depthwise convs, as flax stores them).
"""

from __future__ import annotations

import re

import numpy as np
import torch

_DECODERS = {"Decoder_0": "decoder", "main_decoder": "main_decoder",
             "aux_decoder1": "aux_decoder1", "aux_decoder2": "aux_decoder2"}
_DS_DECODERS = ("DecoderDS_0", "DecoderURDS_0")


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
        elif p in _DS_DECODERS:
            out.append("decoder")
            kind = "ds_decoder"
        elif p.startswith("TorchConv_") and parent == "ds_decoder":
            out += ["heads", p.split("_")[1]]
            i += 1  # the nested Conv_0
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


_SVC_WRAPPED = {"Conv_0", "BatchNorm_0", "Dense_0"}
_SVC_WRAPPER = re.compile(
    r"^((Conv|BN|Dense)_\d+|conv_cls_conv|trans_cls_head)$")
_SVC_NAMES = {"TokenAttention_0": "attn", "Mlp_0": "mlp",
              "TransBlock_0": "trans_block", "FCUDown_0": "fcu_down",
              "FCUUp_0": "fcu_up"}
_SVC_TOP = {"Conv_0": "patch_embed", "Conv_1": "seg_head",
            "Conv_2": "trans_up.0", "Conv_3": "trans_up.1",
            "Conv_4": "trans_up.2", "Conv_5": "trans_up.3",
            "Conv_6": "trans_head"}
_SVC_INDEXED = {"Conv": "conv", "BN": "bn", "BatchNorm": "bn",
                "Dense": "dense", "LayerNorm": "norm"}


def scribblevc_key(path: tuple[str, ...]) -> str:
    out: list[str] = []
    for i, p in enumerate(path):
        if i > 0 and p in _SVC_WRAPPED and _SVC_WRAPPER.match(path[i - 1]):
            continue  # the flax module inside a wrapper scope
        if i == 0 and p in _SVC_TOP:
            out.append(_SVC_TOP[p])
        elif p.startswith("UNetUpBilinear_"):
            out += ["ups", p.split("_")[1]]
        elif p in _SVC_NAMES:
            out.append(_SVC_NAMES[p])
        elif "_" in p and p.rsplit("_", 1)[0] in _SVC_INDEXED:
            kind, k = p.rsplit("_", 1)
            out.append(_SVC_INDEXED[kind] + k)
        else:
            out.append(p)
    return ".".join(out)


_WRAPPERS = {"TorchConv", "DilatedConv", "Conv3", "_Conv"}
_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _snake(kind: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", kind).strip("_").lower()


def zoo_key(path: tuple[str, ...]) -> str:
    """The renaming of PNet2D, EffiUNet, the 3D nets and the legacy GAN,
    whose port modules hold their submodules in lists named after flax's
    module kinds, in flax's call order: ``Kind_k`` -> ``kind.k`` (snake
    case: PNetBlock_2 -> pnet_block.2, BatchNorm_1 -> batch_norm.1,
    UnetUp3CT_0 -> unet_up3_ct.0, _Conv_3 -> conv.3); the flax conv inside
    a wrapper scope (TorchConv_k / Conv_0, DilatedConv_k / Conv_0, Conv3_k
    / Conv_0, _Conv_k / Conv_0) is that one module of the port."""
    out: list[str] = []
    for i, p in enumerate(path):
        m = _INDEXED.match(p)
        if (p == "Conv_0" and i > 0
                and (_INDEXED.match(path[i - 1]) or [None, None])[1]
                in _WRAPPERS):
            continue
        out += [_snake(m[1]), m[2]] if m else [p]
    return ".".join(out)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables_np, key=None) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree of numpy arrays -> state_dict,
    each flax path renamed by `key` (default: the UNet / UNetCCT /
    FCDiscriminator renaming)."""
    key = key or _torch_key
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(dict(variables_np.get(collection, {}))):
            state[key(path)] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return state


def load_flax_variables(model: torch.nn.Module, variables_np,
                        memory: dict | None = None) -> None:
    """Fill `model` (UNet, UNetCCT, FCDiscriminator or ScribbleVC) from a
    flax variable tree; strict, so a missing or extra entry raises. With
    `memory` (a ScribbleVC memory dict), its tensors take the tree's
    class_memory collection, in place. A model class with a `flax_key`
    renames by it."""
    model.load_state_dict(
        from_flax(variables_np, getattr(model, "flax_key", None)),
        strict=True)
    if memory is not None:
        src = variables_np["class_memory"]
        if set(src) != set(memory):
            raise KeyError(f"class_memory {sorted(src)} != {sorted(memory)}")
        with torch.no_grad():
            for k, v in memory.items():
                v.copy_(torch.from_numpy(np.array(src[k], dtype=np.float32)))
