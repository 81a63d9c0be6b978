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

The way back (``flax_naming``, ``to_flax``, ``to_flax_variables``), for
writing the port's state in the JAX package's layout: each renaming has
its inverse (``torch_path``, ``scribblevc_path``, ``zoo_path``), and every
path it gives is held to the forward renaming. UNet_DS and UNet_URDS name
their decoder's flax scope (``flax_decoder``); ``zoo_path`` knows the
module kinds of the 2D zoo (PNet2D, EffiUNet), the models a train state
holds.
"""

from __future__ import annotations

import re
from typing import Callable, NamedTuple

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


_DECODER_NAMES = {v: k for k, v in _DECODERS.items() if k != "Decoder_0"}


def torch_path(name: str, decoder: str = "Decoder_0") -> tuple[str, ...]:
    """The flax path that ``_torch_key`` renames to `name`; `decoder` is
    the model's decoder scope (Decoder_0, DecoderDS_0 or DecoderURDS_0)."""
    t = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(t):
        p = t[i]
        if p == "encoder":
            out.append("Encoder_0")
        elif p == "decoder":
            out.append(decoder)
        elif p in _DECODER_NAMES:
            out.append(p)
        elif p in ("blocks", "ups", "heads", "convs") and i + 1 < len(t):
            k = t[i + 1]
            out += {"blocks": [f"ConvBlock_{k}"], "ups": [f"UpBlock_{k}"],
                    "heads": [f"TorchConv_{k}", "Conv_0"],
                    "convs": [f"_Conv4x4s2_{k}", "Conv_0"]}[p]
            i += 1
        elif p == "block":
            out.append("ConvBlock_0")
        elif p == "head":
            out += ["TorchConv_0", "Conv_0"]
        elif p in ("conv1", "conv2"):
            out += [f"TorchConv_{int(p[-1]) - 1}", "Conv_0"]
        elif p == "up":
            out += ["TorchConvTranspose_0", "ConvTranspose_0"]
        elif p in ("bn1", "bn2"):
            out.append(f"BatchNorm_{int(p[-1]) - 1}")
        elif p == "dense":
            out.append("Dense_0")
        else:
            out.append(p)
        i += 1
    return tuple(out)


_SVC_TOP_NAMES = {v: k for k, v in _SVC_TOP.items()}
_SVC_KINDS = {v: k for k, v in _SVC_NAMES.items()}
_SVC_NUMBERED = re.compile(r"^(conv|bn|dense|norm)(\d+)$")


def scribblevc_path(name: str) -> tuple[str, ...]:
    """The flax path that ``scribblevc_key`` renames to `name`: convk, bnk
    and densek are wrapper scopes (Conv_k / Conv_0, BN_k / BatchNorm_0,
    Dense_k / Dense_0) except in a UNetUpBilinear, whose Conv_k and
    BatchNorm_k are flax's own modules."""
    t = name.split(".")
    if ".".join(t[:2]) in _SVC_TOP_NAMES:
        return (_SVC_TOP_NAMES[".".join(t[:2])], *t[2:])
    if t[0] in _SVC_TOP_NAMES:
        return (_SVC_TOP_NAMES[t[0]], *t[1:])
    out: list[str] = []
    in_up = False
    i = 0
    while i < len(t):
        p = t[i]
        m = _SVC_NUMBERED.match(p)
        if p == "ups" and i + 1 < len(t):
            out.append(f"UNetUpBilinear_{t[i + 1]}")
            in_up = True
            i += 1
        elif p in _SVC_KINDS:
            out.append(_SVC_KINDS[p])
        elif p == "conv_cls_conv":
            out += [p, "Conv_0"]
        elif p == "trans_cls_head":
            out += [p, "Dense_0"]
        elif m and m[1] == "norm":
            out.append(f"LayerNorm_{m[2]}")
        elif m and in_up:
            out.append({"conv": "Conv", "bn": "BatchNorm"}[m[1]] + f"_{m[2]}")
        elif m:
            kind, inner = {"conv": ("Conv", "Conv_0"),
                           "bn": ("BN", "BatchNorm_0"),
                           "dense": ("Dense", "Dense_0")}[m[1]]
            out += [f"{kind}_{m[2]}", inner]
        else:
            out.append(p)
        i += 1
    return tuple(out)


# the flax module kinds of the 2D zoo's zoo_key models (PNet2D, EffiUNet)
_ZOO_KINDS = {_snake(k): k for k in (
    "PNetBlock", "DilatedConv", "TorchConv", "BatchNorm", "Conv",
    "EfficientNetEncoder", "MBConv", "DecoderBlock")}


def zoo_path(name: str) -> tuple[str, ...]:
    """The flax path that ``zoo_key`` renames to `name` (a module of the
    2D zoo: ``kind.k`` -> ``Kind_k``, and a wrapper kind's inner Conv_0)."""
    t = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(t):
        p = t[i]
        if i + 1 < len(t) and t[i + 1].isdigit():
            if p not in _ZOO_KINDS:
                raise KeyError(f"{name!r}: no flax module kind for {p!r}")
            kind = _ZOO_KINDS[p]
            out.append(f"{kind}_{t[i + 1]}")
            if kind in _WRAPPERS:
                out.append("Conv_0")
            i += 1
        else:
            out.append(p)
        i += 1
    return tuple(out)


class FlaxNaming(NamedTuple):
    """A model's renaming both ways: key (flax path -> state_dict name)
    and path (its inverse)."""

    key: Callable[[tuple[str, ...]], str]
    path: Callable[[str], tuple[str, ...]]


def flax_naming(model: torch.nn.Module | None = None) -> FlaxNaming:
    """The renaming of `model` (None: the UNet / FCDiscriminator one)."""
    key = getattr(model, "flax_key", None)
    if key is None:
        decoder = getattr(model, "flax_decoder", "Decoder_0")
        return FlaxNaming(_torch_key,
                          lambda name: torch_path(name, decoder))
    inverse = {scribblevc_key: scribblevc_path, zoo_key: zoo_path}
    if key not in inverse:
        raise KeyError(f"{type(model).__name__}: no inverse of its flax "
                       f"renaming {key.__name__}")
    return FlaxNaming(key, inverse[key])


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
    state = {}
    for collection in ("params", "batch_stats"):
        state.update(named_from_flax(variables_np.get(collection, {}), key))
    return state


def named_from_flax(tree, key=None) -> dict[str, torch.Tensor]:
    """One collection's tree (params, or a tree of the params' structure:
    a momentum trace, Adam's moments, EMA params) -> f32 tensors by
    state_dict name."""
    key = key or _torch_key
    return {key(path): torch.from_numpy(np.array(value, dtype=np.float32))
            for path, value in _flatten(dict(tree or {}))}


def to_flax(named: dict[str, torch.Tensor],
            naming: FlaxNaming | None = None) -> dict:
    """Tensors by state_dict name -> a flax tree of numpy arrays (the
    inverse of named_from_flax). A name whose flax path the forward
    renaming does not take back to it raises KeyError naming it."""
    naming = naming or flax_naming()
    tree: dict = {}
    for name, t in named.items():
        path = naming.path(name)
        if naming.key(path) != name:
            raise KeyError(f"no flax path for {name!r} (tried "
                           f"{'/'.join(path)})")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(t.detach().cpu().numpy())
    return tree


def to_flax_variables(model: torch.nn.Module) -> dict:
    """The model as flax's {"params": ..., "batch_stats": ...} (its
    parameters; its buffers, the BN running statistics)."""
    naming = flax_naming(model)
    return {"params": to_flax(dict(model.named_parameters()), naming),
            "batch_stats": to_flax(dict(model.named_buffers()), naming)}


def check_keys(tree, keys, where: str) -> None:
    """`tree` must be a dict with exactly `keys`; else KeyError naming the
    missing and the left-over ones."""
    if not isinstance(tree, dict):
        raise KeyError(f"{where}: expected a dict with {sorted(keys)}, got "
                       f"{type(tree).__name__}")
    missing, extra = sorted(set(keys) - tree.keys()), sorted(
        tree.keys() - set(keys))
    if missing or extra:
        raise KeyError(f"{where}: missing {missing}, left over {extra}")


@torch.no_grad()
def copy_named(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor],
               where: str) -> None:
    """Copy `src` into the tensors of `dst` in place, strictly: a missing or
    left-over name, or a shape that differs, raises KeyError naming it."""
    check_keys(src, dst.keys(), where)
    for k, v in dst.items():
        if tuple(src[k].shape) != tuple(v.shape):
            raise KeyError(f"{where}: {k} has shape {tuple(src[k].shape)}, "
                           f"not {tuple(v.shape)}")
        v.copy_(src[k])


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
