"""efficientnet_pytorch weights for the EfficientNet encoder (port of
``wsl4mis_tpu/utils/torch_import.py``).

The reference loads ImageNet encoder weights (net_factory.py:16); offline,
a locally downloaded efficientnet_pytorch ``state_dict`` converts to the
flax parameter subtrees of ``EfficientNetEncoder_0``, the same subtrees
the JAX package's converter makes, so that one converted file (the
``convert_torch_weights`` command's flax msgpack: ``encoder_params``,
``encoder_batch_stats``, ``in_channels``) serves either package.

Key names (efficientnet_pytorch): ``_conv_stem.weight``, ``_bn0.*``;
``_blocks.{i}._expand_conv.weight`` and ``_bn0.*`` (expand ratio != 1),
``._depthwise_conv.weight``, ``_bn1.*``, ``._se_reduce|_se_expand.{weight,
bias}``, ``._project_conv.weight``, ``_bn2.*``; the head (``_conv_head``,
``_bn1``, ``_fc``) is not used by the encoder's taps and is ignored.

The stem is patched for other input channels as the reference's
patch_first_conv (efficient_encoder.py:36-66): 1 sums the RGB filters, 2
scales the first two by 3/2, more than 3 keeps the model's own init.
"""

from __future__ import annotations

import numpy as np

from ..models.efficientunet import (
    BASE_BLOCKS,
    SCALING,
    round_filters,
    round_repeats,
)
from .params import _flatten, zoo_key

ENCODER_SCOPE = "EfficientNetEncoder_0"


def _conv_w(w) -> np.ndarray:
    """torch (O, I, kh, kw) -> flax (kh, kw, I, O)."""
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def _bn(sd, prefix):
    return ({"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
             "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)},
            {"mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
             "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)})


def convert_efficientnet_encoder(state_dict, model_name: str,
                                 in_channels: int = 1):
    """(params, batch_stats) of ``EfficientNetEncoder_0`` in flax's tree
    from an efficientnet_pytorch state_dict (tensors or arrays). Raises
    KeyError on a missing key and ValueError when the file's block count
    or stem width is not `model_name`'s."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    width, depth, _ = SCALING[model_name]
    n_blocks = sum(round_repeats(r, depth) for *_, r in BASE_BLOCKS)
    got = {int(k.split(".")[1]) for k in sd if k.startswith("_blocks.")}
    if got and max(got) + 1 != n_blocks:
        raise ValueError(f"state_dict has {max(got) + 1} blocks but "
                         f"{model_name} defines {n_blocks}: wrong "
                         "model_name for this file?")
    params: dict = {}
    stats: dict = {}
    w = sd["_conv_stem.weight"]  # (O, 3, 3, 3)
    if in_channels == 1:
        w = w.sum(axis=1, keepdims=True)
    elif in_channels == 2:
        w = w[:, :2] * (3.0 / 2.0)
    elif in_channels != 3:
        w = None  # the reference re-inits it: keep the model's
    if w is not None:
        params["Conv_0"] = {"kernel": _conv_w(w)}
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, "_bn0")

    bi = 0
    for e, _k, _s, _fin, _fout, r in BASE_BLOCKS:
        for _ in range(round_repeats(r, depth)):
            pre = f"_blocks.{bi}"
            convs = ([f"{pre}._expand_conv"] if e != 1 else []) + [
                f"{pre}._depthwise_conv", f"{pre}._se_reduce",
                f"{pre}._se_expand", f"{pre}._project_conv"]
            bns = ([f"{pre}._bn0"] if e != 1 else []) + [
                f"{pre}._bn1", f"{pre}._bn2"]
            bp: dict = {}
            bs: dict = {}
            for ci, name in enumerate(convs):
                bp[f"Conv_{ci}"] = {"kernel": _conv_w(sd[f"{name}.weight"])}
                if name.endswith(("_se_reduce", "_se_expand")):
                    bp[f"Conv_{ci}"]["bias"] = np.asarray(
                        sd[f"{name}.bias"], np.float32)
            for ni, name in enumerate(bns):
                bp[f"BatchNorm_{ni}"], bs[f"BatchNorm_{ni}"] = _bn(sd, name)
            params[f"MBConv_{bi}"], stats[f"MBConv_{bi}"] = bp, bs
            bi += 1

    stem_out = params["BatchNorm_0"]["scale"].shape[0]
    if stem_out != round_filters(32, width):
        raise ValueError(f"stem width {stem_out} != "
                         f"{round_filters(32, width)} expected for "
                         f"{model_name}")
    return params, stats


def merge_encoder_subtrees(variables, params, stats):
    """A copy of a flax variables dict ({"params", "batch_stats"} of an
    EffiUNet) with the encoder scope's leaves replaced by the converted
    subtrees; every converted leaf needs a target of the same shape, else
    ValueError."""
    scope = next(k for k in variables["params"]
                 if k.startswith("EfficientNetEncoder"))

    def merge(dst, src, path):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                raise ValueError(f"no target for converted {path}/{k}")
            if isinstance(v, dict):
                out[k] = merge(dst[k], v, f"{path}/{k}")
                continue
            cur = np.asarray(dst[k])
            if cur.shape != v.shape:
                raise ValueError(f"{path}/{k}: converted shape {v.shape} != "
                                 f"model shape {cur.shape}")
            out[k] = v.astype(cur.dtype)
        return out

    new = dict(variables)
    new["params"] = dict(variables["params"])
    new["params"][scope] = merge(variables["params"][scope], params, scope)
    if "batch_stats" in variables:
        new["batch_stats"] = dict(variables["batch_stats"])
        new["batch_stats"][scope] = merge(variables["batch_stats"][scope],
                                          stats, scope)
    return new


def load_pretrained_encoder(variables, state_dict, model_name: str,
                            in_channels: int = 1):
    """`variables` with its encoder replaced by the converted state_dict
    (convert_efficientnet_encoder, then merge_encoder_subtrees)."""
    params, stats = convert_efficientnet_encoder(state_dict, model_name,
                                                 in_channels)
    return merge_encoder_subtrees(variables, params, stats)


def load_encoder_weights(model, params, stats) -> None:
    """Copy converted encoder subtrees (flax layout, from
    convert_efficientnet_encoder or a converted file) into a port EffiUNet,
    in place, with the strict shape check of merge_encoder_subtrees: a
    leaf without a target of its shape raises ValueError."""
    import torch

    own = model.state_dict()
    updates = {}
    for collection in (params, stats):
        for path, value in _flatten(collection, (ENCODER_SCOPE,)):
            key = zoo_key(path)
            value = np.asarray(value, np.float32)
            if key not in own:
                raise ValueError(f"no target for converted {'/'.join(path)}")
            if tuple(own[key].shape) != value.shape:
                raise ValueError(f"{'/'.join(path)}: converted shape "
                                 f"{value.shape} != model shape "
                                 f"{tuple(own[key].shape)}")
            updates[key] = torch.from_numpy(value)
    with torch.no_grad():
        for key, value in updates.items():
            own[key].copy_(value)
