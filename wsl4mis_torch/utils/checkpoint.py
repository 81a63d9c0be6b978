"""Checkpoints under the reference names (port of
``wsl4mis_tpu/utils/checkpoint.py``), as ``torch.save`` files.

* inference checkpoints (``iter_N.pth``, ``{model}_best_model.pth``,
  ``iter_N_dice_D.pth``, ``{model}_{dice}_model.pth``): {"model":
  state_dict, "step"}, plus the ``state.extra`` entries the method's eval
  forward needs (``eval_extra``: ScribbleVC's ``class_memory``);
* ``latest_full.ckpt``: the full train state (model incl. BN running
  statistics, optimizer step count and momentum buffers, step, extra),
  which ``restore_train_state`` resumes from.

Writes go to a temporary file first and are renamed into place.

``load_model_checkpoint`` also reads the inference checkpoints the JAX
package writes under the same names (flax msgpack: params, batch_stats,
step and ScribbleVC's class_memory), through ``load_jax_checkpoint`` and
the flax bridge of ``utils.params``; the two formats are told apart by
the zip header every ``torch.save`` file starts with. ``msgpack`` is
imported only when a JAX file is read or written.

``save_flax_msgpack`` writes a tree of dicts of numpy arrays as flax's
``serialization.to_bytes`` does (the converted encoder weights
that either package reads).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .params import load_flax_variables

_TORCH_ZIP = b"PK\x03\x04"
_FLAX_NDARRAY, _FLAX_COMPLEX, _FLAX_NPSCALAR = 1, 2, 3  # flax's ext types


def _save(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_model_checkpoint(path: str, state, eval_extra=()) -> None:
    """eval_extra: keys of state.extra to save beside the model; a key
    missing from state.extra raises."""
    extra = state.extra or {}
    missing = [k for k in eval_extra if k not in extra]
    if missing:
        raise KeyError(f"eval_extra {missing} not in state.extra "
                       f"{sorted(extra)}")
    _save(path, {"model": state.model.state_dict(), "step": state.step,
                 **{k: extra[k] for k in eval_extra}})


def save_train_state(path: str, state) -> None:
    _save(path, state.state_dict())


def restore_train_state(path: str, state) -> None:
    """Load `path` into `state` (same method and config) in place."""
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.load_state_dict(payload)


def _flax_array(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: packb((shape, dtype name, C-order bytes));
    bfloat16 (which numpy lacks) widens exactly to float32."""
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    import msgpack

    if code == _FLAX_NDARRAY:
        return _flax_array(data)
    if code == _FLAX_NPSCALAR:
        return _flax_array(data)[()]
    if code == _FLAX_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack ext type {code} in a flax checkpoint")


def _flax_ndarray_bytes(x: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                         use_bin_type=True)


def _flax_ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_FLAX_NDARRAY, _flax_ndarray_bytes(x))
    raise TypeError(f"cannot write {type(x)} into a flax msgpack file")


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_flax_msgpack(path: str, tree: dict) -> None:
    """A nested dict (str keys) of numpy arrays (0-d for a scalar) as
    flax's msgpack: its ndarray ext type, each dict's keys in sorted order
    (flax's state dicts), so the bytes are the JAX package's
    save_checkpoint's."""
    import msgpack

    data = msgpack.packb(_sorted_tree(tree), default=_flax_ext_pack,
                         strict_types=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_jax_checkpoint(path: str) -> dict:
    """A checkpoint the JAX package wrote (flax msgpack) as nested dicts
    with numpy leaves. flax splits a leaf over 1 GiB into a chunk dict,
    which no inference checkpoint holds; it is returned as written."""
    import msgpack

    with open(path, "rb") as f:
        data = f.read()
    return msgpack.unpackb(data, ext_hook=_flax_ext, raw=False)


def load_model_checkpoint(path: str, model: torch.nn.Module,
                          state_extra: dict | None = None,
                          extra_optional: bool = False) -> int:
    """Load an inference checkpoint of either package into `model`
    (strict: a missing or extra entry raises) and return its step. The
    entries of `state_extra` (ScribbleVC's class_memory: a dict of
    tensors) take the file's values in place; the file must carry each,
    unless `extra_optional`, where one it lacks keeps its value."""
    with open(path, "rb") as f:
        magic = f.read(len(_TORCH_ZIP))
    extra = dict(state_extra or {})
    if magic == _TORCH_ZIP:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
        missing = sorted(extra.keys() - payload.keys())
        if extra_optional:
            extra = {k: v for k, v in extra.items() if k not in missing}
        elif missing:
            raise KeyError(f"{path} carries no {missing}")
        with torch.no_grad():
            for key, dst in extra.items():
                if dst.keys() != payload[key].keys():
                    raise KeyError(f"{key} {sorted(payload[key])} != "
                                   f"{sorted(dst)}")
                for k, v in dst.items():
                    v.copy_(payload[key][k])
        return int(payload["step"])
    tree = load_jax_checkpoint(path)
    memory = extra.pop("class_memory", None)
    if extra_optional and "class_memory" not in tree:
        memory = None
    if extra:
        raise KeyError(f"a JAX inference checkpoint carries no "
                       f"{sorted(extra)}")
    load_flax_variables(model, tree, memory=memory)
    return int(tree["step"])
