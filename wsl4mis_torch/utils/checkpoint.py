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

The JAX package writes the same names as flax msgpack. The two formats
are told apart by the zip header every ``torch.save`` file starts with:
``load_model_checkpoint`` reads either package's inference checkpoints
(params, batch_stats, step and ScribbleVC's class_memory), and
``restore_train_state`` either package's ``latest_full.ckpt``, a JAX
run's through ``restore_jax_train_state`` (step, params, batch_stats, the
optax state and the method's extra; ``TrainState.load_jax_tree``), so a
run in flight in the JAX package continues in the port.
``save_jax_train_state`` writes the port's state in that layout, which
the JAX package's ``restore_train_state`` loads. ``msgpack`` is imported
only when a JAX file is read or written.

``save_checkpoint`` / ``load_checkpoint`` are the JAX package's pytree
checkpoints: ``save_checkpoint`` writes a tree of dicts (lists, tuples)
of numpy arrays or tensors as flax's ``serialization.to_bytes`` does,
leaves over ``MAX_CHUNK_BYTES`` split into flax's chunk dicts;
``load_jax_checkpoint`` reads such a file and joins them, and
``load_checkpoint`` also restores it into a target's structure.
"""

from __future__ import annotations

import mmap
import os

import numpy as np
import torch

from .params import load_flax_variables

_TORCH_ZIP = b"PK\x03\x04"
_FLAX_NDARRAY, _FLAX_COMPLEX, _FLAX_NPSCALAR = 1, 2, 3  # flax's ext types
# flax.serialization.MAX_CHUNK_SIZE: a leaf of more bytes is written as a
# chunk dict of flat pieces of this many bytes
MAX_CHUNK_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_ARRAY_HEAD = 1024  # bytes that hold an ndarray ext's shape and dtype


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


def _is_torch_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(_TORCH_ZIP)) == _TORCH_ZIP


def restore_train_state(path: str, state) -> str:
    """Load `path` (either package's full-state checkpoint, of the same
    method and config) into `state` in place; returns its format, "torch"
    or "jax"."""
    if not _is_torch_file(path):
        restore_jax_train_state(path, state)
        return "jax"
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.load_state_dict(payload)
    return "torch"


def restore_jax_train_state(path: str, state) -> None:
    """Load the JAX package's ``latest_full.ckpt`` into `state` in place."""
    state.load_jax_tree(load_jax_checkpoint(path))


def save_jax_train_state(path: str, state) -> None:
    """Write `state` as the JAX package's ``save_train_state`` does."""
    save_checkpoint(path, state.jax_tree())


def _flax_array(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: packb((shape, dtype name, C-order bytes));
    bfloat16 (which numpy lacks) widens exactly to float32. The bytes are
    the last of `data` and are read in place (one copy, the result's)."""
    import msgpack

    head = msgpack.Unpacker(raw=True)
    head.feed(data[:_ARRAY_HEAD])
    if head.read_array_header() != 3:
        raise ValueError("not a flax ndarray")
    shape, name = head.unpack(), head.unpack()
    bf16 = name == b"bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else name.decode())
    count = int(np.prod(shape))
    arr = np.frombuffer(data, dtype, count=count,
                        offset=len(data) - count * dtype.itemsize)
    if bf16:
        return (arr.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return arr.reshape(shape).copy()


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


class _Bf16(np.ndarray):
    """A bfloat16 tensor's bits (uint16), written as flax writes bfloat16."""


def _flax_ndarray_bytes(x: np.ndarray) -> bytes:
    import msgpack

    name = "bfloat16" if isinstance(x, _Bf16) else x.dtype.name
    data = memoryview(np.ascontiguousarray(x).reshape(-1).view(np.uint8))
    return msgpack.packb((x.shape, name, data), use_bin_type=True)


def _flax_ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_FLAX_NDARRAY, _flax_ndarray_bytes(x))
    raise TypeError(f"cannot write {type(x)} into a flax msgpack file")


def _state_dict(tree):
    """flax's to_state_dict of the JAX package's host tree (jax.tree.map
    of np.asarray): a dict's keys as str in sorted order, a list or tuple
    as {"0": ...} in order, None kept, every other leaf a numpy array (a
    tensor's on the host; bfloat16 as its bits)."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view(_Bf16)
        return t.numpy()
    return np.asarray(tree)


def _chunked(x: np.ndarray) -> dict:
    """flax's serialization._chunk: the flat array in pieces of
    MAX_CHUNK_BYTES (views), keyed "0".."n-1", with the shape."""
    size = max(1, MAX_CHUNK_BYTES // x.dtype.itemsize)
    flat = x.reshape(-1)  # keeps a _Bf16's tag on its pieces
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _write_tree(f, packer, tree) -> None:
    """packer.pack(tree) into `f` a dict entry at a time, a leaf over
    MAX_CHUNK_BYTES as its chunk dict (the bytes of flax's
    msgpack_serialize, without the whole file in memory)."""
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_BYTES:
        tree = _chunked(tree)
    if isinstance(tree, dict):
        f.write(packer.pack_map_header(len(tree)))
        for k, v in tree.items():
            f.write(packer.pack(k))
            _write_tree(f, packer, v)
    else:
        f.write(packer.pack(tree))


def save_checkpoint(path: str, tree) -> None:
    """`tree` (nested dicts, lists, tuples; numpy arrays, tensors, numbers
    or None) as the JAX package's save_checkpoint writes it: flax's msgpack
    of its state dict (_state_dict), a leaf over MAX_CHUNK_BYTES in
    flax's chunks, the same bytes; written to path + ".tmp" a dict entry
    at a time and renamed into place."""
    import msgpack

    packer = msgpack.Packer(default=_flax_ext_pack, strict_types=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_tree(f, packer, _state_dict(tree))
    os.replace(tmp, path)


def _join_chunks(tree):
    """flax's chunk dicts (serialization._unchunk) joined into arrays, in
    place, the pieces in numeric key order; each piece is dropped once
    copied, so a large leaf is not held twice."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = tree["chunks"]
        out = np.empty(int(np.prod(shape)), chunks["0"].dtype)
        pos = 0
        for i in range(len(chunks)):
            piece = chunks.pop(str(i))
            out[pos:pos + piece.size] = piece
            pos += piece.size
            del piece
        if pos != out.size:
            raise ValueError(f"chunks of {pos} elements for shape {shape}")
        return out.reshape(shape)
    for k in tree:
        tree[k] = _join_chunks(tree[k])
    return tree


def load_jax_checkpoint(path: str) -> dict:
    """A checkpoint the JAX package wrote (flax msgpack) as nested dicts
    with numpy leaves; flax's chunk dicts (a leaf over 1 GiB: S2L's
    buffer on the whole ACDC set) are joined. The file is mapped, not
    read into memory."""
    import msgpack

    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as data:
        tree = msgpack.unpackb(data, ext_hook=_flax_ext, raw=False)
    return _join_chunks(tree)


def _restore(target, state, where: str):
    """`state` (a file's tree) in `target`'s structure: a dict's keys must
    be the state's (a missing or an extra one raises), a list's or tuple's
    length its; a tensor leaf comes back a tensor of the target's shape
    on its device and dtype, any other leaf as the file holds it."""
    if isinstance(target, dict):
        keys = {str(k) for k in target}
        if not isinstance(state, dict) or keys != state.keys():
            have = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"{where}: the target's keys {sorted(keys)} "
                             f"are not the checkpoint's {have}")
        return {k: _restore(v, state[str(k)], f"{where}/{k}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(target):
            raise ValueError(f"{where}: {len(target)} entries in the "
                             f"target, not the checkpoint's")
        out = [_restore(v, state[str(i)], f"{where}/{i}")
               for i, v in enumerate(target)]
        return type(target)(out)
    if isinstance(target, torch.Tensor):
        arr = np.asarray(state)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {arr.shape} in the checkpoint, "
                             f"{tuple(target.shape)} in the target")
        return torch.from_numpy(np.array(arr)).to(device=target.device,
                                                  dtype=target.dtype)
    return state


def load_checkpoint(path: str, target=None):
    """A flax msgpack checkpoint (the JAX package's save_checkpoint, or
    save_checkpoint here): without `target`, the nested dicts of numpy
    arrays that flax's msgpack_restore gives (chunks joined); with one, the
    tree in the target's structure (_restore). flax's from_bytes drops a
    key the target lacks; here it raises, as a missing one does."""
    tree = load_jax_checkpoint(path)
    return tree if target is None else _restore(target, tree, "")


def load_model_checkpoint(path: str, model: torch.nn.Module,
                          state_extra: dict | None = None,
                          extra_optional: bool = False) -> int:
    """Load an inference checkpoint of either package into `model`
    (strict: a missing or extra entry raises) and return its step. The
    entries of `state_extra` (ScribbleVC's class_memory: a dict of
    tensors) take the file's values in place; the file must carry each,
    unless `extra_optional`, where one it lacks keeps its value."""
    extra = dict(state_extra or {})
    if _is_torch_file(path):
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
