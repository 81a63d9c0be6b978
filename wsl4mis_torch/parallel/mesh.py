"""Data parallelism over processes (port of ``wsl4mis_tpu/parallel/mesh.py``).

The JAX package runs a 1-D data mesh: the batch is sharded over the
devices, the state replicated, and XLA inserts the psums of every reduction
over the batch axis, so a sharded step equals the single-device step at
the global batch. Here each card (or CPU process) is one rank of
``torch.distributed``'s default process group, and the step keeps that
contract by hand:

* every reduction over the batch (BN moments, loss sums and counts, the
  class memory's batch means) goes through ``global_sum``, an all-reduce
  whose backward is an all-reduce too; a rank's graph then carries W times
  its share of each gradient, and ``average_gradients`` (W = world size)
  divides the sum over ranks back to the gradient of the global loss;
* every random draw over the batch is made at the global batch's shape
  and cut to the rank's rows (``global_batch`` / ``local_rows``), so W
  processes draw what one draws at the global batch;
* host-side decisions read only replicated values, so every rank issues
  the same collectives in the same order.

Without a process group every function here returns its input untouched
and issues no collective. Only ``all_reduce``, ``broadcast`` and
``barrier`` are used: gloo's CUDA support covers those three, which lets
two ranks share one card.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import shutil
import tempfile
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

calls: Counter = Counter()  # collectives issued, by kind ("all_reduce",
                            # "broadcast", "barrier")
BUCKET_NUMEL = 1 << 24      # elements per flat buffer of average_gradients
_SEGMENTS = contextvars.ContextVar("row_segments", default=None)


@dataclass(frozen=True)
class Mesh:
    """A process's place in the 1-D data mesh."""

    rank: int = 0
    world_size: int = 1


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def current_mesh() -> Mesh:
    """This process's place in the default process group's mesh."""
    return Mesh(rank(), world_size())


def make_mesh(world: int = 1, rank: int = 0, device: str = "cuda",
              init_method: str | None = None,
              backend: str | None = None) -> Mesh:
    """Set up the default process group for rank `rank` of `world`
    processes (``nccl`` on cards, ``gloo`` on the CPU, unless `backend`
    says) and the rank's device: ``cuda`` means card `rank`, ``cuda:i``
    card i, made the current one (``utils.device.resolve_device`` then
    places the rank's tensors there). One process without an `init_method`
    sets up no group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", rank)
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"make_mesh: rank {rank} needs card {dev.index}"
                             f" of {torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    if world > 1 or init_method is not None:
        if init_method is None:
            raise ValueError("make_mesh: a group of several processes needs "
                             "an init_method")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, **kw)
    return Mesh(rank, world)


def close_mesh() -> None:
    """Tear down the default process group, if any."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        calls["barrier"] += 1
        dist.barrier()


def _all_reduce(t: torch.Tensor) -> None:
    calls["all_reduce"] += 1
    dist.all_reduce(t)


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradients over the ranks
    (torch.distributed.nn.functional.all_reduce's pairing, with counted
    calls)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        _all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g)
        return g


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks (every rank gets the sum), with an
    all-reduce backward; `t` itself without a process group."""
    return _GlobalSum.apply(t) if active() else t


def global_sums(*ts: torch.Tensor) -> tuple:
    """The tensors `ts` (of one shape and dtype) each summed over the ranks
    by one all-reduce of their stack (``global_sum``); `ts` themselves
    without a process group."""
    if not active():
        return ts
    return tuple(global_sum(torch.stack(ts)).unbind(0))


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of `t`, a mean over the rank's rows: every
    rank holds as many rows (``shard_batch``), so it is the mean over the
    global batch. `t` itself without a process group."""
    return global_sum(t) / world_size() if active() else t


def global_batch(rows: int) -> int:
    """The global batch of a rank's `rows` (every rank holds as many)."""
    return rows * world_size()


@contextlib.contextmanager
def row_segments(*rows: int):
    """Within the block, a batch of a rank is the concatenation of its rows
    of len(rows) global batches (e.g. [labeled; unlabeled], or [x; x]):
    ``local_rows`` cuts a draw of the global shape segment by segment."""
    token = _SEGMENTS.set(rows)
    try:
        yield
    finally:
        _SEGMENTS.reset(token)


def local_rows(t):
    """The rank's rows of `t`, a draw at the global batch's shape (see
    ``row_segments``); `t` itself on one process."""
    w = world_size()
    if w == 1:
        return t
    r = rank()
    sizes = _SEGMENTS.get() or (t.shape[0] // w,)
    if sum(sizes) * w != t.shape[0]:
        raise ValueError(f"local_rows: a draw of {t.shape[0]} rows is not "
                         f"{w} ranks' segments {list(sizes)}")
    parts, start = [], 0
    for n in sizes:
        parts.append(t[start + r * n:start + (r + 1) * n])
        start += n * w
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def shard_batch(mesh: Mesh, batch: dict, parts=None) -> dict:
    """The rows of rank mesh.rank of a host or device batch dict: of each
    part of the batch (`parts`: their sizes in order, e.g. (labeled_bs,
    unlabeled_bs); None: the batch as one part), the rank's contiguous
    slice. Every part must divide over the ranks, as the JAX mesh's batch
    dim must (ValueError), and leave each rank at least one row; entries of
    no batch dim pass through."""
    w, r = mesh.world_size, mesh.rank
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = v
            continue
        sizes = check_batch(mesh, v.shape[0], parts)
        pieces, start = [], 0
        for n in sizes:
            m = n // w
            pieces.append(v[start + r * m:start + (r + 1) * m])
            start += n
        if len(pieces) == 1:
            out[k] = pieces[0]
        else:
            cat = np.concatenate if isinstance(v, np.ndarray) else torch.cat
            out[k] = cat(pieces)
    return out


def check_batch(mesh: Mesh, batch_size: int, parts=None) -> tuple:
    """The parts of a `batch_size` batch (`parts`, or the batch as one
    part); ValueError, naming the numbers, where they do not add up to it or
    one does not divide over the mesh's ranks into at least a row each (the
    JAX trainer's check)."""
    w = mesh.world_size
    parts = tuple(parts or (batch_size,))
    if sum(parts) != batch_size:
        raise ValueError(f"batch parts {list(parts)} do not add up to the "
                         f"batch of {batch_size}")
    if any(p % w or p < w for p in parts):
        raise ValueError(f"batch parts {list(parts)} (batch {batch_size}) do "
                         f"not divide over {w} ranks: each must be a "
                         f"multiple of {w}, at least {w}")
    return parts


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate_tree(tree):
    """Every tensor of `tree` (nested dicts, lists, tuples) set to rank 0's
    values, in place: one broadcast each. Returns `tree`."""
    if active():
        with torch.no_grad():
            for t in _tensors(tree):
                calls["broadcast"] += 1
                if t.is_contiguous():
                    dist.broadcast(t, 0)
                else:
                    c = t.contiguous()
                    dist.broadcast(c, 0)
                    t.copy_(c)
    return tree


@torch.no_grad()
def average_gradients(grads) -> None:
    """Each gradient in `grads` replaced, in place, by its mean over the
    ranks: one all-reduce per flat buffer of up to BUCKET_NUMEL elements of
    one dtype and device, in the order given (the same on every rank)."""
    w = world_size()
    if w == 1:
        return
    bucket, numel = [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        _all_reduce(flat)
        flat.div_(w)
        start = 0
        for g in bucket:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()

    for g in grads:
        if bucket and (numel + g.numel() > BUCKET_NUMEL
                       or g.dtype != bucket[0].dtype
                       or g.device != bucket[0].device):
            flush()
            bucket, numel = [], 0
        bucket.append(g)
        numel += g.numel()
    if bucket:
        flush()


def visible_cards(device: str, num_devices: int | None) -> int:
    """The processes a run of `num_devices` takes: None means every visible
    card (one process on the CPU); more cards than are visible raises."""
    if device == "cpu":
        n = 1 if num_devices is None else num_devices
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        count = torch.cuda.device_count()
        n = count if num_devices is None else num_devices
        if n > count:
            raise ValueError(f"num_devices {n} > the {count} visible cards")
    if n < 1:
        raise ValueError(f"num_devices {n} < 1")
    return n


def _spawned(r, fn, world, device, init_method, backend, args):
    if device == "cpu":
        torch.set_num_threads(1)
    make_mesh(world, r, device, init_method, backend)
    try:
        fn(r, *args)
    finally:
        close_mesh()


def spawn(fn, world: int, device: str = "cuda", args=(),
          init_method: str | None = None, backend: str | None = None):
    """Run fn(rank, *args) in `world` fresh processes (start method spawn:
    the caller may hold CUDA), each rank `rank` of one process group on its
    device (``make_mesh``); `fn` must be importable. The rendezvous is a
    file in a new temporary directory unless `init_method` names one.
    Raises if any rank fails."""
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="wsl4mis_mesh_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        mp.start_processes(_spawned, args=(fn, world, device, init_method,
                                           backend, tuple(args)),
                           nprocs=world, start_method="spawn")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
