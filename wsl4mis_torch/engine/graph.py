"""A training step captured in CUDA graphs and replayed: the port's
counterpart of the JAX trainer's K-step device call (``steps_per_call``,
one ``jax.jit`` over a ``lax.scan`` of K steps, wsl4mis_tpu/engine/
trainer.py:64-85), for every method.

``CapturedStep(step_fn, state, aux, seed, variant)`` captures the step and
runs a call of K steps as K replays, each preceded by its inputs' loads:

* the batch, copied into static device tensors (a numpy index batch from
  pinned memory, a host-augmented batch on the device);
* one CUDA generator a purpose, registered with the graph and re-seeded
  with ``rng_seeds(seed, step)``: a replay draws from the seed and offset
  its generator holds, so it draws what the eager step's fresh
  ``split_rngs`` generators draw;
* the state's step scalars (``TrainState.load_step_scalars``: the step,
  every ``step_scalar`` such as the EMA weights or DAN's Adam corrections,
  and the optimizer's learning rate or bias corrections), which the eager
  step fills itself and the captured one reads.

Variants. What a step decides on the host, and so a capture freezes, is a
shape of computation: ustm's rotation, s2l's pseudo-label gate,
scribblevc's memory gate. A method names it with ``MethodBundle.variant``,
``(state, seed) -> {keyword: value}``: the step's keyword arguments at
state.step, picked from what the host holds (the step count and
``rng_seeds``), which the eager step decides alike when they are not
given. Each value gets its own graph (and memory pool), captured at the
first step that needs it with those arguments passed; before each replay
the host picks the graph of the step's value. Every other per-step value
must be a step scalar.

Before a capture, ``WARMUP_STEPS`` eager steps of the same variant run on
the capture's side stream, as PyTorch's whole-network capture recipe does
(cuBLAS workspaces, the kernels' libraries, an EMA teacher's copy), from a
copy of the state that is put back after, the host counts held at the
step's. The capture runs in thread-local mode, so that the Trainer's
prefetch thread may copy a host-augmented batch meanwhile; the gradients
that the captured backward allocates live in the graph's pool. The host
counts that a step advances (``TrainState.host_counts``: the step, the
optimizer's count, DAN's Adam count) must each move by one in the
capture; they are put back after it and advanced after each replay.

A call ends bit-equal to the same steps run eagerly (chip_smoke phase 10):
the same kernels on the same inputs and draws. The kernel wrappers'
launch counters count the warm-ups and the captures, not the replays (a
trace counts those). A failure raises; nothing falls back to the eager
step.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

from .methods.common import RNG_PURPOSES, rng_seeds
from .state import TrainState

WARMUP_STEPS = 3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class _Graph:
    """One variant's graph, its generators and its outputs."""

    def __init__(self, graph, rngs, outputs):
        self.graph, self.rngs, self.outputs = graph, rngs, outputs


class CapturedStep:
    """`step_fn` on `state` captured at the first step of each variant
    (from that step's batch and state) and replayed once a step."""

    def __init__(self, step_fn, state: TrainState, aux, seed: int,
                 variant=None):
        if state.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the state on a card, not "
                             f"{state.device}")
        self.step_fn, self.state, self.aux, self.seed = (step_fn, state,
                                                         aux, seed)
        self.variant = variant
        self.device = state.device
        self.graphs: dict = {}  # variant key -> _Graph
        self.capture_s: dict = {}  # variant key -> warm-up and capture s
        self.batch = None
        self.last = None  # the last replayed _Graph

    def pick(self) -> tuple:
        """The variant of the step at state.step, as a sorted tuple of the
        step's keyword arguments."""
        if self.variant is None:
            return ()
        return tuple(sorted(self.variant(self.state, self.seed).items()))

    def __call__(self, batches) -> dict:
        """One step a batch of `batches`, from state.step on; returns the
        last step's metrics (copies: the graph's outputs are overwritten by
        the next replay)."""
        for batch in batches:
            key = self.pick()
            if key not in self.graphs:
                self._capture(batch, key)
            g = self.graphs[key]
            self._load(batch, g.rngs)
            g.graph.replay()
            counts = self.state.host_counts()
            self.state.set_host_counts({k: v + 1 for k, v in counts.items()})
            self.last = g
        return _clone(self.last.outputs)

    def _load(self, batch, rngs) -> None:
        """The step's inputs into the static buffers, on the current
        stream."""
        if self.batch is None:
            self.batch = {k: torch.empty(np.shape(v), device=self.device,
                                         dtype=torch.as_tensor(v).dtype)
                          for k, v in batch.items()}
        if batch.keys() != self.batch.keys():
            raise ValueError(f"captured step: batch keys {sorted(batch)}, "
                             f"captured as {sorted(self.batch)}")
        for k, v in batch.items():
            src = torch.as_tensor(v)
            dst = self.batch[k]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"captured step: batch[{k!r}] "
                                 f"{tuple(src.shape)} {src.dtype}, captured "
                                 f"as {tuple(dst.shape)} {dst.dtype}")
            if src.device.type == "cpu":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)
        for name, s in rng_seeds(self.seed, self.state.step).items():
            rngs[name].manual_seed(s)
        self.state.load_step_scalars()

    def _run(self, rngs, key):
        return self.step_fn(self.state, self.batch, rngs, self.aux,
                            **dict(key))

    def _capture(self, batch, key) -> None:
        t0 = time.perf_counter()
        rngs = {name: torch.Generator(device=self.device)
                for name in RNG_PURPOSES}
        counts = self.state.host_counts()
        saved = copy.deepcopy(self.state.state_dict())
        side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._load(batch, rngs)
                self._run(rngs, key)
                self.state.set_host_counts(counts)
        current.wait_stream(side)
        self.state.load_state_dict(saved)
        del saved
        self._load(batch, rngs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            for gen in rngs.values():
                graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            outputs = self._run(rngs, key)
        moved = {k: v - counts[k]
                 for k, v in self.state.host_counts().items()}
        if moved != {k: 1 for k in counts}:
            raise RuntimeError(f"captured step: the host counts moved by "
                               f"{moved}, not one update each")
        self.state.set_host_counts(counts)
        self.graphs[key] = _Graph(graph, rngs, outputs)
        torch.cuda.synchronize(self.device)
        self.capture_s[key] = time.perf_counter() - t0
        logging.info("captured step: variant %s captured at step %d in "
                     "%.2f s (%d graph%s)", dict(key) or "(one)",
                     self.state.step, self.capture_s[key], len(self.graphs),
                     "s" if len(self.graphs) > 1 else "")
