"""A training step captured in a CUDA graph and replayed: the port's
counterpart of the JAX trainer's K-step device call (``steps_per_call``,
one ``jax.jit`` over a ``lax.scan`` of K steps, wsl4mis_tpu/engine/
trainer.py:64-85).

``CapturedStep(step_fn, state, aux, seed)`` captures one step and runs a
call of K steps as K replays, each preceded by its inputs' loads:

* the batch, copied into static device tensors (a numpy index batch from
  pinned memory, a host-augmented batch on the device);
* one CUDA generator a purpose, registered with the graph and re-seeded
  with ``rng_seeds(seed, step)``: a replay draws from the seed and offset
  its generator holds, so it draws what the eager step's fresh
  ``split_rngs`` generators draw;
* the state's step scalars (``TrainState.load_step_scalars``: the step and
  the SGD's learning rate), which the eager step fills itself and the
  captured one reads.

Before the capture, ``WARMUP_STEPS`` eager steps run on the capture's side
stream, as PyTorch's whole-network capture recipe does (cuBLAS workspaces,
the kernels' libraries), from a copy of the state that is put back after.
The capture runs in thread-local mode, so that the Trainer's prefetch
thread may copy a host-augmented batch meanwhile; the gradients that the
captured backward allocates live in the graph's pool. The host counts that
a step advances (state.step, the optimizer's count) are put back after the
capture and advanced after each replay. The step must take no decision on
the host (``MethodBundle.host_decision``): a capture freezes it.

A call ends bit-equal to the same steps run eagerly (chip_smoke phase 10):
the same kernels on the same inputs and draws. The kernel wrappers'
launch counters count the warm-up and the capture, not the replays (a
trace counts those). A failure raises; nothing falls back to the eager
step.
"""

from __future__ import annotations

import copy
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


class CapturedStep:
    """One step of `step_fn` on `state` captured at the first call (from
    that call's first batch and state) and replayed once a step."""

    def __init__(self, step_fn, state: TrainState, aux, seed: int):
        if state.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the state on a card, not "
                             f"{state.device}")
        self.step_fn, self.state, self.aux, self.seed = (step_fn, state,
                                                         aux, seed)
        self.device = state.device
        self.graph = None
        self.capture_s = None   # warm-up and capture, host seconds
        self.batch, self.rngs, self.outputs = None, None, None

    def __call__(self, batches) -> dict:
        """One step a batch of `batches`, from state.step on; returns the
        last step's metrics (copies: the graph's outputs are overwritten by
        the next replay)."""
        if self.graph is None:
            self._capture(batches[0])
        for batch in batches:
            self._load(batch)
            self.graph.replay()
            self.state.step += 1
            self.state.opt.count += 1
        return _clone(self.outputs)

    def _load(self, batch) -> None:
        """The step's inputs into the static buffers, on the current
        stream."""
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
            self.rngs[name].manual_seed(s)
        self.state.load_step_scalars()

    def _capture(self, batch) -> None:
        t0 = time.perf_counter()
        self.batch = {k: torch.empty(np.shape(v), device=self.device,
                                     dtype=torch.as_tensor(v).dtype)
                      for k, v in batch.items()}
        self.rngs = {name: torch.Generator(device=self.device)
                     for name in RNG_PURPOSES}
        saved = copy.deepcopy(self.state.state_dict())
        side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._load(batch)
                self.step_fn(self.state, self.batch, self.rngs, self.aux)
        current.wait_stream(side)
        self.state.load_state_dict(saved)
        del saved
        self._load(batch)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            for gen in self.rngs.values():
                graph.register_generator_state(gen)
        counts = (self.state.step, self.state.opt.count)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.outputs = self.step_fn(self.state, self.batch, self.rngs,
                                        self.aux)
        if (self.state.step - counts[0], self.state.opt.count - counts[1]) \
                != (1, 1):
            raise RuntimeError(
                f"captured step: the step advanced state.step by "
                f"{self.state.step - counts[0]} and the optimizer's count by "
                f"{self.state.opt.count - counts[1]}, not one update")
        self.state.step, self.state.opt.count = counts
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
