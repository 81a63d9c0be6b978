"""``TrainConfig.debug_nans``: the port's counterpart of ``jax_debug_nans``
(wsl4mis_tpu/engine/trainer.py:50-51).

JAX checks the outputs of each jitted call and, on a NaN, runs the
computation again op by op to find the first primitive that produced
one, then raises FloatingPointError. Here ``NanCheck`` runs each step
after keeping a copy of the state, and then tests its outputs (the
metrics and every floating tensor of the state: parameters, BN buffers,
optimizer state, the method's extras) with one reduction and one host
sync. On a NaN it puts the copy back and runs the step again with the
same (seed, step) draws, so the second run repeats the first: with a
forward hook on every module (``register_module_forward_hook``: the
model's, an EMA teacher's, a discriminator's) that records the first
module whose output holds a NaN, under
``torch.autograd.detect_anomaly(check_nan=True)``, which names the first
backward node to return one. It puts the copy back again, so the state is
the one before the step, and raises FloatingPointError naming the
iteration and the first module (else the backward node, else the state
leaf). Only NaN counts, as with jax_debug_nans; an inf does not.

A clean step is the step itself: the copy and the test only read. Under a
process group the re-run takes no anomaly mode (a rank that raised in its
backward would leave the others waiting in a collective); its forward
hooks record and never raise, so every rank issues the same collectives.
"""

from __future__ import annotations

import copy
import re

import torch

from .. import parallel
from .methods.common import split_rngs
from .state import TrainState


def _named(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")


def has_nan(*trees) -> bool:
    """Whether any floating tensor of the trees holds a NaN: one flag a
    tensor on the device, one reduction of the flags and one sync."""
    flags = [t.detach().isnan().any().reshape(1) for tree in trees
             for _, t in _named(tree) if t.is_floating_point()]
    return bool(flags) and bool(torch.cat(flags).any())


def first_nan_leaf(tree) -> str | None:
    """The path of the first floating tensor of `tree` holding a NaN."""
    for path, t in _named(tree):
        if t.is_floating_point() and bool(t.detach().isnan().any()):
            return path
    return None


class _FirstNan:
    """A global forward hook that records the first module whose output
    holds a NaN, by its name in the model where it has one."""

    def __init__(self, model: torch.nn.Module):
        self.names = {id(m): f"model.{n}" if n else "model"
                      for n, m in model.named_modules()}
        self.where = None

    def __call__(self, module, inputs, output):
        if self.where is None and has_nan(output):
            self.where = self.names.get(
                id(module), f"{type(module).__name__} (outside the model)")


_ANOMALY = re.compile(r"Function '(\w+)' returned nan values")


def locate_nan(step_fn, state: TrainState, batch, rngs, aux) -> str:
    """Where the step (run once more on `state`) first makes a NaN: the
    first module whose output holds one, else the first backward node
    that returns one, else the first state leaf or metric holding one."""
    hook = _FirstNan(state.model)
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    backward, metrics = None, None
    anomaly = not parallel.active()
    try:
        with torch.autograd.detect_anomaly(check_nan=anomaly):
            metrics = step_fn(state, batch, rngs, aux)
    except RuntimeError as e:
        found = _ANOMALY.search(str(e))
        if found is None:
            raise
        backward = found.group(1)
    finally:
        handle.remove()
    if hook.where is not None:
        return f"the output of module {hook.where}"
    if backward is not None:
        return f"the backward node {backward}"
    leaf = first_nan_leaf(state.state_dict())
    if leaf is not None:
        return f"the state leaf {leaf} after the update"
    leaf = first_nan_leaf(metrics)
    return "no module" if leaf is None else f"the metric {leaf}"


class NanCheck:
    """Runs a method's step at one iteration and raises FloatingPointError
    where it makes a NaN (the module docstring)."""

    def __init__(self, step_fn, seed: int, device):
        self.step_fn, self.seed, self.device = step_fn, seed, device

    def __call__(self, state: TrainState, batch, aux,
                 iteration: int) -> dict:
        saved = copy.deepcopy(state.state_dict())
        counts = state.host_counts()
        metrics = self.step_fn(state, batch, split_rngs(
            self.seed, iteration, self.device), aux)
        if not has_nan(metrics, state.state_dict()):
            return metrics

        def put_back():
            state.load_state_dict(saved)
            state.set_host_counts(counts)

        put_back()
        try:
            where = locate_nan(self.step_fn, state, batch, split_rngs(
                self.seed, iteration, self.device), aux)
        finally:
            put_back()
        raise FloatingPointError(
            f"debug_nans: iteration {iteration} made a NaN; the re-run "
            f"found it first in {where}")
