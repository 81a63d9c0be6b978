"""Train state: model (params + BN statistics), optimizer, step, extras
(port of ``wsl4mis_tpu/engine/state.py``). Unlike the JAX package's
immutable TrainState, this one is updated in place.

``jax_tree`` / ``load_jax_tree`` map it to and from the tree the JAX
package's ``save_train_state`` writes: {"step": 0-d int32, "params",
"batch_stats", "opt_state" (the optax state as flax writes it), "extra"
(None, or the method's: ema_params, disc_params + disc_opt_state, weight,
class_memory)}. Loading copies into the state's own tensors, so the
modules that compute with them (an EMA teacher, DAN's discriminator) see
the loaded values; a key missing or left over raises and names it.

Step scalars: every per-step value that a step computes on the host (the
EMA decay, DAN's Adam corrections, the optimizer's learning rate or bias
corrections) lives in a 0-d device tensor that the step reads, and the
step count in `step_tensor()`. An eager step fills them where it takes
them; a captured one (``engine.graph``) reads what ``load_step_scalars``
filled before the replay, from the host counts (``host_counts``) as the
step begins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .. import parallel
from ..utils.device import capturing
from ..utils.params import (
    check_keys,
    copy_named,
    flax_naming,
    load_flax_variables,
    named_from_flax,
    to_flax,
    to_flax_variables,
)
from .optim import (
    ReferenceAdamW,
    ReferenceSGD,
    adam_optax_state,
    load_adam_optax_state,
)

_JAX_KEYS = ("step", "params", "batch_stats", "opt_state", "extra")


@dataclass
class TrainState:
    model: torch.nn.Module
    opt: ReferenceSGD | ReferenceAdamW
    step: int = 0
    extra: Any = None  # tensors in (nested) dicts: EMA params, a
                       # discriminator's params and Adam state
    step_buffer: torch.Tensor | None = field(default=None, repr=False,
                                             compare=False)
    scalars: dict = field(default_factory=dict, repr=False, compare=False)
                       # name -> (0-d device tensor, fn(state) -> float)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step_tensor(self) -> torch.Tensor:
        """`step` as a 0-d int64 tensor on the state's device
        (`step_buffer`), for what a step computes from it on the device
        (the ramp of pce_intensity_variance): an eager step fills it here,
        a captured one reads what the replay's caller loaded
        (``load_step_scalars``)."""
        if self.step_buffer is None:
            self.step_buffer = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
        if not capturing():
            self.step_buffer.fill_(self.step)
        return self.step_buffer

    def step_scalar(self, name: str,
                    fn: Callable[["TrainState"], float]) -> torch.Tensor:
        """A 0-d f32 tensor on the state's device holding fn(self), a host
        value (an f32-exact float) of the host counts as the step begins:
        the step takes it before it moves any of them (its update, an
        optimizer's count). An eager step fills it here, a captured one
        reads what ``load_step_scalars`` filled; the first call allocates
        it, and the latest `fn` of a name is the one loaded."""
        entry = self.scalars.get(name)
        buf = torch.zeros((), dtype=torch.float32, device=self.device) \
            if entry is None else entry[0]
        self.scalars[name] = (buf, fn)
        if not capturing():
            buf.fill_(fn(self))
        return buf

    def load_step_scalars(self) -> None:
        """Fill the step's device scalars from the host counts: the step,
        each `step_scalar` and the optimizer's (``engine.graph`` calls it
        before a capture, which must find the buffers allocated, and before
        every replay)."""
        self.step_tensor()
        for buf, fn in self.scalars.values():
            buf.fill_(fn(self))
        self.opt.load_scalars()

    def host_counts(self) -> dict[str, int]:
        """The counts a step advances on the host, by path: the step, the
        optimizer's count and every int of extra (DAN's Adam count)."""
        out = {"step": self.step, "opt/count": self.opt.count}
        _extra_counts(self.extra, "extra", out)
        return out

    def set_host_counts(self, counts: dict[str, int]) -> None:
        """The inverse of host_counts (every path it gives)."""
        self.step = counts["step"]
        self.opt.count = counts["opt/count"]
        for path, v in counts.items():
            if path.startswith("extra/"):
                *keys, last = path.split("/")[1:]
                d = self.extra
                for k in keys:
                    d = d[k]
                d[last] = v

    def minimize(self, loss: torch.Tensor) -> None:
        """Backward of `loss`, one optimizer update, step + 1. Under a
        process group the gradients are averaged over the ranks first: each
        rank's backward carries W times its share of the global loss's
        gradient (``parallel``), so the mean is that gradient."""
        self.opt.zero_grad()
        loss.backward()
        parallel.average_gradients(
            [p.grad for p in self.opt.params if p.grad is not None])
        self.opt.step()
        self.step += 1

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt": self.opt.state_dict(), "extra": self.extra}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])
        if self.extra is None:
            self.extra = state["extra"]
        else:
            _load_into(self.extra, state["extra"])

    def _param_names(self) -> list[str]:
        named = list(self.model.named_parameters())
        if len(named) != len(self.opt.params) or any(
                p is not q for (_, p), q in zip(named, self.opt.params)):
            raise ValueError("the optimizer's parameters are not the "
                             "model's, in its order")
        return [k for k, _ in named]

    def jax_tree(self) -> dict:
        """The state as the JAX package's full-state checkpoint holds it."""
        naming = flax_naming(self.model)
        opt = self.opt.optax_state(self._param_names(),
                                   lambda named: to_flax(named, naming))
        return {"step": np.asarray(self.step, np.int32),
                **to_flax_variables(self.model), "opt_state": opt,
                "extra": _jax_extra(self.extra, naming)}

    def load_jax_tree(self, tree: dict) -> None:
        """Load a JAX full-state checkpoint's tree (of the same method and
        model) into this state, in place."""
        check_keys(tree, _JAX_KEYS, "checkpoint")
        naming = flax_naming(self.model)
        extra = tree["extra"]
        if (extra is None) != (self.extra is None):
            raise KeyError(f"checkpoint extra {_keys(extra)} != state extra "
                           f"{_keys(self.extra)}")
        if extra is not None:
            check_keys(extra, self.extra.keys(), "checkpoint extra")
        variables = {"params": tree["params"],
                     "batch_stats": tree["batch_stats"]}
        memory = None
        if extra is not None and "class_memory" in extra:
            memory = self.extra["class_memory"]
            variables["class_memory"] = extra["class_memory"]
        load_flax_variables(self.model, variables, memory=memory)
        self.opt.load_optax_state(
            tree["opt_state"], self._param_names(),
            lambda t: named_from_flax(t, naming.key))
        step = np.asarray(tree["step"])
        if step.shape != ():
            raise KeyError(f"checkpoint step of shape {step.shape}")
        self.step = int(step)
        if extra is not None:
            _load_jax_extra(self.extra, extra, naming)


# the extras that hold a discriminator's tree: FCDiscriminator's renaming
_DISC_NAMING = flax_naming()


def _extra_counts(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _extra_counts(v, f"{prefix}/{k}", out)
    elif isinstance(tree, int):
        out[prefix] = tree


def _keys(extra):
    return None if extra is None else sorted(extra)


def _disc_named(tree) -> dict[str, torch.Tensor]:
    return named_from_flax(tree, _DISC_NAMING.key)


def _jax_extra(extra, naming):
    """state.extra in the JAX package's layout (see load_jax_tree)."""
    if extra is None:
        return None
    out = {}
    for k, v in extra.items():
        if k == "ema_params":
            out[k] = to_flax(v, naming)
        elif k == "disc_params":
            out[k] = to_flax(v, _DISC_NAMING)
        elif k == "disc_opt_state":
            out[k] = adam_optax_state(
                v, lambda named: to_flax(named, _DISC_NAMING))
        elif k == "weight":
            out[k] = v.detach().cpu().numpy()
        elif k == "class_memory":
            out[k] = {m: t.detach().cpu().numpy() for m, t in v.items()}
        else:
            raise KeyError(f"extra {k!r} has no JAX layout")
    return out


@torch.no_grad()
def _load_jax_extra(dst: dict, src: dict, naming) -> None:
    """src (a JAX checkpoint's extra) into the tensors of dst (the state's
    extra); class_memory is loaded with the model."""
    for k, v in src.items():
        if k == "ema_params":
            copy_named(dst[k], named_from_flax(v, naming.key),
                       "extra ema_params")
        elif k == "disc_params":
            copy_named(dst[k], _disc_named(v), "extra disc_params")
        elif k == "disc_opt_state":
            load_adam_optax_state(dst[k], v, _disc_named)
        elif k == "weight":
            w = np.asarray(v)
            if w.shape != tuple(dst[k].shape):
                raise KeyError(f"extra weight has shape {w.shape}, not "
                               f"{tuple(dst[k].shape)}")
            dst[k].copy_(torch.from_numpy(w))
        elif k != "class_memory":
            raise KeyError(f"extra {k!r} has no JAX layout")


def _load_into(dst: dict, src: dict) -> None:
    """Copy src's values into dst in place, tensors into dst's own tensors:
    a step's modules (EMA teacher, discriminator) compute with them."""
    if dst.keys() != src.keys():
        raise KeyError(f"extra keys {sorted(src)} != {sorted(dst)}")
    for k, v in src.items():
        if isinstance(dst[k], dict):
            _load_into(dst[k], v)
        elif isinstance(dst[k], torch.Tensor):
            with torch.no_grad():
                dst[k].copy_(v)
        else:
            dst[k] = v


def ema_copy(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The EMA teacher's parameters at the start: a copy of the model's."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def ema_decay(alpha: float, global_step: int) -> tuple[float, float]:
    """(a, 1 - a), a = min(1 - 1/(step + 1), alpha), in f32: the teacher's
    and the student's weights of the EMA update after update `global_step`
    (update_ema_variables, train_weakly_supervised_ustm_2D.py:61-65)."""
    one = np.float32(1.0)
    a = min(one - one / (np.float32(global_step) + one), np.float32(alpha))
    return float(a), float(one - a)


def ema_scalars(state: TrainState, alpha: float) -> tuple:
    """The EMA update's weights as step scalars of `state`: of the step
    count after this step's update (taken before it)."""
    return tuple(state.step_scalar(f"ema_{i}", lambda s, i=i: ema_decay(
        alpha, s.step + 1)[i]) for i in range(2))


@torch.no_grad()
def ema_apply(teacher: dict[str, torch.Tensor], student: torch.nn.Module,
              weights: tuple) -> None:
    """teacher <- a teacher + (1 - a) student in place over the parameters
    (BN scale and bias included, running statistics not), in f32, each
    product rounded apart as the JAX update rounds them; `weights` (a,
    1 - a) as 0-d device tensors (ema_scalars)."""
    a, b = weights
    params = list(student.named_parameters())
    t = [teacher[k] for k, _ in params]
    torch._foreach_mul_(t, a)
    torch._foreach_add_(t, torch._foreach_mul([p.detach() for _, p in params],
                                              b))


def ema_update(teacher: dict[str, torch.Tensor], student: torch.nn.Module,
               alpha: float, global_step: int) -> None:
    """Mean-teacher EMA with warm-up after update `global_step` (an int
    host count: ema_apply at ema_decay's weights, filled here, which a
    capture refuses; a step takes ema_scalars)."""
    if capturing():
        raise RuntimeError("ema_update under capture: take ema_scalars")
    device = next(iter(teacher.values())).device
    ema_apply(teacher, student, tuple(
        torch.full((), w, dtype=torch.float32, device=device)
        for w in ema_decay(alpha, global_step)))
