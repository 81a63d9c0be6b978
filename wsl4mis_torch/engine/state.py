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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

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

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def minimize(self, loss: torch.Tensor) -> None:
        """Backward of `loss`, one optimizer update, step + 1."""
        self.opt.zero_grad()
        loss.backward()
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


@torch.no_grad()
def ema_update(teacher: dict[str, torch.Tensor], student: torch.nn.Module,
               alpha: float, global_step: int) -> None:
    """Mean-teacher EMA with warm-up, in place over the parameters (BN
    scale and bias included, running statistics not): a = min(1 - 1/(step
    + 1), alpha), teacher <- a teacher + (1 - a) student, in f32
    (update_ema_variables, train_weakly_supervised_ustm_2D.py:61-65)."""
    one = np.float32(1.0)
    a = min(one - one / (np.float32(global_step) + one), np.float32(alpha))
    params = list(student.named_parameters())
    t = [teacher[k] for k, _ in params]
    torch._foreach_mul_(t, float(a))
    torch._foreach_add_(t, [p.detach() for _, p in params],
                        alpha=float(one - a))
