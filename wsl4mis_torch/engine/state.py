"""Train state: model (params + BN statistics), optimizer, step, extras
(port of ``wsl4mis_tpu/engine/state.py``). Unlike the JAX package's
immutable TrainState, this one is updated in place."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .optim import ReferenceAdamW, ReferenceSGD


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
