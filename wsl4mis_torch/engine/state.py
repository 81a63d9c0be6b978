"""Train state: model (params + BN statistics), optimizer, step, extras
(port of ``wsl4mis_tpu/engine/state.py``). Unlike the JAX package's
immutable TrainState, this one is updated in place."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .optim import ReferenceSGD


@dataclass
class TrainState:
    model: torch.nn.Module
    opt: ReferenceSGD
    step: int = 0
    extra: Any = None

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
        self.extra = state["extra"]
