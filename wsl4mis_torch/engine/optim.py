"""SGD with the reference semantics (port of
``wsl4mis_tpu/engine/optim.py``).

torch.optim.SGD(momentum=0.9, weight_decay=1e-4) with poly decay: the
weight decay is added to the gradient before the momentum accumulation,
and update t (counted from 0) uses lr = base * (1 - t/max)^0.9, computed
in float32 as the JAX package's optax schedule does. The learning rate is
set per update here rather than through LambdaLR, whose step count is one
off from optax's.
"""

from __future__ import annotations

import numpy as np
import torch


def poly_lr(base_lr: float, max_iterations: int, power: float = 0.9):
    """count -> base * (1 - min(count, max)/max)^power, in float32."""

    def schedule(count: int) -> float:
        frac = np.float32(1.0) - (np.float32(min(count, max_iterations))
                                  / np.float32(max_iterations))
        return float(np.float32(base_lr) * frac ** np.float32(power))

    return schedule


class ReferenceSGD:
    """Momentum SGD over `params`; `count` is the number of updates done."""

    def __init__(self, params, base_lr: float, max_iterations: int,
                 momentum: float = 0.9, weight_decay: float = 1e-4):
        self.params = list(params)
        self.schedule = poly_lr(base_lr, max_iterations)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.count = 0
        self.momentum_buffers = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        lr = self.schedule(self.count)
        grads = torch._foreach_add(grads, self.params,
                                   alpha=self.weight_decay)
        torch._foreach_mul_(self.momentum_buffers, self.momentum)
        torch._foreach_add_(self.momentum_buffers, grads)
        torch._foreach_add_(self.params, self.momentum_buffers, alpha=-lr)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "momentum": list(self.momentum_buffers)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for buf, saved in zip(self.momentum_buffers, state["momentum"]):
                buf.copy_(saved)
