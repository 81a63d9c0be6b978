"""SGD and Adam with the reference semantics (port of
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


def adam_init(params: dict[str, torch.Tensor]) -> dict:
    """Adam's state for `params`: the update count and both moments, as
    tensors in dicts (a train state's extra, checkpointed as it is)."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def reference_adam(params: dict[str, torch.Tensor],
                   grads: dict[str, torch.Tensor], state: dict,
                   lr: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
                   eps: float = 1e-8) -> None:
    """One update of torch.optim.Adam(lr, betas=(b1, b2), eps) =
    optax.adam(lr, b1, b2, eps), the DAN discriminator's optimizer
    (train_deep_adversarial_network_2D.py:111-112), in place on `params`
    and `state`, in optax's order: mu_hat / (sqrt(nu_hat) + eps)."""
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k] for k in names]
    mu = [state["mu"][k] for k in names]
    nu = [state["nu"][k] for k in names]
    state["count"] += 1
    t = np.float32(state["count"])
    one = np.float32(1.0)
    # 1 - b in double, then f32 (as optax's Python-float arithmetic); the
    # bias corrections in f32 (its f32 power of the count)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    mu_hat = torch._foreach_div(mu, float(one - np.float32(b1) ** t))
    denom = torch._foreach_div(nu, float(one - np.float32(b2) ** t))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(mu_hat, denom)
    torch._foreach_add_(p, mu_hat, alpha=-lr)
