"""SGD as WSL4MIS's scripts train: torch.optim.SGD(momentum=0.9,
weight_decay=1e-4) with the poly learning rate base * (1 - t /
max_iterations)^0.9 of update t (counted from 0), worked out in f32 as
the train command's schedule is.

An optimizer's file gives both sides of what ``correct`` compares as the
first gradient, "the gradient as the optimizer got it":

* ``Reference``: the plain update over a dict of f32 tensors, and
  ``taken()``, that gradient worked out from its state after one update
  (SGD's momentum buffer: the gradient plus the weight decay);
* ``program_grad(state, names)``: the same read from the program's state
  after its first step (the port's ``ReferenceSGD`` keeps
  ``momentum_buffers`` in the order of the model's parameters). It reads
  the program's objects and imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

MOMENTUM, WEIGHT_DECAY = 0.9, 1e-4


def poly_lr(base_lr: float, max_iterations: int, t: int) -> float:
    f = np.float32
    frac = f(1.0) - f(min(t, max_iterations)) / f(max_iterations)
    return float(f(base_lr) * frac ** f(0.9))


class Reference:
    def __init__(self, P: dict, params: list, traffic: dict):
        self.params, self.traffic = params, traffic
        self.mom = {n: torch.zeros_like(P[n]) for n in params}

    @torch.no_grad()
    def update(self, P: dict, grads: list, t: int) -> None:
        lr = poly_lr(self.traffic["base_lr"],
                     self.traffic["schedule_iterations"], t)
        for n, g in zip(self.params, grads):
            g = g + WEIGHT_DECAY * P[n]
            self.mom[n].mul_(MOMENTUM).add_(g)
            P[n].sub_(lr * self.mom[n])

    def taken(self) -> dict:
        return {n: m.clone() for n, m in self.mom.items()}


def program_grad(state, names: list) -> dict:
    return {k: b.detach().clone()
            for k, b in zip(names, state.opt.momentum_buffers)}
