"""SGD, Adam and AdamW with the reference semantics (port of
``wsl4mis_tpu/engine/optim.py`` and of the optax transforms the JAX
methods use).

torch.optim.SGD(momentum=0.9, weight_decay=1e-4) with poly decay: the
weight decay is added to the gradient before the momentum accumulation,
and update t (counted from 0) uses lr = base * (1 - t/max)^0.9, computed
in float32 as the JAX package's optax schedule does. The learning rate is
set per update here rather than through LambdaLR, whose step count is one
off from optax's.

Each optimizer also reads and writes its state in the layout flax writes
the optax state of the JAX package's optimizer (``optax_state`` /
``load_optax_state``; a tuple of a chain as {"0": ..., "1": ...}, an
EmptyState as {}, a count as a 0-d int32 array). The trees of the
params' structure (momentum trace, Adam's moments) go through `to_tree` /
`from_tree`, the flax bridge of ``utils.params``, with the optimizer's
parameters named by `names`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.params import check_keys, copy_named


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _load_count(tree, where: str) -> int:
    count = np.asarray(tree)
    if count.shape != ():
        raise KeyError(f"{where}: a count of shape {count.shape}")
    return int(count)


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

    def optax_state(self, names, to_tree) -> dict:
        """reference_sgd's state: chain(add_decayed_weights (EmptyState),
        chain(trace, scale_by_schedule))."""
        trace = to_tree(dict(zip(names, self.momentum_buffers)))
        return {"0": {}, "1": {"0": {"trace": trace},
                               "1": {"count": _count(self.count)}}}

    def load_optax_state(self, tree, names, from_tree) -> None:
        check_keys(tree, ("0", "1"), "opt_state (SGD)")
        check_keys(tree["0"], (), "opt_state/0 (add_decayed_weights)")
        check_keys(tree["1"], ("0", "1"), "opt_state/1 (sgd)")
        check_keys(tree["1"]["0"], ("trace",), "opt_state/1/0 (trace)")
        check_keys(tree["1"]["1"], ("count",), "opt_state/1/1 (schedule)")
        copy_named(dict(zip(names, self.momentum_buffers)),
                   from_tree(tree["1"]["0"]["trace"]), "opt_state trace")
        self.count = _load_count(tree["1"]["1"]["count"],
                                 "opt_state/1/1/count")


def adam_init(params: dict[str, torch.Tensor]) -> dict:
    """Adam's state for `params`: the update count and both moments, as
    tensors in dicts (a train state's extra, checkpointed as it is)."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def _adam_update(p: list, g: list, mu: list, nu: list, count: int,
                 lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float = 0.0) -> None:
    """Update `count` (from 1) of optax's adam / adamw over lists of
    tensors, in place on `p`, `mu` and `nu`:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2
        p  = p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

    with mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t). Each product
    rounded apart, as optax's expressions; 1 - b in double, then f32 (its
    Python-float arithmetic), the bias corrections in f32 (its f32 power
    of the count)."""
    t = np.float32(count)
    one = np.float32(1.0)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1.0 - b2)
    torch._foreach_add_(nu, sq)
    upd = torch._foreach_div(mu, float(one - np.float32(b1) ** t))
    denom = torch._foreach_div(nu, float(one - np.float32(b2) ** t))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(p, upd)


def adam_optax_state(state: dict, to_tree, chained: int = 1) -> dict:
    """`state` (adam_init's dict, or ReferenceAdamW's moments) as flax
    writes optax's adam (chain(scale_by_adam, scale_by_learning_rate):
    chained = 1) or adamw (chained = 2: add_decayed_weights between)."""
    out = {"0": {"count": _count(state["count"]), "mu": to_tree(state["mu"]),
                 "nu": to_tree(state["nu"])}}
    out.update({str(i + 1): {} for i in range(chained)})
    return out


def load_adam_optax_state(state: dict, tree, from_tree,
                          chained: int = 1) -> None:
    """The inverse of adam_optax_state, into `state`'s tensors in place."""
    check_keys(tree, [str(i) for i in range(chained + 1)], "opt_state (adam)")
    for i in range(chained):
        check_keys(tree[str(i + 1)], (), f"opt_state/{i + 1}")
    check_keys(tree["0"], ("count", "mu", "nu"), "opt_state/0 (scale_by_adam)")
    for k in ("mu", "nu"):
        copy_named(state[k], from_tree(tree["0"][k]), f"opt_state {k}")
    state["count"] = _load_count(tree["0"]["count"], "opt_state/0/count")


def reference_adam(params: dict[str, torch.Tensor],
                   grads: dict[str, torch.Tensor], state: dict,
                   lr: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
                   eps: float = 1e-8) -> None:
    """One update of torch.optim.Adam(lr, betas=(b1, b2), eps) =
    optax.adam(lr, b1, b2, eps), the DAN discriminator's optimizer
    (train_deep_adversarial_network_2D.py:111-112), in place on `params`
    and `state`, in optax's order: mu_hat / (sqrt(nu_hat) + eps)."""
    names = list(params)
    state["count"] += 1
    _adam_update([params[k] for k in names], [grads[k] for k in names],
                 [state["mu"][k] for k in names],
                 [state["nu"][k] for k in names], state["count"], lr, b1, b2,
                 eps)


class ReferenceAdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) at a constant learning
    rate, ScribbleVC's optimizer (AdamW(5e-4, wd 5e-4, eps 1e-8),
    train_ACDC_scribblevc.py:146-147), with ReferenceSGD's interface
    (`schedule` included): the update of `_adam_update` with the decay on
    every parameter (no mask: BN scale and bias and the cls token too).
    Not torch.optim.AdamW, which decays the parameter before the Adam step
    and so rounds in another order."""

    def __init__(self, params, lr: float = 5e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 5e-4):
        self.params = list(params)
        self.lr = lr
        self.schedule = lambda count: lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.count += 1
        _adam_update(self.params, grads, self.mu, self.nu, self.count,
                     self.lr, self.b1, self.b2, self.eps, self.weight_decay)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for bufs, saved in ((self.mu, state["mu"]),
                                (self.nu, state["nu"])):
                for buf, v in zip(bufs, saved):
                    buf.copy_(v)

    def _named(self, names) -> dict:
        return {"count": self.count, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu))}

    def optax_state(self, names, to_tree) -> dict:
        """optax.adamw's state: chain(scale_by_adam, add_decayed_weights,
        scale_by_learning_rate), the last two EmptyStates."""
        return adam_optax_state(self._named(names), to_tree, chained=2)

    def load_optax_state(self, tree, names, from_tree) -> None:
        named = self._named(names)
        load_adam_optax_state(named, tree, from_tree, chained=2)
        self.count = named["count"]
