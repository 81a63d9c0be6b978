"""The reference's training steps: the reference scripts' loop of one
batch, augmented, through the model and the method's loss, then the
method's optimizer (``optimizers/<name>.py``'s ``Reference``)."""

from __future__ import annotations

import torch

from . import draws
from .augment import augment


def follow(model, method, optimizer, config, traffic, weights, leaves,
           batches, seed, device, prec) -> dict:
    """Run len(batches) steps from `weights` on `batches` [(images (B,H,W)
    f32, labels (B,H,W) int)] with step t's draws from (seed, t).
    Returns {"loss": [...], "grad": the gradient the optimizer took at
    the first update, by leaf, "raw_grad_norms": the first gradient's norm
    by parameter, "change": each leaf's change over the steps}."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    params = [n for n, _, _, kind in leaves if kind == "param"]
    for n in params:
        P[n].requires_grad_(True)
    opt = optimizer.Reference(P, params, traffic)
    out = {"loss": []}
    for t, (images, labels) in enumerate(batches):
        gens = draws.step_generators(seed, t, device)
        pol = draws.policy(gens["aug"], images.shape[0], device)
        x, y = augment(images, labels.to(torch.int32), pol)
        with prec:
            loss = method.loss(model, P, x[..., None], y, config, gens, prec)
            grads = torch.autograd.grad(loss, [P[n] for n in params])
        out["loss"].append(float(loss.detach()))
        opt.update(P, grads, t)
        if t == 0:
            out["grad"] = opt.taken()
            out["raw_grad_norms"] = {n: float(g.double().norm())
                                     for n, g in zip(params, grads)}
        del grads, loss
    out["change"] = {k: (P[k].detach() - weights[k]) for k in weights}
    return out
