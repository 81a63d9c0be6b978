"""The reference of the validation pass (val_2D.test_single_volume): each
slice order-0 zoomed to the patch size (scipy.ndimage.zoom, order 0:
source index round(i * (n_in - 1) / (n_out - 1)), halves up), the
network in eval mode, and its output zoomed back to the slice's size the
same way. Here the logits come back, not their argmax: the benchmark
judges the program's class map by them."""

from __future__ import annotations

import torch


def zoom_index(n_out: int, n_in: int, device) -> torch.Tensor:
    if n_out == 1:
        return torch.zeros(1, dtype=torch.long, device=device)
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor(i * ((n_in - 1) / (n_out - 1)) + 0.5).long().clamp(
        0, n_in - 1)


def zoom(stack: torch.Tensor, out_hw) -> torch.Tensor:
    """stack (D, H, W, ...) order-0 zoomed to (D, *out_hw, ...)."""
    h, w = stack.shape[1:3]
    oh, ow = out_hw
    rows = zoom_index(oh, h, stack.device)
    cols = zoom_index(ow, w, stack.device)
    return stack[:, rows][:, :, cols]


def volume_logits(model, P, image, config, prec, block: int = 64):
    """(D, H, W, classes) f32 logits of one volume (D, H, W) at its own
    size, slices run `block` at a time."""
    patch = config["patch_size"]
    x = zoom(image, patch)[..., None]
    outs = []
    with torch.no_grad(), prec:
        for s in range(0, x.shape[0], block):
            out = model.forward(P, x[s:s + block], config, False, None, prec)
            outs.append(out[0] if isinstance(out, tuple) else out)
    return zoom(torch.cat(outs), image.shape[1:3])
