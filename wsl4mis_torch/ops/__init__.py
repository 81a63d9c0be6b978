"""Kernels (CUDA, with plain PyTorch versions) and losses of the port."""

from . import losses, ramps
from .gated_crf import gated_crf_loss

__all__ = ["gated_crf_loss", "losses", "ramps"]
