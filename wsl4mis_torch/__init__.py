"""wsl4mis_torch: the PyTorch / CUDA port of wsl4mis_tpu for NVIDIA Hopper.

The JAX package ``wsl4mis_tpu`` beside it is the reference this package is
checked against; nothing here imports it (or JAX). Tensors are NHWC at the
public functions, conv weights HWIO, as in the JAX package. Entry points
take an explicit device and default to ``"cuda"``; the 3x3 convolutions,
the batch augmentation, the 2x2 max pool and the Gated CRF contraction
run in hand-written kernels (``csrc/``) that build with nvcc at first use.

Ported so far: the 2D U-Net training paths of fully_supervised, pce, dmpls,
the five pCE + regularizer methods, the semi-supervised mean_teacher, uamt,
entropy_minimization, partially_supervised and deep_adversarial, and ustm,
through ``engine.methods.get_method(name).build(cfg)`` and
``engine.trainer.Trainer(cfg, bundle).train()``.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
