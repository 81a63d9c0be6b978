"""wsl4mis_torch: the PyTorch / CUDA port of wsl4mis_tpu for NVIDIA Hopper.

The JAX package ``wsl4mis_tpu`` beside it is the reference this package is
checked against; nothing here imports it (or JAX). Tensors are NHWC at the
public functions, conv weights HWIO, as in the JAX package. Entry points
take an explicit device and default to ``"cuda"``; the 3x3 convolutions,
the batch augmentation, the 2x2 max pool and the Gated CRF contraction
run in hand-written kernels (``csrc/``) that build with nvcc at first use.

Ported: all 17 training methods of the JAX package (the U-Net family's,
the semi-supervised ones, ustm, s2l, pce_random_walker and ScribbleVC),
through ``engine.methods.get_method(name).build(cfg)`` and
``engine.trainer.Trainer(cfg, bundle).train()``.
"""

from .utils.device import resolve_device

__all__ = ["TrainConfig", "Trainer", "get_method", "net_factory",
           "resolve_device"]

# name -> module of the lazy exports (PEP 562), as the JAX package's: the
# package's import loads no engine, model or kernel module
_LAZY = {"TrainConfig": "engine.config", "Trainer": "engine.trainer",
         "get_method": "engine.methods", "net_factory": "models"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f".{_LAZY[name]}", __name__), name)
