#!/usr/bin/env python3
"""The JAX package's run of chip_smoke.py's learning check, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_learning_check.py [--hw 128]
        [--half_width] [--port_init] [--out DIR] [--package jax|torch]

Writes the synthetic phantoms chip_smoke trains on (480 slices from seed
0, two validation volumes from seed 1; ``wsl4mis_torch.data.synthetic``)
as an ACDC H5 tree, then trains through the JAX package's train command
line what chip_smoke's LEARN_RUNS train through the port's:
fully_supervised (UNet, batch 24, 200 steps) and dmpls (UNet_CCT, batch
6, 300 steps), each validated at half and at the end. Prints one JSON
line: the mean val Dice of every validation. By default the slices are
128x128 (the volumes 108x128) and the compute float32, so that the run
fits the CPU; ``--hw 256`` gives chip_smoke's size, and ``--half_width``
halves the models' features (8..128) to keep that size within the CPU's
reach. ``--package torch`` runs the port's train command instead (on the
CPU, float32), as a control at the same size; ``--port_init`` starts the
JAX model from the port's initial weights for the same seed (both
packages draw torch's default init, each from its own generator), so
that the two runs differ only in their random draws.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RUNS = (("train_fully_supervised_2D", 24, 200),
        ("train_weakly_supervised_segmentation_pCE_ours_proposed", 6, 300))


def half_width(package):
    """Both packages' method bundles build their UNet / UNet_CCT with
    features (8, 16, 32, 64, 128)."""
    features = (8, 16, 32, 64, 128)
    if package == "torch":
        import functools

        import wsl4mis_torch.engine.methods.common as common

        common.net_factory = functools.partial(common.net_factory,
                                               features=features)
        return
    import wsl4mis_tpu.engine.methods.common as common
    import wsl4mis_tpu.models.unet as unet

    def net_factory(name, classes, dtype):
        cls = {"unet": unet.UNet, "unet_cct": unet.UNetCCT}[name]
        return cls(num_classes=classes, features=features, dtype=dtype)

    common.net_factory = net_factory


def port_init(state, model_name, seed, half):
    """state with the port's initial params and BN statistics for
    `model_name` and `seed` (as the port's make_model_and_state draws
    them), renamed onto the flax tree (utils.params' renaming)."""
    import jax.numpy as jnp
    import torch

    from wsl4mis_torch.models import net_factory
    from wsl4mis_torch.utils.params import _torch_key

    kw = {"features": (8, 16, 32, 64, 128)} if half else {}
    sd = net_factory(model_name, 4, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(seed),
                     **kw).state_dict()

    def fill(tree, prefix=()):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else jnp.asarray(sd[_torch_key(prefix + (k,))].numpy())
                for k, v in tree.items()}

    return state.replace(params=fill(state.params),
                         batch_stats=fill(state.batch_stats))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "jax_learning_check"))
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("--half_width", action="store_true")
    ap.add_argument("--port_init", action="store_true")
    args = ap.parse_args(argv)
    if args.half_width:
        half_width(args.package)

    import chip_smoke
    from wsl4mis_torch import cli
    from wsl4mis_torch.data import synthetic_slices, synthetic_volumes

    if args.package == "jax":
        from wsl4mis_tpu.cli import build_parser, config_from_args
        from wsl4mis_tpu.engine.methods import get_method
        from wsl4mis_tpu.engine.trainer import Trainer

    hw = args.hw
    data = synthetic_slices(480, (hw, hw), seed=0)
    scribbles = synthetic_slices(480, (hw, hw), seed=0, sup_type="scribble")
    val = synthetic_volumes(2, 10, hw * 216 // 256, hw, seed=1)
    out = {"package": args.package, "hw": hw, "compute_dtype": "float32",
           "half_width": args.half_width, "port_init": args.port_init,
           "runs": []}
    for script, batch, steps in RUNS:
        method, defaults = cli.METHOD_DEFAULTS[script]
        tree = chip_smoke.write_h5_tree(
            os.path.join(args.out, f"{method}_data"), data, scribbles, val,
            defaults["fold"])
        argv = chip_smoke.entry_argv(batch, steps, steps // 2, args.out, 0,
                                     hw=hw)
        argv += ["--root_path", tree, "--compute_dtype", "float32"]
        if args.package == "torch":
            trainer = cli.make_trainer(method, defaults,
                                       argv + ["--device", "cpu"])
        else:
            cfg = config_from_args(build_parser(defaults).parse_args(argv),
                                   method)
            bundle = get_method(method).build(cfg)
            if args.port_init:
                model_name = "unet_cct" if method == "dmpls" else cfg.model
                bundle.state = port_init(bundle.state, model_name, cfg.seed,
                                         args.half_width)
            trainer = Trainer(cfg, bundle, use_tensorboard=False)
        dice = []
        validate = trainer.validate
        trainer.validate = lambda it: dice.append(validate(it)) or dice[-1]
        t0 = time.perf_counter()
        trainer.train()
        out["runs"].append({"method": method, "batch": batch,
                            "steps": steps,
                            "val_dice": [d for d, _ in dice],
                            "seconds": time.perf_counter() - t0})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
