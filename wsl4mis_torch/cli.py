"""Command line of the port (port of ``wsl4mis_tpu/cli.py`` and of the JAX
package's train and test scripts under ``scripts/``).

    python -m wsl4mis_torch.cli train <script-or-method> [flags]
    python -m wsl4mis_torch.cli train_scribblevc {ACDC,MSCMR} [flags]
    python -m wsl4mis_torch.cli test [flags]
    python -m wsl4mis_torch.cli test_scribblevc {ACDC,Prostate} [flags]
    python -m wsl4mis_torch.cli val_curve LOG [LOG ...]
    python -m wsl4mis_torch.cli convert_torch_weights --torch_ckpt PTH --out F
    python -m wsl4mis_torch.cli launch [--suite S] [--methods M] [--folds F]
    python -m wsl4mis_torch.cli prepare_random_walker [--src D] [--out D]
    python -m wsl4mis_torch.cli collect_matrix [SNAPSHOT_ROOT]

``train`` takes a reference train script's name (``train_fully_supervised_2D``,
``.py`` optional) or a method name, with that script's defaults
(METHOD_DEFAULTS; a method with no script of its own takes the parser's)
and the reference flag names. ``train_scribblevc`` is
train_ACDC_scribblevc.py / train_MSCMR_scribblevc.py (epochs, AdamW's
lr), ``test`` test_2D_fully.py (``--model unet_cct``: test_2D_fully_sps.py),
``test_scribblevc`` test_ACDC_scribblevc.py / test_scribblevc.py (and, with
``--checkpoints``, test_scribblevc_multi.py), ``val_curve`` val_curve.py and
``convert_torch_weights`` convert_torch_weights.py, ``launch``
scripts/launch_experiments.py (``launch``), ``prepare_random_walker``
scripts/prepare_random_walker.py (an ACDC copy with ``random_walker``
labels, host scipy) and ``collect_matrix`` scripts/collect_matrix.py (the
fold-matrix table of the train logs; host only). Every command that runs
a model runs on the card unless given ``--device cpu``. ``train
--num_devices N`` trains data-parallel in N processes, one a card
(``parallel``; None: every visible card; with ``--device cpu``, N gloo
processes). ``train --device_data 0`` ships each step's slices from the
host in place of index batches into a stack staged on the card.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import re
import sys

import numpy as np
import torch

from . import parallel
from .engine.config import TrainConfig
from .engine.methods import available_methods, get_method
from .engine.trainer import Trainer
from .data.acdc import (
    AcdcVolumeDataset,
    default_acdc_root,
    maag_test_ids,
    prostate_fold_ids,
)
from .eval.infer import (
    InferenceConfig,
    load_scribblevc,
    run_inference,
    score_scribblevc,
)
from .utils.checkpoint import load_model_checkpoint, save_checkpoint

# The DEFAULTS and METHOD of each scripts/train_*.py of the JAX package,
# keyed by the script's name.
METHOD_DEFAULTS = {
    "train_fully_supervised_2D": ("fully_supervised", {
        "exp": "ACDC", "fold": "fold5", "sup_type": "label",
        "batch_size": 16, "base_lr": 0.03, "max_iterations": 30000,
        "seed": 2022}),
    "train_weakly_supervised_pCE_2D": ("pce", {
        "exp": "ACDC_pCE", "fold": "fold1", "sup_type": "scribble",
        "batch_size": 24, "base_lr": 0.03, "max_iterations": 30000,
        "seed": 2022}),
    "train_weakly_supervised_segmentation_pCE_ours_proposed": ("dmpls", {
        "exp": "ACDC/pCE_SPS", "fold": "fold1", "sup_type": "scribble",
        "model": "unet_cct", "batch_size": 6, "base_lr": 0.01,
        "max_iterations": 60000, "seed": 2022}),
    "train_weakly_supervised_pCE_TV_2D": ("pce_tv", {
        "exp": "ACDC_pCE_TV", "fold": "fold1", "sup_type": "scribble",
        "batch_size": 24, "base_lr": 0.01, "max_iterations": 30000,
        "seed": 1337}),
    "train_weakly_supervised_pCE_Entropy_Mini_2D": ("pce_entropy_mini", {
        "exp": "ACDC_pCE_Entropy_Mini", "fold": "fold1",
        "sup_type": "scribble", "batch_size": 24, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022}),
    "train_weakly_supervised_pCE_GatedCRFLoss_2D": ("pce_gatedcrf", {
        "exp": "ACDC_pCE_GatedCRFLoss", "fold": "fold1",
        "sup_type": "scribble", "batch_size": 6, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022}),
    "train_weakly_supervised_pCE_MumfordShah_Loss_2D": ("pce_mumford_shah", {
        "exp": "ACDC_pCE_MumfordShah_Loss", "fold": "fold1",
        "sup_type": "scribble", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 60000, "seed": 2022}),
    "train_weakly_supervised_pCE_Intensity_Variance_2D": (
        "pce_intensity_variance", {
            "exp": "ACDC_pCE_Inter_Intra_Class", "fold": "fold1",
            "sup_type": "scribble", "batch_size": 24, "base_lr": 0.01,
            "max_iterations": 30000, "seed": 2022}),
    "train_weakly_supervised_pCE_Inter&Intra_Class_2D": (
        "pce_intensity_variance", {
            "exp": "ACDC_pCE_Inter_Intra_Class", "fold": "fold1",
            "sup_type": "scribble", "batch_size": 24, "base_lr": 0.01,
            "max_iterations": 30000, "seed": 2022}),
    "train_weakly_supervised_pCE_random_walker_2D": ("pce_random_walker", {
        "exp": "ACDC/pCE_Random_Walker", "fold": "fold1",
        "sup_type": "random_walker", "batch_size": 24, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022}),
    "train_mean_teacher_2D": ("mean_teacher", {
        "exp": "ACDC_Semi/Mean_Teacher", "fold": "fold2",
        "sup_type": "label", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022, "labeled_bs": 6}),
    "train_uncertainty_aware_mean_teacher_2D": ("uamt", {
        "exp": "ACDC_Semi/Uncertainty_Aware_Mean_Teacher", "fold": "fold2",
        "sup_type": "label", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022, "labeled_bs": 6}),
    "train_entropy_minimization_2D": ("entropy_minimization", {
        "exp": "ACDC_Semi/Entropy_Minimization", "fold": "fold1",
        "sup_type": "label", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022, "labeled_bs": 6}),
    "train_partially_fully_supervised": ("partially_supervised", {
        "exp": "ACDC_Semi/Partially_Supervised", "fold": "fold1",
        "sup_type": "label", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 30000, "seed": 2022, "labeled_bs": 6}),
    "train_deep_adversarial_network_2D": ("deep_adversarial", {
        "exp": "ACDC_Semi/DAN", "fold": "fold2", "sup_type": "label",
        "batch_size": 12, "base_lr": 0.01, "max_iterations": 30000,
        "seed": 2022, "labeled_bs": 6}),
    "train_weakly_supervised_ustm_2D": ("ustm", {
        "exp": "ACDC/pCE_Seg_USTM", "fold": "fold1", "sup_type": "scribble",
        "batch_size": 12, "base_lr": 0.01, "max_iterations": 60000,
        "seed": 2022}),
    "train_s2l": ("s2l", {
        "exp": "ACDC/pCE_scribble2label", "fold": "fold1",
        "sup_type": "scribble", "batch_size": 12, "base_lr": 0.01,
        "max_iterations": 60000, "seed": 1337, "labeled_bs": 6}),
}


def build_parser(defaults: dict) -> argparse.ArgumentParser:
    """The train scripts' flags (wsl4mis_tpu/cli.py:20-74, the reference's
    names) with `defaults`, less the TPU-only --fast_prng, plus
    --device."""
    p = argparse.ArgumentParser()
    add = p.add_argument
    add("--root_path", type=str, default=defaults.get("root_path"),
        help="ACDC data root (default: auto-discover)")
    add("--exp", type=str, default=defaults.get("exp", "ACDC"))
    add("--fold", type=str, default=defaults.get("fold", "fold1"))
    add("--sup_type", type=str, default=defaults.get("sup_type", "label"))
    add("--model", type=str, default=defaults.get("model", "unet"))
    add("--num_classes", type=int, default=4)
    add("--max_iterations", type=int,
        default=defaults.get("max_iterations", 30000))
    add("--batch_size", type=int, default=defaults.get("batch_size", 16))
    add("--deterministic", type=int, default=1,
        help="1: deterministic cuDNN, no autotuning; 0: autotuned")
    add("--base_lr", type=float, default=defaults.get("base_lr", 0.03))
    add("--patch_size", type=str, default="[256, 256]",
        help="patch size, e.g. [256,256]")
    add("--seed", type=int, default=defaults.get("seed", 2022))
    # semi-supervised / method-specific flags (harmless elsewhere)
    add("--labeled_bs", type=int, default=defaults.get("labeled_bs", 6))
    add("--ema_decay", type=float, default=0.99)
    add("--consistency", type=float, default=0.1)
    add("--consistency_rampup", type=float, default=200.0)
    add("--thr_iter", type=int, default=6000)
    add("--thr_conf", type=float, default=0.8)
    add("--period_iter", type=int, default=100)
    add("--alpha", type=float, default=0.2)
    # run knobs
    add("--val_every", type=int, default=200)
    add("--ckpt_every", type=int, default=3000)
    add("--log_every", type=int, default=1)
    add("--steps_per_call", type=int, default=1,
        help="fuse K train steps per call (on the card: a captured CUDA "
             "graph replayed K times)")
    add("--compute_dtype", type=str, default="bfloat16",
        choices=["bfloat16", "float32"])
    add("--snapshot_root", type=str, default="model")
    add("--resume", action="store_true")
    add("--profile_steps", type=int, default=0)
    add("--data_limit", type=int, default=None)
    add("--aug_mode", type=str, default="device", choices=["device", "host"],
        help="device: in-step augmentation; host: exact reference "
             "augment-then-zoom semantics on the host")
    add("--device_data", type=int, default=1,
        help="1: stage the dataset in device HBM (index batches); 0: ship "
             "host image batches per step")
    add("--remat", type=int, default=0,
        help="1: checkpoint ScribbleVC's Conformer stages (memory for a "
             "forward of them)")
    add("--encoder_weights", type=str, default=None,
        help="efficient_unet: a converted encoder file "
             "(convert_torch_weights)")
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    add("--num_devices", type=int, default=None,
        help="data-parallel processes, one a card (default: every visible "
             "card; on the CPU, gloo processes, default 1)")
    return p


def config_from_args(args, method: str) -> TrainConfig:
    root = args.root_path
    if root is not None and not os.path.isdir(root):
        logging.warning("root_path %s not found; auto-discovering", root)
        root = None
    return TrainConfig(
        root_path=root,
        exp=args.exp,
        fold=args.fold,
        sup_type=args.sup_type,
        model=args.model,
        num_classes=args.num_classes,
        max_iterations=args.max_iterations,
        batch_size=args.batch_size,
        base_lr=args.base_lr,
        patch_size=tuple(ast.literal_eval(args.patch_size)),
        seed=args.seed,
        labeled_bs=args.labeled_bs,
        ema_decay=args.ema_decay,
        consistency=args.consistency,
        consistency_rampup=args.consistency_rampup,
        thr_iter=args.thr_iter,
        thr_conf=args.thr_conf,
        period_iter=args.period_iter,
        alpha=args.alpha,
        method=method,
        val_every=args.val_every,
        ckpt_every=args.ckpt_every,
        log_every=args.log_every,
        steps_per_call=args.steps_per_call,
        compute_dtype=args.compute_dtype,
        snapshot_root=args.snapshot_root,
        resume=args.resume,
        profile_steps=args.profile_steps,
        data_limit=args.data_limit,
        aug_mode=args.aug_mode,
        device_data=bool(args.device_data),
        remat=bool(args.remat),
        device=args.device,
        num_devices=args.num_devices,
        encoder_weights=args.encoder_weights,
    )


def set_deterministic(deterministic: int) -> None:
    """cuDNN as the reference scripts set it from --deterministic."""
    torch.backends.cudnn.benchmark = not deterministic
    torch.backends.cudnn.deterministic = bool(deterministic)


def make_trainer(method: str, defaults: dict, argv=None) -> Trainer:
    """The Trainer train_main runs: argv parsed over `defaults`, the
    method's bundle built from the data on disk."""
    args = build_parser(defaults).parse_args(argv)
    cfg = config_from_args(args, method)
    set_deterministic(args.deterministic)
    trainer = Trainer(cfg, get_method(method).build(cfg))
    logging.info(str(args))
    return trainer


def train_main(method: str, defaults: dict, argv=None) -> str:
    """The train command: one process, or --num_devices ranks spawned
    (``_train_rank``), each a card's (or a gloo CPU process's)."""
    args = build_parser(defaults).parse_args(argv)
    n = parallel.visible_cards(args.device, args.num_devices)
    if n == 1:
        return make_trainer(method, defaults, argv).train()
    parallel.spawn(_train_rank, n, args.device,
                   args=(method, defaults, argv))
    return "Training Finished!"


def _train_rank(rank: int, method: str, defaults: dict, argv) -> None:
    make_trainer(method, defaults, argv).train()


def resolve_script(name: str) -> tuple[str, dict]:
    """(method, defaults) of a train script's name (a path or ``.py``
    allowed) or of a method name (its script's defaults; none for a
    method with no script of its own, scribblevc)."""
    stem = os.path.basename(name)
    stem = stem[:-3] if stem.endswith(".py") else stem
    if stem in METHOD_DEFAULTS:
        return METHOD_DEFAULTS[stem]
    if stem in available_methods():
        for method, defaults in METHOD_DEFAULTS.values():
            if method == stem:
                return method, defaults
        return stem, {}
    raise SystemExit(f"unknown train script or method {name!r}; scripts: "
                     f"{sorted(METHOD_DEFAULTS)}; methods: "
                     f"{available_methods()}")


def scribblevc_parser(dataset: str) -> argparse.ArgumentParser:
    """The flags of scripts/train_{ACDC,MSCMR}_scribblevc.py, plus
    --device. MSCMR trains on MSCMRfold and has no fold, steps-per-call,
    remat, warm start, light validation, resume or checkpoint cadence
    flag."""
    acdc = dataset == "ACDC"
    p = argparse.ArgumentParser(prog=f"train_scribblevc {dataset}")
    add = p.add_argument
    add("--root_path", type=str, default=None)
    add("--exp", type=str, default=f"{dataset}_ScribbleVC")
    if acdc:
        add("--fold", type=str, default="MAAGfold")
    add("--sup_type", type=str, default="scribble")
    add("--num_classes", type=int, default=4)
    add("--batch_size", type=int, default=6)
    add("--max_epoches", type=int, default=200)
    add("--val_every_epoches", type=int, default=1)
    add("--lr", type=float, default=5e-4)
    add("--seed", type=int, default=2022)
    add("--patch_size", type=str, default="[256, 256]")
    add("--compute_dtype", type=str, default="bfloat16")
    add("--snapshot_root", type=str, default="model")
    add("--data_limit", type=int, default=None)
    if acdc:
        add("--steps_per_call", type=int, default=1,
            help="K train steps per call (on the card: captured CUDA "
                 "graphs, one for each side of the memory gate)")
        add("--remat", type=int, default=0,
            help="1: checkpoint the Conformer stages (memory for a "
                 "forward of them)")
        add("--pretrain_weights", type=str, default="",
            help="checkpoint to warm-start from, the port's or the JAX "
                 "package's (reference train_ACDC_scribblevc.py:154-156)")
        add("--light_val", type=int, default=0,
            help="1: skip the train-rule validation pass")
        add("--resume", type=int, default=0,
            help="1: resume from latest_full.ckpt if present")
        add("--ckpt_epoches", type=int, default=100,
            help="full-state checkpoint cadence in epochs")
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def scribblevc_main(argv, dataset: str) -> str:
    """train_{ACDC,MSCMR}_scribblevc.py: the epoch counts become steps once
    the bundle knows its steps per epoch (train_ACDC_scribblevc.py:80-89)."""
    args = scribblevc_parser(dataset).parse_args(argv)
    acdc = dataset == "ACDC"
    cfg = TrainConfig(
        root_path=args.root_path, exp=args.exp,
        fold=args.fold if acdc else "MSCMRfold", sup_type=args.sup_type,
        model="scribblevc", num_classes=args.num_classes,
        batch_size=args.batch_size, base_lr=args.lr,
        patch_size=tuple(ast.literal_eval(args.patch_size)), seed=args.seed,
        method="scribblevc", compute_dtype=args.compute_dtype,
        snapshot_root=args.snapshot_root, data_limit=args.data_limit,
        remat=acdc and bool(args.remat), device=args.device,
        max_iterations=1)
    bundle = get_method("scribblevc").build(cfg)
    if acdc and args.pretrain_weights:
        load_model_checkpoint(args.pretrain_weights, bundle.model)
        print("Load pretrain weight from", args.pretrain_weights)
    spe = bundle.steps_per_epoch
    cfg = cfg.replace(
        max_iterations=args.max_epoches * spe,
        val_every=args.val_every_epoches * spe,
        ckpt_every=(args.ckpt_epoches if acdc else 100) * spe,
        light_val=acdc and bool(args.light_val),
        resume=acdc and bool(args.resume),
        steps_per_call=args.steps_per_call if acdc else 1)
    return Trainer(cfg, bundle).train()


def test_parser() -> argparse.ArgumentParser:
    """The flags of scripts/test_2D_fully.py, plus --device."""
    p = argparse.ArgumentParser(prog="test")
    add = p.add_argument
    add("--root_path", type=str, default=None)
    add("--exp", type=str, default="ACDC/WeaklySeg_pCE_MumfordShah_Loss")
    add("--model", type=str, default="unet")
    add("--fold", type=str, default="all",
        help="'all' = 5-fold sweep, or a single foldK")
    add("--num_classes", type=int, default=4)
    add("--sup_type", type=str, default="scribble")
    add("--snapshot_root", type=str, default="model")
    add("--checkpoint", type=str, default="iter_60000.pth")
    add("--raw_data_path", type=str, default=None)
    add("--no_save", action="store_true")
    add("--compute_dtype", type=str, default="bfloat16")
    add("--data_limit", type=int, default=None)
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def inference_config(args) -> InferenceConfig:
    return InferenceConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        sup_type=args.sup_type, num_classes=args.num_classes,
        snapshot_root=args.snapshot_root, checkpoint=args.checkpoint,
        raw_data_path=args.raw_data_path, save_predictions=not args.no_save,
        compute_dtype=args.compute_dtype,
        folds=InferenceConfig.folds if args.fold == "all" else (args.fold,),
        data_limit=args.data_limit, device=args.device)


def test_main(argv=None) -> float:
    """The fold sweep of test_2D_fully.py; the mean Dice over the folds."""
    return run_inference(inference_config(test_parser().parse_args(argv)))


def scribblevc_test_parser(dataset: str) -> argparse.ArgumentParser:
    """The flags of scripts/test_ACDC_scribblevc.py (ACDC, plus
    --checkpoints: test_scribblevc_multi.py) or test_scribblevc.py
    (Prostate), plus --device."""
    acdc = dataset == "ACDC"
    p = argparse.ArgumentParser(prog=f"test_scribblevc {dataset}")
    add = p.add_argument
    add("--root_path", type=str, default=None if acdc else "../data/Prostate")
    add("--exp", type=str, default=f"{dataset}_ScribbleVC")
    add("--fold", type=str, default="MAAGfold" if acdc else "prostate_fold1")
    add("--sup_type", type=str, default="scribble")
    add("--num_classes", type=int, default=4 if acdc else 3)
    add("--snapshot_root", type=str, default="model")
    add("--checkpoint", type=str, default="scribblevc_best_model.pth")
    if acdc:
        add("--checkpoints", type=str, nargs="+", default=None,
            help="several checkpoints of the snapshot, one after another")
    add("--raw_data_path", type=str, default=None)
    add("--compute_dtype", type=str, default="bfloat16")
    add("--data_limit", type=int, default=None)
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def scribblevc_inference_config(args) -> InferenceConfig:
    """The offline ScribbleVC test's inference settings (spacing lookup,
    classes, device) from its parsed flags."""
    return InferenceConfig(root_path=args.root_path,
                           raw_data_path=args.raw_data_path,
                           num_classes=args.num_classes, device=args.device)


def scribblevc_checkpoints(args) -> list[str]:
    """The checkpoint files the ScribbleVC test scores, in order: each of
    --checkpoints (test_scribblevc_multi.py), else --checkpoint, in the
    snapshot {snapshot_root}/{exp}_{fold}/{sup_type}."""
    snapshot = os.path.join(args.snapshot_root, f"{args.exp}_{args.fold}",
                            args.sup_type)
    names = getattr(args, "checkpoints", None) or [args.checkpoint]
    return [os.path.join(snapshot, name) for name in names]


# test_scribblevc_multi.py scores every case at this (sz, sx, sy)
MULTI_SPACING = (10.0, 1.0, 1.0)


def scribblevc_test_volumes(args, dataset: str) -> list:
    """The offline ScribbleVC test's volumes: MAAG's 15 test patients
    (ACDC) or a prostate fold's test patients."""
    if dataset == "ACDC":
        volumes = AcdcVolumeDataset(base_dir=args.root_path,
                                    custom_patients=maag_test_ids(),
                                    limit=args.data_limit)
    else:
        volumes = AcdcVolumeDataset(
            base_dir=args.root_path,
            custom_patients=prostate_fold_ids(args.fold)[1],
            volumes_dirname="Prostate_training_volumes",
            limit=args.data_limit)
    return list(volumes)


def scribblevc_test_scores(args, volumes) -> dict:
    """{checkpoint: mean (classes-1, 3) [dice, hd95, asd]} of the parsed
    flags' checkpoints over `volumes` (score_scribblevc), each printed.
    With --checkpoints (test_scribblevc_multi.py): every case at
    MULTI_SPACING, a checkpoint the snapshot lacks printed MISSING, each
    result printed as that script prints it; else at each case's
    spacing."""
    icfg = scribblevc_inference_config(args)
    multi = getattr(args, "checkpoints", None) is not None
    results = {}
    for path in scribblevc_checkpoints(args):
        name = os.path.basename(path)
        if multi and not os.path.exists(path):
            print(name, "MISSING")
            continue
        model, memory = load_scribblevc(path, args.num_classes,
                                        args.compute_dtype, args.device)
        avg = score_scribblevc(icfg, model, memory, volumes,
                               spacing=MULTI_SPACING if multi else None)
        if multi:
            print(name, "per-class [dice hd95 asd]:")
            print(np.round(avg, 4))
            print(name, "mean:", np.round(avg.mean(axis=0), 4), flush=True)
        else:
            print(avg)
            print(avg.mean(axis=0), flush=True)
        results[name] = avg
    return results


def scribblevc_test_main(argv, dataset: str) -> dict:
    """test_scribblevc {ACDC,Prostate}: scribblevc_test_scores over
    scribblevc_test_volumes."""
    args = scribblevc_test_parser(dataset).parse_args(argv)
    return scribblevc_test_scores(args, scribblevc_test_volumes(args,
                                                                dataset))


# the Trainer's validation line (engine/trainer.py), also the JAX
# package's; hd95 is nan where a NaN-aware validation found nothing
VAL_LINE = re.compile(r"iteration (\d+) : mean_dice : (nan|[\d.]+) "
                      r"mean_hd95 : (nan|[\d.]+)")


def val_curve(path: str) -> list[tuple[int, float, float]]:
    """(iteration, mean val Dice, mean HD95) of each validation line of a
    train log."""
    pts = []
    with open(path, errors="replace") as f:
        for line in f:
            m = VAL_LINE.search(line)
            if m:
                pts.append((int(m[1]), float(m[2]), float(m[3])))
    return pts


def val_curve_main(paths) -> None:
    """scripts/val_curve.py: per log the best and the final val Dice and a
    curve of about 20 points."""
    for path in paths:
        pts = val_curve(path)
        print(f"== {path}: {len(pts)} val points ==")
        if not pts:
            continue
        best = max(pts, key=lambda p: p[1])
        print(f"best  iter {best[0]:6d}  dice {best[1]:.4f}  "
              f"hd95 {best[2]:.2f}")
        print(f"final iter {pts[-1][0]:6d}  dice {pts[-1][1]:.4f}  "
              f"hd95 {pts[-1][2]:.2f}")
        step = max(1, len(pts) // 20)
        for i, (it, d, h) in enumerate(pts):
            if i % step == 0 or i == len(pts) - 1:
                print(f"  {it:6d}  {d:.4f}  {h:7.2f}")


def convert_parser() -> argparse.ArgumentParser:
    """The flags of scripts/convert_torch_weights.py."""
    p = argparse.ArgumentParser(prog="convert_torch_weights")
    add = p.add_argument
    add("--torch_ckpt", type=str, required=True,
        help="efficientnet_pytorch state_dict (.pth)")
    add("--model_name", type=str, default="efficientnet-b3")
    add("--in_channels", type=int, default=1)
    add("--out", type=str, required=True, help="output .msgpack path")
    return p


def convert_main(argv=None) -> str:
    """An efficientnet_pytorch state_dict to the flax msgpack encoder file
    that --encoder_weights reads, in either package: {"encoder_params",
    "encoder_batch_stats", "in_channels"}."""
    from .utils.params import _flatten
    from .utils.torch_import import convert_efficientnet_encoder

    args = convert_parser().parse_args(argv)
    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    params, stats = convert_efficientnet_encoder(sd, args.model_name,
                                                 args.in_channels)
    save_checkpoint(args.out, {
        "encoder_params": params, "encoder_batch_stats": stats,
        "in_channels": np.asarray(args.in_channels, np.int32)})
    n = sum(v.size for _, v in _flatten(params))
    print(f"wrote {args.out}: {n / 1e6:.2f}M encoder params "
          f"({args.model_name}, in_channels={args.in_channels})")
    return args.out


def prepare_random_walker_parser() -> argparse.ArgumentParser:
    """The flags of scripts/prepare_random_walker.py."""
    p = argparse.ArgumentParser(prog="prepare_random_walker")
    add = p.add_argument
    add("--src", type=str, default=None, help="bundled ACDC root")
    add("--out", type=str, default="data/ACDC_rw")
    add("--limit", type=int, default=None,
        help="only copy/process the first N slice files")
    add("--cases", type=str, default=None,
        help="comma-separated patient ids (e.g. patient021)")
    return p


def prepare_random_walker_main(argv=None) -> int:
    """A writable ACDC copy at --out with a ``random_walker`` label in
    every slice and volume file (data/random_walker.py); the number of
    slices solved, printed as the script prints it."""
    from .data.random_walker import prepare_random_walker_tree

    args = prepare_random_walker_parser().parse_args(argv)
    src = args.src or default_acdc_root()
    cases = args.cases.split(",") if args.cases else None
    n = prepare_random_walker_tree(src, args.out, limit=args.limit,
                                   cases=cases)
    print(f"done: {n} slices solved -> {args.out}")
    return n


# scripts/collect_matrix.py's match of a validation line (a NaN Dice is
# none)
DICE_LINE = re.compile(r"iteration (\d+) : mean_dice : ([0-9.]+)")


def cell_stats(log_path: str):
    """((best val Dice, its iteration), (last val Dice, its iteration)) of
    a train log; (0.0, 0) where it holds none."""
    best = last = (0.0, 0)
    with open(log_path) as f:
        for line in f:
            m = DICE_LINE.search(line)
            if m:
                it, d = int(m[1]), float(m[2])
                last = (d, it)
                if d > best[0]:
                    best = (d, it)
    return best, last


def collect_matrix_main(root: str = "model/r5_matrix") -> None:
    """scripts/collect_matrix.py: from {root}/{exp}_{fold}/{sup_type}/
    log.txt, a markdown table of each method's best val Dice per fold
    (with its iteration and the final Dice) and their mean +/- std."""
    import glob

    cells = {}
    for log in sorted(glob.glob(os.path.join(root, "*", "*", "log.txt"))):
        run = os.path.basename(os.path.dirname(os.path.dirname(log)))
        m = re.match(r"(.+)_(fold\d)$", run)
        if m:
            cells.setdefault(m[1], {})[m[2]] = cell_stats(log)
    if not cells:
        print(f"no cells under {root}")
        return
    folds = [f"fold{i}" for i in range(1, 6)]
    print("| method | " + " | ".join(folds) + " | mean +/- std (best val) |")
    print("|---|" + "---|" * (len(folds) + 1))
    for exp in sorted(cells):
        row, vals = [], []
        for f in folds:
            if f in cells[exp]:
                (b, bi), (last, _) = cells[exp][f]
                row.append(f"{b:.4f} (it{bi}; fin {last:.4f})")
                vals.append(b)
            else:
                row.append("—")
        agg = "—"
        if vals:
            mean = sum(vals) / len(vals)
            std = (sum((v - mean) ** 2 for v in vals) / len(vals)) ** 0.5
            agg = f"{mean:.4f} +/- {std:.4f} ({len(vals)}/5 folds)"
        print(f"| {exp} | " + " | ".join(row) + f" | {agg} |")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    command = argv[0] if argv else None
    if command == "train" and len(argv) > 1:
        print(train_main(*resolve_script(argv[1]), argv[2:]))
    elif command == "train_scribblevc" and argv[1:2] in (["ACDC"],
                                                          ["MSCMR"]):
        print(scribblevc_main(argv[2:], argv[1]))
    elif command == "test":
        test_main(argv[1:])
    elif command == "test_scribblevc" and argv[1:2] in (["ACDC"],
                                                         ["Prostate"]):
        scribblevc_test_main(argv[2:], argv[1])
    elif command == "val_curve":
        val_curve_main(argv[1:])
    elif command == "convert_torch_weights":
        convert_main(argv[1:])
    elif command == "prepare_random_walker":
        prepare_random_walker_main(argv[1:])
    elif command == "collect_matrix" and len(argv) <= 2:
        collect_matrix_main(*argv[1:])
    elif command == "launch":
        from . import launch

        raise SystemExit(launch.main(argv[1:]))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
