"""ScribbleVC training (port of ``wsl4mis_tpu/engine/methods/scribblevc.py``;
the reference's train_ACDC_scribblevc.py:120-320), on ``models.scribblevc``:

    loss_ce  = 0.5 * (CE(seg_conv) + CE(seg_trans)), ignore 0 on dense
               labels (sup_type "label"), else 4
    pseudo   = argmax((min(p1, p2) > 0.5) * (beta p1 + (1 - beta) p2)),
               p1, p2 the detached softmaxes
    loss_pse = 0.5 * (pDice(p1, pseudo) + pDice(p2, pseudo)), same ignore
    loss_crf = GatedCRF(beta p1 + (1 - beta) p2, x)   (ops.gated_crf, K5)
    loss_cls = 0.5 * (BCE(conv_cls, category) + BCE(tran_cls, category))
    loss     = loss_ce + 0.1 * (loss_pse + loss_crf + loss_cls)

with beta ~ U(0, 1) + 1e-10 from rngs["method"] (a caller may pass
`beta`), drop-path from rngs["dropout"], the augmentation (K4) from
rngs["aug"], AdamW(5e-4, wd 5e-4) at a constant rate. ``category`` is the
per-slice class-presence table (``slice_categories`` of the dense labels),
staged with the slices and gathered by index; with cfg.device_data False
each batch ships its slices and their rows of the table, {"image",
"label", "category"}, as the JAX build's stream does.

The class memory (``state.extra["class_memory"]``) joins the forward from
epoch 5 (``state.step // steps_per_epoch > 4``, the reference's ``epoch >
4``); the gate is decided on the host, and a closed gate runs the forward
without the memory, which is what the JAX step's traced 0 gate computes.
It is the step's one host decision: the bundle's ``variant`` names it, and
a captured step keeps one CUDA graph for each side. AdamW's bias
corrections are device scalars (``ReferenceAdamW.load_scalars``).
``cfg.remat`` checkpoints the Conformer's stages 2-12 (``ScribbleVC
(remat=True)``): the same results, less memory, one more forward of
them.

Validation: the CAM rule with the memory injected (``cam_decision``, the
reference's training-time rule) is logged; the mean-softmax rule without
the memory (``mean_softmax_decision``, its test-time rule) selects the
best model. Metrics are NaN-aware, a val dice above 0.85 writes a
snapshot, and inference checkpoints hold the memory.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import parallel
from ...data import AcdcSliceDataset, AcdcVolumeDataset, batch_iterator
from ...eval.val2d import VolumePredictor
from ...models import net_factory
from ...ops import losses
from ...ops.gated_crf import gated_crf_loss
from ...utils.device import resolve_device
from ..config import TrainConfig
from ..optim import ReferenceAdamW
from ..state import TrainState
from .common import (
    DeviceBatches,
    MethodBundle,
    compute_dtype,
    index_batches,
    prep_batch,
    stage_dataset,
    train_vis,
)

W_PSE = W_CRF = W_CLS = 0.1


def cam_decision(outputs):
    """argmax((min(p1, p2) > 0.5) * (p1 + p2) / 2) over the two decoders'
    softmaxes (val_2D_scribblevc.py:84-86)."""
    p1 = torch.softmax(outputs[0], dim=-1)
    p2 = torch.softmax(outputs[1], dim=-1)
    return ((torch.minimum(p1, p2) > 0.5) * (0.5 * (p1 + p2))).argmax(-1)


def mean_softmax_decision(outputs):
    """argmax((softmax(p1) + softmax(p2)) / 2), the offline test rule
    (test_ACDC_scribblevc.py:84-87)."""
    p1 = torch.softmax(outputs[0], dim=-1)
    p2 = torch.softmax(outputs[1], dim=-1)
    return (0.5 * (p1 + p2)).argmax(-1)


def slice_categories(dense_labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(N, num_classes - 1) f32 class-presence table: column c - 1 is 1
    where class c occurs in the slice."""
    return np.stack(
        [(dense_labels == c).any(axis=(1, 2)) for c in range(1, num_classes)],
        axis=1).astype(np.float32)


@torch.no_grad()
def _prototype_health(model, memory) -> dict:
    """Magnitudes of the memory and the heads' accuracy on their own
    prototypes (prototype k should classify as class k), as device
    scalars."""
    z = memory["hist_conv"]
    ncls = z.shape[0]
    classes = torch.arange(ncls, device=z.device)
    kc = model.conv_cls_conv.kernel.float()
    logits = F.conv2d(z.permute(0, 3, 1, 2), kc.permute(3, 2, 0, 1),
                      padding=1).mean((2, 3))
    head = model.trans_cls_head
    tlogits = memory["hist_tran"][:, 0] @ head.kernel.float() + head.bias
    return {
        "proto_acc_conv": (logits.argmax(1) == classes).float().mean(),
        "proto_acc_tran": (tlogits.argmax(1) == classes).float().mean(),
        "mem_conv_absmax": z.abs().max(),
        "mem_conv_absmean": z.abs().mean(),
        "mem_tran_absmax": memory["hist_tran"].abs().max(),
    }


def make_variant(steps_per_epoch: int):
    """(state, seed) -> the step's host decision at state.step: whether the
    memory joins the forward (epoch > 4)."""
    return lambda state, seed: {
        "use_class_rep": state.step // steps_per_epoch > 4}


def make_step(cfg: TrainConfig, steps_per_epoch: int):
    num_classes = cfg.num_classes
    ignore = 0 if cfg.sup_type == "label" else 4
    variant = make_variant(steps_per_epoch)

    def step_fn(state, batch, rngs, aux=None, beta=None, use_class_rep=None):
        """batch {"index"} over the staged `aux` (images, labels,
        category), or {"image", "label", "category"} tensors;
        `use_class_rep`: the memory gate (None: the epoch's)."""
        x, labels = prep_batch(rngs["aug"], batch, aux)
        if aux is not None and "index" in batch:
            idx = torch.as_tensor(batch["index"]).to(aux["category"].device,
                                                     torch.int64)
            category = aux["category"].index_select(0, idx)
        else:
            category = batch["category"]
        if beta is None:
            beta = torch.rand((), generator=rngs["method"],
                              device=x.device) + 1e-10
        if use_class_rep is None:
            use_class_rep = variant(state, None)["use_class_rep"]
        memory = state.extra["class_memory"]
        pred1, pred2, (conv_cls, tran_cls) = state.model(
            x, train=True, memory=memory, use_class_rep=use_class_rep,
            rngs=rngs)
        p1 = torch.softmax(pred1, dim=-1)
        p2 = torch.softmax(pred2, dim=-1)
        loss_ce = 0.5 * (
            losses.cross_entropy(pred1, labels, ignore_index=ignore)
            + losses.cross_entropy(pred2, labels, ignore_index=ignore))
        p1d, p2d = p1.detach(), p2.detach()
        pseudo = ((torch.minimum(p1d, p2d) > 0.5)
                  * (beta * p1d + (1 - beta) * p2d)).argmax(-1)
        loss_pse = 0.5 * (
            losses.pdice_loss(p1, pseudo, num_classes, ignore)
            + losses.pdice_loss(p2, pseudo, num_classes, ignore))
        loss_crf = gated_crf_loss(beta * p1 + (1 - beta) * p2, x)
        loss_cls = 0.5 * parallel.global_mean(
            F.binary_cross_entropy_with_logits(conv_cls, category)
            + F.binary_cross_entropy_with_logits(tran_cls, category))
        loss = loss_ce + W_PSE * loss_pse + W_CRF * loss_crf \
            + W_CLS * loss_cls
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_pseudo": loss_pse.detach(),
            "loss_crf": loss_crf.detach(),
            "loss_cls": loss_cls.detach(),
            **_prototype_health(state.model, memory),
            "vis": train_vis(x, pred1, labels),
        }

    return step_fn


def data_stream(cfg: TrainConfig, train):
    """The step's batches: {"index"} into the staged slices, or with
    cfg.device_data False {"image", "label", "category"} (DeviceBatches),
    the rows of ``slice_categories`` beside each batch's slices."""
    if cfg.device_data:
        return index_batches(cfg, train)
    category = slice_categories(train.dense_labels, cfg.num_classes)

    def with_category():
        for b in batch_iterator(train, cfg.batch_size, seed=cfg.seed,
                                include_index=True):
            b["category"] = category[b.pop("index")]
            yield b

    return DeviceBatches(with_category(), resolve_device(cfg.device))


def make_bundle(cfg: TrainConfig, train, val) -> MethodBundle:
    """The method on a slice dataset with dense_labels (their class table
    staged beside the images and labels) and its val volumes, with a
    ScribbleVC of the published widths."""
    device = resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = net_factory("scribblevc", cfg.num_classes,
                        dtype=compute_dtype(cfg), generator=gen,
                        batch_size=cfg.batch_size, remat=cfg.remat
                        ).to(device)
    state = TrainState(model=model, opt=ReferenceAdamW(model.parameters()),
                       extra={"class_memory": model.init_memory(
                           cfg.patch_size, device)})
    aux = stage_dataset(cfg, train)
    if aux is not None:
        aux["category"] = torch.from_numpy(
            slice_categories(train.dense_labels, cfg.num_classes)).to(device)
    steps_per_epoch = max(len(train) // cfg.batch_size, 1)

    def predictor(decision_fn, use_class_rep):
        return VolumePredictor(model, cfg.patch_size, device=device,
                               decision_fn=decision_fn,
                               forward_kwargs={"use_class_rep":
                                               use_class_rep})

    def val_variables(state):
        return {"memory": state.extra["class_memory"]}

    return MethodBundle(
        model=model, state=state,
        step_fn=make_step(cfg, steps_per_epoch), aux=aux,
        data_iter=data_stream(cfg, train), val_volumes=val,
        steps_per_epoch=steps_per_epoch,
        variant=make_variant(steps_per_epoch),
        predictor=predictor(cam_decision, True),
        val_variables=val_variables,
        nan_val_metrics=True,
        dice_snapshot_threshold=0.85,
        select_predictor=predictor(mean_softmax_decision, False),
        eval_extra=("class_memory",),
    )


def build(cfg: TrainConfig) -> MethodBundle:
    """ACDC through the MAAG split (any other ACDC fold reads MAAGfold, as
    the JAX build does), MSCMRfold, or prostate_* (random-walker labels of
    the prostate generator)."""
    rw_mode = "acdc"
    if cfg.fold == "MSCMRfold":
        fold = cfg.fold
        slices_dir, volumes_dir = ("MSCMR_training_slices",
                                   "MSCMR_training_volumes")
    elif cfg.fold.startswith("prostate_"):
        fold = cfg.fold
        slices_dir, volumes_dir = ("Prostate_training_slices",
                                   "Prostate_training_volumes")
        rw_mode = "prostate"
    else:
        fold = cfg.fold if cfg.fold.startswith("MAAGfold") else "MAAGfold"
        slices_dir, volumes_dir = ("ACDC_training_slices",
                                   "ACDC_training_volumes")
    train = AcdcSliceDataset(base_dir=cfg.root_path, fold=fold,
                             sup_type=cfg.sup_type,
                             patch_size=cfg.patch_size, limit=cfg.data_limit,
                             slices_dirname=slices_dir, rw_mode=rw_mode)
    val = AcdcVolumeDataset(base_dir=cfg.root_path, fold=fold,
                            limit=(4 if cfg.data_limit else None),
                            volumes_dirname=volumes_dir)
    return make_bundle(cfg, train, val)
