"""ScribbleVC's offline test commands and val_curve in the port (on the
CPU): ``python -m wsl4mis_torch.cli test_scribblevc {ACDC,Prostate}`` and
``val_curve``.

A narrow ScribbleVC (base 8, embed 32, 2 heads; the published depth 12)
is saved as the trainer saves it (its class memory beside the weights)
into a tiny H5 tree holding two of MAAG's 15 test patients and one other
patient (ACDC), or two of prostate_fold1's test patients and one train
patient (Prostate). The command's metrics must equal, bit for bit, those
of the validation's VolumePredictor with the select rule (the mean
softmax of the two heads, no class memory) over the test patients at
their spacing, and the select-rule validation's per-class Dice
(evaluate_fold, NaN-aware as ScribbleVC's). A checkpoint without a
memory scores with zeros, and scores the same, since the rule reads no
memory. ``--checkpoints`` scores several, each at
test_scribblevc_multi.py's spacing, and reports a missing one.

val_curve reads a log that the port's Trainer wrote: the same points as
the JAX package's scripts/val_curve.py, and the same printout; the
port's regex also takes the "nan" HD95 that a NaN-aware validation
logs."""

import contextlib
import functools
import importlib.util
import io
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from wsl4mis_tpu.data.acdc import maag_test_ids as jax_maag_test_ids  # noqa: E402
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.data.acdc import maag_test_ids, prostate_fold_ids  # noqa: E402
from wsl4mis_torch.data.synthetic import (  # noqa: E402
    synthetic_slices,
    synthetic_volumes,
)
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import (  # noqa: E402
    MethodBundle,
    make_model_and_state,
    stage_dataset,
    train_batches,
)
from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.eval import infer  # noqa: E402
from wsl4mis_torch.eval.metrics import calculate_metric_percase_spacing  # noqa: E402
from wsl4mis_torch.eval.val2d import VolumePredictor, evaluate_fold  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.checkpoint import save_model_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(base_channel=8, embed_dim=32, num_heads=2)
CHUNK = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _narrow(monkeypatch):
    """The commands build the test's narrow ScribbleVC and predict in
    8-slice chunks (the validation's 64-slice chunk pads the stack to 64
    slices, seconds a forward here)."""
    monkeypatch.setattr(infer, "net_factory",
                        functools.partial(net_factory, **NARROW))
    monkeypatch.setattr(infer, "VolumePredictor",
                        functools.partial(VolumePredictor, chunk=CHUNK))


def _write_volumes(root, dirname, cases, seed):
    os.makedirs(os.path.join(root, dirname), exist_ok=True)
    vols = synthetic_volumes(len(cases), 2, 40, 48, seed=seed)
    for case, vol in zip(cases, vols):
        with h5py.File(os.path.join(root, dirname, f"{case}_frame01.h5"),
                       "w") as f:
            f["image"] = vol["image"]
            f["label"] = vol["label"].astype(np.uint8)
    return {case: vol for case, vol in zip(cases, vols)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(ACDC root, Prostate root, {case: volume} of each test set)."""
    acdc = str(tmp_path_factory.mktemp("acdc"))
    test = maag_test_ids()[:2]
    vols = _write_volumes(acdc, "ACDC_training_volumes",
                          test + ["patient001"], seed=3)
    prostate = str(tmp_path_factory.mktemp("prostate"))
    ptest = prostate_fold_ids("prostate_fold1")[1][:2]
    pvols = _write_volumes(prostate, "Prostate_training_volumes",
                           ptest + ["patient050"], seed=4)
    return (acdc, prostate, {c: vols[c] for c in test},
            {c: pvols[c] for c in ptest})


def _model(num_classes, seed=0):
    return net_factory("scribblevc", num_classes, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed),
                       **NARROW)


def _save(snapshot, name, model, memory=None):
    """An inference checkpoint as the Trainer writes it."""
    state = types.SimpleNamespace(model=model, step=7, extra={
        "class_memory": memory})
    save_model_checkpoint(os.path.join(snapshot, name), state,
                          eval_extra=("class_memory",) if memory else ())


def _random_memory(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g)
            for k, v in model.init_memory((256, 256)).items()}


def _expected(model, memory, volumes, num_classes):
    """The select rule's predictions and (dice, hd95, asd) at the default
    spacing, through the validation's VolumePredictor; and the select-rule
    validation's per-class Dice."""
    predictor = VolumePredictor(model, (256, 256), device="cpu",
                                chunk=CHUNK,
                                decision_fn=mean_softmax_decision,
                                forward_kwargs={"use_class_rep": False})
    vols = list(volumes.values())
    preds = predictor.predict_volumes([v["image"] for v in vols],
                                      {"memory": memory})
    spacing = (10.0, 1.25, 1.25)  # (sz, sx, sy) of the default spacing
    totals = np.zeros((num_classes - 1, 3))
    for vol, pred in zip(vols, preds):
        for i in range(1, num_classes):
            totals[i - 1] += calculate_metric_percase_spacing(
                pred == i, vol["label"] == i, spacing)
    val = evaluate_fold(predictor, vols, num_classes, nan_aware=True,
                        variables={"memory": memory})
    return totals / len(vols), val[:, 0]


def _argv(root, snap, *extra):
    return [f"--root_path={root}", f"--snapshot_root={snap}",
            "--device=cpu", "--compute_dtype=float32", *extra]


def test_maag_test_ids_match_the_jax_package():
    assert maag_test_ids() == jax_maag_test_ids()
    assert len(maag_test_ids()) == 15


def test_acdc_command_scores_the_maag_test_patients(trees, tmp_path):
    acdc, _, volumes, _ = trees
    model = _model(4)
    memory = _random_memory(model)
    snapshot = tmp_path / "ACDC_ScribbleVC_MAAGfold" / "scribble"
    _save(str(snapshot), "scribblevc_best_model.pth", model, memory)
    out = cli.scribblevc_test_main(_argv(acdc, tmp_path), "ACDC")
    avg = out["scribblevc_best_model.pth"]
    want, val_dice = _expected(model.eval(), memory, volumes, 4)
    assert avg.shape == (3, 3)
    np.testing.assert_array_equal(avg, want)
    assert np.isfinite(avg).all()
    np.testing.assert_array_equal(avg[:, 0], val_dice)


def test_prostate_command_scores_the_fold_test_patients(trees, tmp_path):
    _, prostate, _, volumes = trees
    model = _model(3)
    snapshot = tmp_path / "Prostate_ScribbleVC_prostate_fold1" / "scribble"
    _save(str(snapshot), "scribblevc_best_model.pth", model,
          _random_memory(model))
    out = cli.scribblevc_test_main(_argv(prostate, tmp_path), "Prostate")
    avg = out["scribblevc_best_model.pth"]
    predictor = VolumePredictor(model.eval(), (256, 256), device="cpu",
                                chunk=CHUNK,
                                decision_fn=mean_softmax_decision,
                                forward_kwargs={"use_class_rep": False})
    val = evaluate_fold(predictor, list(volumes.values()), 3,
                        nan_aware=True,
                        variables={"memory": model.init_memory((256, 256))})
    assert avg.shape == (2, 3) and np.isfinite(avg).all()
    np.testing.assert_array_equal(avg[:, 0], val[:, 0])


def test_memoryless_checkpoint_scores_with_zeros(trees, tmp_path):
    acdc = trees[0]
    model = _model(4)
    snapshot = tmp_path / "ACDC_ScribbleVC_MAAGfold" / "scribble"
    _save(str(snapshot), "with.pth", model, _random_memory(model))
    _save(str(snapshot), "without.pth", model)
    loaded, memory = infer.load_scribblevc(str(snapshot / "without.pth"), 4,
                                           "float32", "cpu")
    assert all(float(v.abs().max()) == 0.0 for v in memory.values())
    _, kept = infer.load_scribblevc(str(snapshot / "with.pth"), 4,
                                    "float32", "cpu")
    assert all(torch.equal(kept[k], v)
               for k, v in _random_memory(model).items())
    out = cli.scribblevc_test_main(
        _argv(acdc, tmp_path, "--checkpoints", "with.pth", "without.pth"),
        "ACDC")
    np.testing.assert_array_equal(out["with.pth"], out["without.pth"])


def test_checkpoints_flag_scores_each_and_reports_a_missing_one(
        trees, tmp_path, capsys):
    acdc = trees[0]
    snapshot = tmp_path / "ACDC_ScribbleVC_MAAGfold" / "scribble"
    for seed, name in ((0, "a.pth"), (1, "b.pth")):
        _save(str(snapshot), name, _model(4, seed))
    out = cli.scribblevc_test_main(
        _argv(acdc, tmp_path, "--checkpoints", "a.pth", "gone.pth",
              "b.pth"), "ACDC")
    assert list(out) == ["a.pth", "b.pth"]
    printed = capsys.readouterr().out
    assert "gone.pth MISSING" in printed
    # printed as test_scribblevc_multi.py prints it
    assert f"b.pth mean: {np.round(out['b.pth'].mean(axis=0), 4)}" in printed
    # the command line, one checkpoint: at the cases' own spacing (the
    # --checkpoints scores at test_scribblevc_multi.py's), the same Dice,
    # printed
    single = cli.scribblevc_test_main(
        _argv(acdc, tmp_path, "--checkpoint", "b.pth"), "ACDC")
    np.testing.assert_array_equal(single["b.pth"][:, 0], out["b.pth"][:, 0])
    capsys.readouterr()
    cli.main(["test_scribblevc", "ACDC",
              *_argv(acdc, tmp_path, "--checkpoint", "b.pth")])
    printed = capsys.readouterr().out
    assert str(single["b.pth"]) in printed
    assert str(single["b.pth"].mean(axis=0)) in printed


def test_parsers_keep_the_scripts_defaults():
    acdc = cli.scribblevc_test_parser("ACDC").parse_args([])
    assert (acdc.exp, acdc.fold, acdc.num_classes, acdc.checkpoint,
            acdc.device) == ("ACDC_ScribbleVC", "MAAGfold", 4,
                             "scribblevc_best_model.pth", "cuda")
    pro = cli.scribblevc_test_parser("Prostate").parse_args([])
    assert (pro.root_path, pro.exp, pro.fold, pro.num_classes) == (
        "../data/Prostate", "Prostate_ScribbleVC", "prostate_fold1", 3)
    with pytest.raises(SystemExit):
        cli.scribblevc_test_parser("Prostate").parse_args(
            ["--checkpoints", "a.pth"])
    with pytest.raises(SystemExit):
        cli.main(["test_scribblevc", "MSCMR"])


def _jax_val_curve():
    spec = importlib.util.spec_from_file_location(
        "jax_val_curve", os.path.join(REPO, "scripts", "val_curve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trainer_log(tmp_path_factory):
    """log.txt of a port Trainer run: fully_supervised, 6 steps on the
    CPU, a validation every 2."""
    import logging

    root = tmp_path_factory.mktemp("log_run")
    data = synthetic_slices(8, (32, 32), seed=5)
    cfg = TrainConfig(method="fully_supervised", device="cpu", batch_size=2,
                      patch_size=(32, 32), max_iterations=6, val_every=2,
                      ckpt_every=6, log_every=2, compute_dtype="float32",
                      snapshot_root=str(root), sup_type="label")
    model, state = make_model_and_state(cfg)
    bundle = MethodBundle(
        model=model, state=state,
        step_fn=get_method("fully_supervised").make_step(cfg),
        data_iter=train_batches(cfg, data),
        val_volumes=synthetic_volumes(1, 2, 32, 32), steps_per_epoch=4,
        aux=stage_dataset(cfg, data))
    try:
        Trainer(cfg, bundle, use_tensorboard=False).train()
    finally:
        for h in list(logging.getLogger().handlers):
            if isinstance(h, logging.FileHandler):
                logging.getLogger().removeHandler(h)
                h.close()
    return os.path.join(cfg.snapshot_path, "log.txt")


def test_val_curve_reads_the_port_trainers_log(trainer_log):
    pts = cli.val_curve(trainer_log)
    assert [p[0] for p in pts] == [2, 4, 6]
    assert pts == _jax_val_curve().curve(trainer_log)
    mine, theirs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(mine):
        cli.main(["val_curve", trainer_log])
    jax_main = _jax_val_curve()
    jax_main.sys.argv = ["val_curve.py", trainer_log]
    with contextlib.redirect_stdout(theirs):
        jax_main.main()
    assert mine.getvalue() == theirs.getvalue()


def test_val_curve_takes_a_nan_hd95(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text(
        "[00:00:01.000] iteration 200 : mean_dice : 0.512300 "
        "mean_hd95 : nan\n"
        "[00:00:02.000] iteration 400 : mean_dice : 0.700000 "
        "mean_hd95 : 3.250000\n"
        "[00:00:02.500] iteration 400 : val(select-rule) dice 0.7\n")
    pts = cli.val_curve(str(log))
    assert pts[1] == (400, 0.7, 3.25)
    assert pts[0][:2] == (200, 0.5123) and np.isnan(pts[0][2])
    assert _jax_val_curve().curve(str(log)) == [pts[1]]
