"""The port's command line against the JAX package's (on the CPU): every
train script's defaults and method, the config each parser builds from
them and from one argv that sets every shared flag (field by field), the
ScribbleVC scripts' epoch-to-step arithmetic, the script and method names
``train`` takes, --deterministic, and the train and test commands end to
end on a synthetic ACDC H5 tree (host augmentation, a checkpoint the test
command reads, NIfTI predictions the JAX reader reads)."""

import dataclasses
import functools
import glob
import importlib.util
import os
import runpy
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import wsl4mis_tpu.cli as jcli  # noqa: E402
import wsl4mis_tpu.engine.methods as jmethods  # noqa: E402
import wsl4mis_tpu.engine.trainer as jtrainer  # noqa: E402
from wsl4mis_tpu.data.nifti import read_nifti as jax_read_nifti  # noqa: E402
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(
    os.path.basename(p)[:-3]
    for p in glob.glob(os.path.join(REPO, "scripts", "train_*.py"))
    if "scribblevc" not in p)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """A scripts/train_*.py of the JAX package as a module (not run as
    __main__)."""
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "script_" + name.replace("&", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_train_script_is_in_the_table():
    assert len(SCRIPTS) == 17
    assert sorted(cli.METHOD_DEFAULTS) == SCRIPTS


@pytest.mark.parametrize("name", SCRIPTS)
def test_method_defaults_are_the_scripts(name):
    mod = _script(name)
    assert cli.METHOD_DEFAULTS[name] == (mod.METHOD, mod.DEFAULTS)


# one value, unlike every default, for each flag the two parsers share
EVERY_FLAG = [
    "--root_path", REPO, "--exp", "E/x", "--fold", "fold3",
    "--sup_type", "scribble", "--model", "unet_cct", "--num_classes", "5",
    "--max_iterations", "77", "--batch_size", "10", "--deterministic", "0",
    "--base_lr", "0.125", "--patch_size", "[64, 96]", "--seed", "9",
    "--labeled_bs", "3", "--ema_decay", "0.5", "--consistency", "0.25",
    "--consistency_rampup", "40.0", "--thr_iter", "11", "--thr_conf", "0.5",
    "--period_iter", "13", "--alpha", "0.375", "--val_every", "17",
    "--ckpt_every", "19", "--log_every", "3", "--compute_dtype", "float32",
    "--snapshot_root", "snap", "--resume", "--data_limit", "21",
    "--aug_mode", "host", "--encoder_weights", "enc.msgpack",
    "--num_devices", "3", "--steps_per_call", "5", "--profile_steps", "2",
    "--remat", "1", "--device_data", "0"]


def _shared_fields(port_cfg, jax_cfg):
    port = dataclasses.asdict(port_cfg)
    ref = dataclasses.asdict(jax_cfg)
    shared = port.keys() & ref.keys()
    assert port.keys() - shared == {"device"}
    return {k: port[k] for k in shared}, {k: ref[k] for k in shared}


@pytest.mark.parametrize("argv", ["defaults", "every flag"])
@pytest.mark.parametrize("name", SCRIPTS)
def test_config_from_args_matches_the_jax_cli(name, argv):
    """Both parsers over the script's defaults, on the same argv: every
    field the two TrainConfigs share is equal."""
    method, defaults = cli.METHOD_DEFAULTS[name]
    flags = [] if argv == "defaults" else EVERY_FLAG
    port = cli.config_from_args(
        cli.build_parser(defaults).parse_args(flags + ["--device", "cpu"]),
        method)
    ref = jcli.config_from_args(
        jcli.build_parser(defaults).parse_args(flags), method)
    got, want = _shared_fields(port, ref)
    assert got == want
    assert port.device == "cpu"
    if argv == "every flag":
        assert port.root_path == REPO and port.patch_size == (64, 96)


def test_the_parser_keeps_no_tpu_flag():
    """The TPU-only --fast_prng is refused; --device_data, --steps_per_call,
    --profile_steps and --remat (ported) parse to the JAX defaults, and a
    JAX argv with --device_data 0 gives both configs the same shared
    fields."""
    parser = cli.build_parser({})
    with pytest.raises(SystemExit):
        parser.parse_args(["--fast_prng", "1"])
    jax_parser = jcli.build_parser({})
    jax_defaults = jax_parser.parse_args([])
    for name in ("device_data", "steps_per_call", "profile_steps", "remat"):
        assert getattr(parser.parse_args([]), name) == \
            getattr(jax_defaults, name)
    argv = ["--device_data", "0", "--batch_size", "8"]
    port = cli.config_from_args(parser.parse_args(argv), "pce")
    ref = jcli.config_from_args(jax_parser.parse_args(argv), "pce")
    got, want = _shared_fields(port, ref)
    assert got == want and got["device_data"] is False
    assert parser.parse_args([]).device == "cuda"
    assert parser.parse_args([]).encoder_weights is None
    assert parser.parse_args([]).num_devices is None


def test_resolve_script_takes_script_and_method_names():
    for name in SCRIPTS:
        assert cli.resolve_script(name) == cli.METHOD_DEFAULTS[name]
        assert cli.resolve_script(f"scripts/{name}.py") == \
            cli.METHOD_DEFAULTS[name]
    for method in available_methods():
        got, defaults = cli.resolve_script(method)
        assert got == method
        if method != "scribblevc":
            assert (method, defaults) in cli.METHOD_DEFAULTS.values()
    assert cli.resolve_script("scribblevc") == ("scribblevc", {})
    with pytest.raises(SystemExit):
        cli.resolve_script("train_nothing_2D")
    with pytest.raises(SystemExit):
        cli.main(["train"])


@pytest.mark.parametrize("flag", [0, 1])
def test_deterministic_sets_cudnn(flag):
    saved = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    try:
        cli.set_deterministic(flag)
        assert torch.backends.cudnn.deterministic == bool(flag)
        assert torch.backends.cudnn.benchmark == (not flag)
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = saved


class _Recorder:
    """Stands in for get_method and Trainer: build() returns a bundle of
    `steps_per_epoch` steps; the Trainer records its final config."""

    def __init__(self, steps_per_epoch=7):
        self.steps_per_epoch = steps_per_epoch
        self.cfgs = []

    def get_method(self, name):
        assert name == "scribblevc"
        return types.SimpleNamespace(build=lambda cfg: types.SimpleNamespace(
            steps_per_epoch=self.steps_per_epoch, model=None, state=None))

    def trainer(self, cfg, bundle, use_tensorboard=True):
        self.cfgs.append(cfg)
        return types.SimpleNamespace(train=lambda: "Training Finished!")


SVC_ARGV = {
    "ACDC": ["--fold", "MAAGfold70", "--max_epoches", "3",
             "--val_every_epoches", "2", "--ckpt_epoches", "5",
             "--light_val", "1", "--resume", "1", "--lr", "0.001",
             "--batch_size", "4", "--patch_size", "[128, 128]",
             "--seed", "5", "--exp", "X", "--steps_per_call", "2",
             "--remat", "1"],
    "MSCMR": ["--max_epoches", "3", "--val_every_epoches", "2",
              "--lr", "0.001", "--batch_size", "4", "--seed", "5",
              "--compute_dtype", "float32", "--data_limit", "9"],
}


@pytest.mark.parametrize("argv", ["defaults", "flags"])
@pytest.mark.parametrize("dataset", ["ACDC", "MSCMR"])
def test_scribblevc_main_matches_the_jax_scripts(monkeypatch, dataset, argv):
    """train_{ACDC,MSCMR}_scribblevc.py run as __main__ against
    scribblevc_main on the same argv, each over a bundle of 7 steps an
    epoch: the Trainer's configs agree field by field, epochs turned into
    steps."""
    flags = [] if argv == "defaults" else SVC_ARGV[dataset]
    jax_rec, port_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(jmethods, "get_method", jax_rec.get_method)
    monkeypatch.setattr(jtrainer, "Trainer", jax_rec.trainer)
    monkeypatch.setattr("sys.argv", ["x"] + flags)
    runpy.run_path(os.path.join(REPO, "scripts",
                                f"train_{dataset}_scribblevc.py"),
                   run_name="__main__")
    monkeypatch.setattr(cli, "get_method", port_rec.get_method)
    monkeypatch.setattr(cli, "Trainer", port_rec.trainer)
    assert cli.scribblevc_main(flags + ["--device", "cpu"], dataset) == \
        "Training Finished!"
    got, want = _shared_fields(port_rec.cfgs[0], jax_rec.cfgs[0])
    assert got == want
    epochs = 3 if flags else 200
    assert got["max_iterations"] == 7 * epochs
    assert got["val_every"] == 7 * (2 if flags else 1)


def _tree(root):
    """fold1: train slices of patients 21-22 (40x48, dense labels and
    scribbles), val volumes of patients 1-2 (3x40x48)."""
    (root / "ACDC_training_slices").mkdir(parents=True)
    (root / "ACDC_training_volumes").mkdir()
    data = synthetic_slices(12, (40, 48), seed=5)
    scrib = synthetic_slices(12, (40, 48), seed=5, sup_type="scribble")
    for i in range(12):
        name = f"patient{21 + i // 6:03d}_frame01_slice_{i % 6}.h5"
        with h5py.File(root / "ACDC_training_slices" / name, "w") as f:
            f["image"] = data.images[i]
            f["label"] = data.labels[i].astype(np.uint8)
            f["scribble"] = scrib.labels[i].astype(np.uint8)
    for p in (1, 2):
        with h5py.File(root / "ACDC_training_volumes"
                       / f"patient{p:03d}_frame01.h5", "w") as f:
            f["image"] = data.images[3 * p:3 * p + 3]
            f["label"] = data.labels[3 * p:3 * p + 3].astype(np.uint8)
    return str(root)


def test_train_and_test_commands_end_to_end(tmp_path, monkeypatch, capsys):
    """`train train_weakly_supervised_pCE_2D --aug_mode host --device cpu`
    then `test --device cpu` over its last checkpoint, through main (a
    narrow UNet: the factory patched; the test runs at 256x256 as the
    reference does): the checkpoints exist, the test prints the mean Dice
    and writes NIfTI files the JAX package's reader reads."""
    narrow = functools.partial(net_factory, features=(4, 8, 8, 16, 16))
    monkeypatch.setattr("wsl4mis_torch.engine.methods.common.net_factory",
                        narrow)
    monkeypatch.setattr("wsl4mis_torch.eval.infer.net_factory", narrow)
    root = _tree(tmp_path / "acdc")
    snap = str(tmp_path / "model")
    cli.main(["train", "train_weakly_supervised_pCE_2D", "--root_path", root,
              "--fold", "fold1", "--batch_size", "2", "--max_iterations", "2",
              "--val_every", "2", "--ckpt_every", "2", "--patch_size",
              "[32, 32]", "--snapshot_root", snap, "--aug_mode", "host",
              "--compute_dtype", "float32", "--device", "cpu"])
    run = os.path.join(snap, "ACDC_pCE_fold1", "scribble")
    for name in ("iter_2.pth", "latest_full.ckpt"):
        assert os.path.isfile(os.path.join(run, name)), name
    assert "Training Finished!" in capsys.readouterr().out
    cli.main(["test", "--root_path", root, "--exp", "ACDC_pCE", "--fold",
              "fold1", "--snapshot_root", snap, "--checkpoint", "iter_2.pth",
              "--compute_dtype", "float32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Inference fold1" in out and "iter_2.pth" in out
    pred_dir = os.path.join(run, "unet_predictions")
    for p in (1, 2):
        case = f"patient{p:03d}_frame01"
        gt = jax_read_nifti(os.path.join(pred_dir, f"{case}_gt.nii.gz"))
        pred = jax_read_nifti(os.path.join(pred_dir, f"{case}_pred.nii.gz"))
        assert gt.array_zyx.shape == pred.array_zyx.shape == (3, 40, 48)
        assert gt.spacing == (1.25, 1.25, 10.0)
    with pytest.raises(SystemExit):
        cli.main(["train_scribblevc", "PROSTATE"])


@pytest.mark.parametrize("argv", [
    ["--suite", "wss", "--folds", "all"], ["--suite", "semi"],
    ["--methods", "dmpls,pce,scribblevc", "--folds", "fold2,fold4",
     "--extra", "--max_iterations 5"],
    ["--suite", "semi", "--extra", "--device_data 0"], []])
def test_launch_dry_run_lists_the_jax_scripts_jobs(argv, capsys):
    """`launch --dry_run` prints the (method, fold) jobs of
    scripts/launch_experiments.py --dry_run in its order, each the port's
    train command of that script (train_scribblevc ACDC for ScribbleVC),
    with the same fold and extra flags."""
    from wsl4mis_torch import launch

    spec = importlib.util.spec_from_file_location(
        "launch_experiments", os.path.join(REPO, "scripts",
                                           "launch_experiments.py"))
    jlaunch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlaunch)
    assert jlaunch.main(argv + ["--dry_run"]) == 0
    want = [line.split()[2:] for line in capsys.readouterr().out.splitlines()
            if line.startswith("DRY:")]
    assert launch.main(argv + ["--dry_run"]) == 0
    got = [line.split()[2:] for line in capsys.readouterr().out.splitlines()
           if line.startswith("DRY:")]
    assert launch.SUITES == jlaunch.SUITES and len(got) == len(want) > 0
    for g, w in zip(got, want):
        script = os.path.basename(w[0])[:-3]
        assert g[:2] == ["-m", "wsl4mis_torch.cli"]
        if script == "train_ACDC_scribblevc":
            assert g[2:4] == ["train_scribblevc", "ACDC"]
        else:
            assert g[2:4] == ["train", script]
        assert g[4:] == w[1:]
