"""The semi-supervised family (mean_teacher, uamt, entropy_minimization,
partially_supervised) and ustm in both packages, on the CPU in f32.

Three train steps from the same parameters (through utils.params) and the
same batches (batch 4, labeled_bs 2, 64x64, features (4, 8, 8, 16, 16),
dropout 0): the losses must agree at every step, and the parameters, the
BN running statistics and the EMA teacher's parameters after the third.
Random draws cannot match between JAX and torch, so they are injected:
augmentation is the identity on both sides, and the teacher's input
noise, the MC passes' noises and USTM's rotation come from tables keyed by
the JAX key each draw is given (``KeyedDraws``), the same values passed to
the port's step. The UNet head is scaled by HEAD_SCALE = 8 so that the
teacher's MC entropy spans the uncertainty threshold (at random init every
pixel is uncertain, and the masked term would be 0 on both sides); at 20
the losses reach ~10 and one near-tie routed otherwise in the backward
moves weights by up to 8e-4 in three steps, in partially_supervised too,
whose step is plain supervised training.

Tolerances, those of tests/test_torch_train_step.py and for the same
reason (the one-pass BN variance summed in different f32 orders): losses
rtol 1e-5, atol 1e-6 at every step; parameters, running statistics and EMA
parameters after three steps atol 2e-4, rtol 1e-3.

Also: ema_update alone against the JAX one, the paired index stream
against the JAX paired_iterator's images, build() of the five methods on a
synthetic H5 tree with a labeled patient, and a Trainer run of uamt with a
latest_full.ckpt resume.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.mean_teacher as jmt  # noqa: E402
import wsl4mis_tpu.engine.methods.ustm as justm  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.data.acdc import AcdcSliceDataset as JaxSlices  # noqa: E402
from wsl4mis_tpu.data.loader import paired_iterator as jax_paired  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods.common import split_rngs as jax_split  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_tpu.engine.state import ema_update as jax_ema  # noqa: E402
import wsl4mis_torch.engine.methods.common as tcommon  # noqa: E402
from wsl4mis_torch.data import paired_iterator, synthetic_slices  # noqa: E402
from wsl4mis_torch.data.acdc import AcdcSliceDataset  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState, ema_copy, ema_update  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
STEPS = 3
B, LBS, HW = 4, 2, 64
MC_PASSES = 4  # T // 2 passes of the doubled batch
HEAD_SCALE = 8.0  # see the module docstring
SEMI = ("mean_teacher", "uamt", "entropy_minimization",
        "partially_supervised")
RNG_NAMES = {
    "semi": ("aug", "dropout", "dropout2", "feature_perturb", "noise", "mc"),
    "ustm": ("aug", "dropout", "feature_perturb", "rot", "noise", "mc"),
}


class KeyedDraws:
    """Stands in for a JAX random draw inside jit: the value registered for
    the key it is given (NaN for an unknown key, so a miss shows)."""

    def __init__(self):
        self.keys, self.values = [], []

    def add(self, key, value):
        self.keys.append(np.asarray(jax.random.key_data(key)).ravel())
        self.values.append(np.asarray(value))

    def __call__(self, key):
        known = jnp.asarray(np.stack(self.keys))
        hit = jnp.all(jax.random.key_data(key).ravel() == known, axis=1)
        value = jnp.asarray(np.stack(self.values))[jnp.argmax(hit)]
        return jnp.where(hit.any(), value, jnp.nan).astype(value.dtype)


def _batches(sup):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
        if sup == "scribble":
            labels = np.where(rs.rand(B, HW, HW) < 0.2, labels, 4)
        images = labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1
        out.append({"image": images.astype(np.float32),
                    "label": labels.astype(np.int32)})
    return out


def _noise(rs, shape):
    return np.clip(rs.standard_normal(shape) * 0.1, -0.2, 0.2).astype(
        np.float32)


def _draws(method):
    """Per step: the JAX step key, and the noises (teacher input, MC
    passes) and rotation both packages take, registered by JAX key."""
    kind = "ustm" if method == "ustm" else "semi"
    teacher_b = B if method == "ustm" else B - LBS
    rs = np.random.RandomState(11)
    tables = {(teacher_b, HW, HW, 1): KeyedDraws(),
              (2 * teacher_b, HW, HW, 1): KeyedDraws()}
    rot = KeyedDraws()
    steps = []
    for t in range(STEPS):
        rng = jax.random.key(100 + t)
        rngs = jax_split(rng, RNG_NAMES[kind])
        noise = _noise(rs, (teacher_b, HW, HW, 1))
        tables[noise.shape].add(rngs["noise"], noise)
        mc = []
        for key in jax.random.split(rngs["mc"], MC_PASSES):
            mc.append(_noise(rs, (2 * teacher_b, HW, HW, 1)))
            tables[mc[-1].shape].add(jax.random.split(key)[0], mc[-1])
        rot_times = t + 1  # 1, 2, 3: every non-trivial rotation
        if kind == "ustm":
            rot.add(rngs["rot"], np.int32(rot_times))
        steps.append({"rng": rng, "noise": noise, "mc": mc,
                      "rot": rot_times})
    return steps, tables, rot


def _jax_and_port(method, monkeypatch):
    """The JAX state, jitted step and batches, and the port's state and
    step, from the same parameters; draws patched as the docstring says."""
    sup = "scribble" if method == "ustm" else "label"
    common = dict(method=method, batch_size=B, labeled_bs=LBS,
                  patch_size=(HW, HW), max_iterations=100,
                  compute_dtype="float32", sup_type=sup)
    steps, tables, rot = _draws(method)

    def keyed_noise(rng, shape, dtype=jnp.float32):
        return tables[tuple(shape)](rng).astype(dtype)

    monkeypatch.setattr(jcommon, "_augment_impl",
                        lambda: (lambda rng, images, labels: (images, labels)))
    monkeypatch.setattr(tcommon, "augment_batch",
                        lambda gen, images, labels: (images, labels))
    monkeypatch.setattr(jmt, "clamped_noise", keyed_noise)
    monkeypatch.setattr(justm, "clamped_noise", keyed_noise)
    if method == "ustm":
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi, *a, **k: rot(key))

    jmodel = junet.UNet(features=FEATURES, dropout=NO_DROPOUT,
                        dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jax.tree.map(np.array, jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, HW, HW, 1)),
        train=False))
    head = variables["params"]["Decoder_0"]["TorchConv_0"]["Conv_0"]
    head["kernel"] *= HEAD_SCALE
    head["bias"] *= HEAD_SCALE
    teacher = method in ("mean_teacher", "uamt", "ustm")
    jcfg = JaxConfig(**common)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxState.create(
        apply_fn=jmodel.apply, params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        tx=reference_sgd(jcfg.base_lr, jcfg.max_iterations),
        extra={"ema_params": jax.tree.map(jnp.copy, params)}
        if teacher else None)
    jmod = justm if method == "ustm" else jmt
    jstep = jax.jit(jmod.make_step(jcfg))

    cfg = TrainConfig(device="cpu", **common)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    load_flax_variables(model, variables)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations),
        extra={"ema_params": ema_copy(model)} if teacher else None)
    step = get_method(method).make_step(cfg)
    return (jstate, jstep), (state, step), steps, _batches(sup)


def _assert_tree(got: dict, want_flax: dict, rtol, atol):
    want = from_flax(jax.tree.map(np.asarray, want_flax))
    assert set(got) >= set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("method", SEMI + ("ustm",))
def test_three_steps_match(method, monkeypatch):
    (jstate, jstep), (state, step), draws, batches = _jax_and_port(
        method, monkeypatch)
    masked = []
    for t, (batch, d) in enumerate(zip(batches, draws)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, d["rng"])
        kwargs = {}
        if method in ("mean_teacher", "uamt", "ustm"):
            kwargs = {"noise": torch.from_numpy(d["noise"]),
                      "mc_noise": [torch.from_numpy(n) for n in d["mc"]]}
        if method == "ustm":
            kwargs["rot_times"] = d["rot"]
        tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  split_rngs(0, t, "cpu"), **kwargs)
        assert set(tm) == set(jm)
        for k in tm:
            if k != "vis":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
        masked.append(float(tm["consistency_loss"]))
    assert state.step == int(jstate.step) == STEPS
    got = dict(state.model.state_dict())
    _assert_tree(got, {"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
                 rtol=1e-3, atol=2e-4)
    if method in ("mean_teacher", "uamt", "ustm"):
        _assert_tree(state.extra["ema_params"],
                     {"params": jstate.extra["ema_params"]},
                     rtol=1e-3, atol=2e-4)
    if method in ("uamt", "ustm", "mean_teacher", "entropy_minimization"):
        # the consistency term is live, not 0 on both sides
        assert all(v > 0 for v in masked), masked


@pytest.mark.parametrize("step", [0, 1, 500])
def test_ema_update_matches(step):
    """a = min(1 - 1/(step + 1), 0.99): 0 (teacher = student), 0.5, 0.99."""
    rs = np.random.RandomState(step)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES)
    teacher = {k: torch.from_numpy(rs.standard_normal(p.shape).astype(
        np.float32)) for k, p in model.named_parameters()}
    student_np = {k: p.detach().numpy().copy()
                  for k, p in model.named_parameters()}
    want = jax_ema({k: jnp.asarray(v.numpy()) for k, v in teacher.items()},
                   {k: jnp.asarray(v) for k, v in student_np.items()},
                   0.99, jnp.int32(step))
    ema_update(teacher, model, 0.99, step)
    for k, v in want.items():
        np.testing.assert_allclose(teacher[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if step == 0:
        for k, v in student_np.items():
            np.testing.assert_array_equal(teacher[k].numpy(), v)


def test_paired_index_stream_matches_the_jax_images():
    """Index batches into [labeled; unlabeled] pick the images and labels
    the JAX paired_iterator ships, for three epochs of batches."""
    labeled = synthetic_slices(5, (8, 8), seed=1)
    unlabeled = synthetic_slices(13, (8, 8), seed=2)
    stack_images = np.concatenate([labeled.images, unlabeled.images])
    stack_labels = np.concatenate([labeled.labels, unlabeled.labels])
    lbs, ubs = 2, 4
    spe = len(unlabeled) // ubs
    ours = paired_iterator(labeled, unlabeled, lbs, ubs, seed=3)
    theirs = jax_paired(labeled, unlabeled, lbs, ubs, seed=3)
    for _ in range(3 * spe):
        idx, want = next(ours)["index"], next(theirs)
        assert idx.dtype == np.int32 and idx.shape == (lbs + ubs,)
        assert (idx[:lbs] < len(labeled)).all()
        assert (idx[lbs:] >= len(labeled)).all()
        np.testing.assert_array_equal(stack_images[idx], want["image"])
        np.testing.assert_array_equal(stack_labels[idx], want["label"])


def write_semi_tree(root):
    """fold1 layout with a labeled train patient: slices of patients 21
    (unlabeled, 6) and 30 (labeled, 4), 40x48, label and scribble keys;
    val volumes of patients 1-2 (3x40x48)."""
    os.makedirs(os.path.join(root, "ACDC_training_slices"))
    os.makedirs(os.path.join(root, "ACDC_training_volumes"))
    data = synthetic_slices(10, (40, 48), seed=5)
    scrib = synthetic_slices(10, (40, 48), seed=5, sup_type="scribble")
    for i in range(10):
        patient, sl = (21, i) if i < 6 else (30, i - 6)
        name = f"patient{patient:03d}_frame01_slice_{sl}.h5"
        with h5py.File(os.path.join(root, "ACDC_training_slices", name),
                       "w") as f:
            f["image"] = data.images[i]
            f["label"] = data.labels[i].astype(np.uint8)
            f["scribble"] = scrib.labels[i].astype(np.uint8)
    for p in (1, 2):
        sl = slice(3 * p, 3 * p + 3)
        with h5py.File(os.path.join(root, "ACDC_training_volumes",
                                    f"patient{p:03d}_frame01.h5"), "w") as f:
            f["image"] = data.images[sl]
            f["label"] = data.labels[sl].astype(np.uint8)
    return str(root)


@pytest.fixture(scope="module")
def semi_tree(tmp_path_factory):
    return write_semi_tree(tmp_path_factory.mktemp("acdc_semi"))


def semi_cfg(root, snap, method, **kw):
    base = dict(method=method, device="cpu", root_path=root,
                patch_size=(32, 32), batch_size=4, labeled_bs=2,
                max_iterations=4, val_every=4, ckpt_every=2,
                compute_dtype="float32", snapshot_root=str(snap),
                log_every=2, seed=3,
                sup_type="scribble" if method == "ustm" else "label")
    base.update(kw)
    return TrainConfig(**base)


def test_labeled_split_matches_the_jax_package(semi_tree):
    for side, n in (("labeled", 4), ("unlabeled", 6)):
        ours = AcdcSliceDataset(base_dir=semi_tree, labeled_type=side,
                                patch_size=(32, 32))
        theirs = JaxSlices(base_dir=semi_tree, labeled_type=side,
                           patch_size=(32, 32))
        assert len(ours) == n and ours.slice_names == theirs.slice_names
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.labels, theirs.labels)


@pytest.mark.parametrize("method", SEMI + ("ustm",))
def test_build_stages_the_method_data_and_steps(semi_tree, method):
    """build() reads the fold's data as the JAX build does (the semi
    family: dense labels, the labeled slices first in the staged stack;
    ustm: every train slice, its scribbles) and one step runs."""
    cfg = semi_cfg(semi_tree, "unused", method)
    bundle = get_method(method).build(cfg)
    images = bundle.aux["images"].numpy()
    if method == "ustm":
        train = JaxSlices(base_dir=semi_tree, sup_type="scribble",
                          patch_size=(32, 32))
        np.testing.assert_array_equal(images, train.images)
        assert bundle.steps_per_epoch == 10 // 4
        assert set(bundle.state.extra) == {"ema_params"}
    else:
        parts = [JaxSlices(base_dir=semi_tree, sup_type="label",
                           labeled_type=side, patch_size=(32, 32))
                 for side in ("labeled", "unlabeled")]
        np.testing.assert_array_equal(
            images, np.concatenate([p.images for p in parts]))
        np.testing.assert_array_equal(
            bundle.aux["labels"].numpy(),
            np.concatenate([p.labels for p in parts]))
        assert bundle.steps_per_epoch == 6 // 2
        batch = next(bundle.data_iter)
        assert (batch["index"][:2] < 4).all() and (batch["index"][2:] >= 4
                                                   ).all()
        teacher = method in ("mean_teacher", "uamt")
        assert (bundle.state.extra is not None) == teacher
    metrics = bundle.step_fn(bundle.state, next(bundle.data_iter),
                             split_rngs(0, 0, "cpu"), bundle.aux)
    assert all(np.isfinite(float(v)) for k, v in metrics.items()
               if k != "vis")
    assert bundle.state.step == 1


def test_trainer_resumes_uamt_with_its_teacher(semi_tree, tmp_path):
    """Trainer runs uamt 4 steps (validation, checkpoints); a resume from
    latest_full.ckpt restores the student, the optimizer and the EMA
    teacher into the new bundle's own tensors, and trains on."""
    cfg = semi_cfg(semi_tree, tmp_path, "uamt")
    bundle = get_method("uamt").build(cfg)
    assert Trainer(cfg, bundle, use_tensorboard=False).train() == \
        "Training Finished!"
    snap = cfg.snapshot_path
    for name in ("iter_2.pth", "iter_4.pth", "latest_full.ckpt"):
        assert os.path.isfile(os.path.join(snap, name)), name
    with open(os.path.join(snap, "log.txt")) as f:
        assert "iteration 4 : mean_dice" in f.read()
    ema = bundle.state.extra["ema_params"]
    student = dict(bundle.model.named_parameters())
    assert any(not torch.equal(ema[k], student[k].detach()) for k in ema)

    cfg2 = cfg.replace(max_iterations=6, resume=True)
    bundle2 = get_method("uamt").build(cfg2)
    ema2 = bundle2.state.extra["ema_params"]
    before = {k: v.data_ptr() for k, v in ema2.items()}
    trainer2 = Trainer(cfg2, bundle2, use_tensorboard=False)
    assert bundle2.state.step == 4 and bundle2.state.opt.count == 4
    assert bundle2.state.extra["ema_params"] is ema2
    for k, v in ema.items():
        assert ema2[k].data_ptr() == before[k]
        torch.testing.assert_close(ema2[k], v, rtol=0, atol=0)
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(bundle2.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    trainer2.train()
    assert bundle2.state.step == 6
    assert any(not torch.equal(ema2[k], ema[k]) for k in ema)
