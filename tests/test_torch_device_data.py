"""Host-fed batches (``TrainConfig.device_data`` False, the train command's
``--device_data 0``) and ``TrainConfig.debug_nans``, on the CPU.

* Every one of the 17 methods: two steps with host-fed batches (the
  slices shipped, augmented in the step) are bit-equal to two steps with
  index batches into the staged stack, from the same state and (seed,
  step) draws, every state leaf and metric; each host batch holds the
  slices its index batch names, in order (ScribbleVC's category rows and
  S2L's index too). s2l's pseudo-label term is live (one refresh, its gate
  open), scribblevc's memory gate opens between the two steps, and ustm
  rotates.
* The port's host batch stream equals the JAX build's (device_data
  False), key by key, on a small ACDC H5 tree, for fully_supervised,
  scribblevc (with its category rows) and mean_teacher (the paired
  [labeled; unlabeled] batches).
* debug_nans: a clean fully_supervised step is bit-equal to the plain
  step; a NaN in one input pixel, and a NaN in one conv weight, raise
  FloatingPointError naming the first module whose output holds it, and
  leave the state as it was before the step; the JAX step raises
  FloatingPointError on the same planted input under the scoped
  ``jax.debug_nans(True)``.

Narrow models (UNet features 4..16 at 32x32, ScribbleVC base 8, embed 32,
2 heads at 64x64), batch 4, f32, one torch thread.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.scribblevc as jsvc  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods import get_method as jax_method  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_torch.data.synthetic import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.debug_nans import NanCheck  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import (  # noqa: E402
    DeviceBatches,
    split_rngs,
)
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.models.unet import Conv3x3  # noqa: E402

HW, SVC_HW, B, SEED = 32, 64, 4, 3
FEATURES = (4, 8, 8, 16, 16)
SVC_WIDTHS = dict(base_channel=8, embed_dim=32, num_heads=2)
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def narrow(monkeypatch):
    from wsl4mis_torch.engine.methods import common
    from wsl4mis_torch.engine.methods import scribblevc as msvc

    monkeypatch.setattr(common, "net_factory", functools.partial(
        net_factory, features=FEATURES))
    monkeypatch.setattr(msvc, "net_factory", functools.partial(
        net_factory, **SVC_WIDTHS))


def _bundle(method, device_data):
    """(bundle, its first STEPS batches) of the method on its phantoms;
    s2l's buffer refreshed once and its gate open, with thr_conf 0.04
    under every pixel's largest buffer value after one refresh, so that
    its pseudo-label term is live; scribblevc one step before its memory
    gate opens."""
    method, model, batch, kind = chip_smoke.dp_cell(method, B)
    hw = SVC_HW if method == "scribblevc" else HW
    cfg = TrainConfig(
        method=method, model=model, batch_size=batch, labeled_bs=batch // 2,
        max_iterations=10 ** 4, compute_dtype="float32", seed=SEED,
        device="cpu", patch_size=(hw, hw), thr_iter=0, thr_conf=0.04,
        sup_type=chip_smoke.sup_type_of(method), device_data=device_data)
    data = chip_smoke.dp_data(kind, hw, SEED)
    bundle, batches = chip_smoke.method_bundle(cfg, data, None)
    if method == "s2l":
        bundle.host_hook(bundle, bundle.state, cfg.period_iter)
    if method == "scribblevc":
        bundle.state.step = chip_smoke.svc_gate_step(len(data), batch) - 1
    it = batches()
    return bundle, [next(it) for _ in range(STEPS)]


def _run(bundle, batches):
    state, metrics = bundle.state, []
    for batch in batches:
        m = bundle.step_fn(state, batch, split_rngs(SEED, state.step, "cpu"),
                           bundle.aux)
        metrics.append(chip_smoke._metrics_leaves(m))
    return chip_smoke._snapshot(chip_smoke.state_leaves(state)), metrics


def _gathered(aux, batch):
    """The host batch that an index batch names in the staged aux."""
    idx = torch.as_tensor(batch["index"]).long()
    out = {"image": aux["images"][idx],
           "label": aux["labels"][idx].to(torch.int32)}
    if "category" in aux:
        out["category"] = aux["category"][idx]
    return out


@pytest.mark.parametrize("method", sorted(available_methods()))
def test_host_fed_steps_equal_the_staged_steps(narrow, method):
    staged, staged_batches = _bundle(method, True)
    fed, fed_batches = _bundle(method, False)
    assert fed.aux is None and staged.aux is not None
    assert isinstance(fed.data_iter, DeviceBatches)
    for s, f in zip(staged_batches, fed_batches):
        want = _gathered(staged.aux, s)
        if method == "s2l":
            want["index"] = torch.as_tensor(s["index"])
        assert f.keys() == want.keys()
        for k, v in want.items():
            assert f[k].dtype == v.dtype and torch.equal(f[k], v), k
    want, want_metrics = _run(staged, staged_batches)
    got, got_metrics = _run(fed, fed_batches)
    bad, worst = chip_smoke.leaves_diff(want, got)
    assert not bad, (bad[:8], worst)
    for w, g in zip(want_metrics, got_metrics):
        assert w.keys() == g.keys()
        assert [k for k in w if not torch.equal(w[k], g[k])] == []


# ---- the batch stream against the JAX build's -------------------------------


def _tree(root):
    """fold1 train slices of patients 021, 028 (MAAGfold too) and 030
    (labeled for the semi family), 4 each at 40x48 with dense labels and
    scribbles; the val volume of patient 001 (both folds' validation)."""
    (root / "ACDC_training_slices").mkdir(parents=True)
    (root / "ACDC_training_volumes").mkdir()
    data = synthetic_slices(12, (40, 48), seed=5)
    scrib = synthetic_slices(12, (40, 48), seed=5, sup_type="scribble")
    for i in range(12):
        patient = (21, 28, 30)[i // 4]
        name = f"patient{patient:03d}_frame01_slice_{i % 4}.h5"
        with h5py.File(root / "ACDC_training_slices" / name, "w") as f:
            f["image"] = data.images[i]
            f["label"] = data.labels[i].astype(np.uint8)
            f["scribble"] = scrib.labels[i].astype(np.uint8)
    with h5py.File(root / "ACDC_training_volumes" / "patient001_frame01.h5",
                   "w") as f:
        f["image"] = data.images[:3]
        f["label"] = data.labels[:3].astype(np.uint8)
    return str(root)


class _TinyNet(nn.Module):
    """Stands in for the JAX build's UNet, whose batch stream does not
    depend on it (its op-by-op init takes half a minute on the CPU)."""

    num_classes: int = 4

    @nn.compact
    def __call__(self, x, train=False):
        return nn.Dense(self.num_classes)(x)


class _NoScribbleVC:
    """Stands in for the JAX build's ScribbleVC (the full-width init takes
    a minute on the CPU)."""

    def __init__(self, **kwargs):
        pass

    def init(self, rngs, x, train=False):
        return {"params": {"w": jnp.zeros((1,))}, "class_memory": {}}

    def apply(self, *args, **kwargs):
        raise AssertionError("the stream test runs no step")


STREAMS = {"fully_supervised": ("label", 4, ("image", "label")),
           "scribblevc": ("scribble", 2, ("image", "label", "category")),
           "mean_teacher": ("label", 4, ("image", "label"))}


@pytest.mark.parametrize("method", sorted(STREAMS))
def test_host_stream_is_the_jax_builds(narrow, monkeypatch, tmp_path,
                                       method):
    """Five batches of each package's build with device_data False: the
    same keys (JAX's paired batches also carry their labeled_bs, which
    the port's bundle holds in batch_parts), the same arrays."""
    sup, batch, keys = STREAMS[method]
    hw = SVC_HW if method == "scribblevc" else HW
    root = _tree(tmp_path / "acdc")
    common = dict(root_path=root, fold="fold1", method=method,
                  sup_type=sup, batch_size=batch, labeled_bs=batch // 2,
                  patch_size=(hw, hw), compute_dtype="float32", seed=SEED,
                  device_data=False)
    if method == "scribblevc":
        common["model"] = "scribblevc"
        monkeypatch.setattr(jsvc, "ScribbleVC", _NoScribbleVC)
    monkeypatch.setattr(jcommon, "net_factory",
                        lambda name, n, dtype: _TinyNet(n))
    want_it = jax_method(method).build(JaxConfig(**common)).data_iter
    bundle = get_method(method).build(TrainConfig(device="cpu", **common))
    assert bundle.aux is None
    for _ in range(5):
        want, got = next(want_it), next(bundle.data_iter)
        if method == "mean_teacher":
            assert want.pop("labeled_bs") == bundle.batch_parts[0]
        assert sorted(got) == sorted(want) == sorted(keys)
        for k in keys:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k].numpy(), want[k], k)


# ---- debug_nans -------------------------------------------------------------


def _fs_state():
    """A narrow fully_supervised state (torch's init from SEED) and its
    step, on host-fed batches."""
    cfg = TrainConfig(method="fully_supervised", batch_size=B,
                      patch_size=(HW, HW), max_iterations=100,
                      compute_dtype="float32", sup_type="label",
                      device="cpu", device_data=False)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        generator=torch.Generator().manual_seed(SEED))
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations))
    return state, get_method("fully_supervised").make_step(cfg)


def _batch(nan_pixel=False):
    rs = np.random.RandomState(7)
    labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
    images = (labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1).astype(
        np.float32)
    if nan_pixel:  # the centre: every augmentation keeps it in the frame
        images[1, HW // 2, HW // 2] = np.nan
    return {"image": images, "label": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _leaves(state):
    return chip_smoke._snapshot(chip_smoke.state_leaves(state))


def _same(a, b):
    """Bit-equal, a NaN equal to a NaN in the same place."""
    if not isinstance(a, torch.Tensor):
        return a == b
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)


def test_debug_nans_clean_step_is_the_plain_step():
    state, step = _fs_state()
    plain, plain_step = _fs_state()
    check = NanCheck(step, SEED, torch.device("cpu"))
    for t in range(STEPS):
        batch = _torch_batch(_batch())
        got = chip_smoke._metrics_leaves(check(state, batch, None, t))
        want = chip_smoke._metrics_leaves(plain_step(
            plain, batch, split_rngs(SEED, t, "cpu"), None))
        assert [k for k in want if not torch.equal(want[k], got[k])] == []
    bad, _ = chip_smoke.leaves_diff(_leaves(plain), _leaves(state))
    assert not bad and state.step == plain.step == STEPS


def _first_conv(model):
    return next((n, m) for n, m in model.named_modules()
                if isinstance(m, Conv3x3))


@pytest.mark.parametrize("plant", ["input pixel", "conv weight"])
def test_debug_nans_raises_naming_the_module(plant):
    state, step = _fs_state()
    name, conv = _first_conv(state.model)
    batch = _torch_batch(_batch(nan_pixel=plant == "input pixel"))
    if plant == "conv weight":
        with torch.no_grad():
            conv.kernel[1, 1, 0, 2] = float("nan")
    before = _leaves(state)
    check = NanCheck(step, SEED, torch.device("cpu"))
    with pytest.raises(FloatingPointError) as err:
        check(state, batch, None, 0)
    assert f"the output of module model.{name}" in str(err.value)
    assert "iteration 0" in str(err.value)
    after = _leaves(state)  # as before the step, the planted NaN too
    assert [k for k, v in before.items() if not _same(v, after[k])] == []
    assert state.step == 0


def test_jax_step_raises_on_the_planted_input():
    """The JAX fully_supervised step on the same batches (its own narrow
    UNet): the clean one runs, the planted one raises."""
    jcfg = JaxConfig(method="fully_supervised", batch_size=B,
                     patch_size=(HW, HW), max_iterations=100,
                     compute_dtype="float32", sup_type="label",
                     device_data=False)
    jmodel = junet.UNet(features=FEATURES, dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": key, "dropout": key, "feature_perturb": key},
        jnp.zeros((1, HW, HW, 1)))
    jstate = JaxState.create(apply_fn=jmodel.apply,
                             params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             tx=reference_sgd(jcfg.base_lr,
                                              jcfg.max_iterations))
    jstep = jax_method("fully_supervised").make_step(jcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(nan_pixel=True).items()}
    clean = {k: jnp.asarray(v) for k, v in _batch().items()}
    with jax.debug_nans(True):
        jax.jit(jstep)(jstate, clean, jax.random.key(0))  # clean: no raise
        with pytest.raises(FloatingPointError):
            jax.jit(jstep)(jstate, batch, jax.random.key(0))


# ---- the Trainer ------------------------------------------------------------


def _trainer(tmp_path, method="fully_supervised", **flags):
    """A Trainer of the method on its phantoms (chip_smoke.method_bundle),
    host-fed, batch 4, narrow."""
    from wsl4mis_torch.engine.trainer import Trainer

    method, model, batch, kind = chip_smoke.dp_cell(method, B)
    cfg = TrainConfig(
        method=method, model=model, batch_size=batch, labeled_bs=batch // 2,
        compute_dtype="float32", seed=SEED, device="cpu",
        patch_size=(HW, HW), sup_type=chip_smoke.sup_type_of(method),
        snapshot_root=str(tmp_path), device_data=False, val_every=10 ** 6,
        ckpt_every=10 ** 6, **flags)
    data = chip_smoke.dp_data(kind, HW, SEED)
    bundle, batches = chip_smoke.method_bundle(cfg, data, None)
    return Trainer(cfg, bundle, use_tensorboard=False), batches


@pytest.mark.parametrize("method", ["fully_supervised", "mean_teacher"])
def test_trainer_keeps_the_ranks_rows_of_host_batches(narrow, monkeypatch,
                                                      tmp_path, method):
    """Under a process group (rank 1 of 2 here, the group faked) the
    Trainer keeps the rank's rows of each host batch on the host, part by
    part for the semi family, and copies only those."""
    from wsl4mis_torch import parallel

    seen = []
    shard = parallel.shard_batch

    def spy(mesh, b, parts=None):
        seen.append({k: type(v) for k, v in b.items()})
        return shard(mesh, b, parts)

    monkeypatch.setattr(parallel, "current_mesh",
                        lambda: parallel.Mesh(1, 2))
    monkeypatch.setattr(parallel, "replicate_tree", lambda tree: tree)
    monkeypatch.setattr(parallel, "shard_batch", spy)
    trainer, batches = _trainer(tmp_path, method)
    got = next(trainer.data_iter)
    want = shard(parallel.Mesh(1, 2), next(batches()),
                 trainer.bundle.batch_parts)
    assert seen[0] == {"image": np.ndarray, "label": np.ndarray}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["image"].shape[0] == B // 2


def test_trainer_raises_at_the_nan_iteration(narrow, tmp_path):
    """Trainer.train with debug_nans, K = 2: a NaN planted in every slice
    from the third batch on stops the run at iteration 2 with
    FloatingPointError; the K steps of a call run uncaptured, and the
    Trainer says why on a card."""
    from wsl4mis_torch.engine.methods import common

    trainer, _ = _trainer(tmp_path, debug_nans=True, steps_per_call=2,
                          max_iterations=6)
    host = trainer.bundle.data_iter.host

    def poisoned():
        for i, b in enumerate(host):
            if i >= 2:
                b = {**b, "image": b["image"].copy()}
                b["image"][:, HW // 2, HW // 2] = np.nan
            yield b

    trainer.data_iter = iter(common.DeviceBatches(poisoned(), "cpu"))
    with pytest.raises(FloatingPointError) as err:
        trainer.train()
    assert "iteration 2 made a NaN" in str(err.value)
    assert "the output of module model." in str(err.value)
    assert trainer.state.step == 2
    with open(os.path.join(trainer.cfg.snapshot_path, "log.txt")) as f:
        assert "the steps of a call run uncaptured" in f.read()
    trainer.device = torch.device("cuda")  # the reason on a card
    assert "debug_nans" in trainer._uncaptured_reason()


# ---- chip_smoke's phase 11 --------------------------------------------------


def test_device_data_phase_runs_on_the_cpu(narrow, monkeypatch, tmp_path,
                                           capsys):
    """Phase 11 on the CPU at 64x64, narrow: each method's host-fed eager
    steps bit-equal to its staged ones (the capture and the timing need a
    card), two gloo ranks with device_data 0 within phase 8's tolerances of
    the single process, debug_nans' clean steps bit-equal to the plain ones
    and its planted NaN raising; the device_data line."""
    from wsl4mis_torch.data import ArraySliceDataset

    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    hw = 64
    data = synthetic_slices(16, (hw, hw), seed=SEED)
    scribbles = synthetic_slices(16, (hw, hw), seed=SEED, sup_type="scribble")
    datasets = {
        "dense": data, "scribble": scribbles,
        "semi": (ArraySliceDataset(data.images[:8], data.labels[:8]),
                 ArraySliceDataset(data.images[8:], data.labels[8:])),
        "svc": synthetic_slices(chip_smoke.SVC_SLICES, (hw, hw),
                                seed=SEED + 2, sup_type="scribble")}
    runs = (("fully_supervised", "unet", 4, "dense"),
            ("uamt", "unet", 4, "semi"), ("s2l", "unet", 4, "scribble"),
            ("scribblevc", "scribblevc", 2, "svc"))
    cells = (("fully_supervised", "unet", 4, "dense"),
             ("scribblevc", "scribblevc", 2, "svc"))
    monkeypatch.setattr(chip_smoke, "DP_SLICES", 16)
    out = chip_smoke.device_data_phase(
        SEED, datasets, None, "cpu", None, dev="cpu", hw=hw, runs=runs,
        dp_cells=cells, widths={"features": FEATURES,
                                "scribblevc": SVC_WIDTHS}, nan_batch=4)
    assert [r["method"] for r in out["runs"]] == [r[0] for r in runs]
    for r in out["runs"]:
        assert r["eager_leaves_differing"] == [] == r[
            "eager_metrics_differing"], r["method"]
    assert out["cli"] is None
    assert set(out["two_ranks"]) == {"fully_supervised", "scribblevc"}
    assert out["debug_nans"]["leaves_differing"] == []
    assert "the output of module model." in out["debug_nans"]["raised"]
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("device_data "))
    assert set(json.loads(line.split(" ", 1)[1])) == {
        "card", "phase_s", "k", "runs", "cli", "two_ranks", "debug_nans",
        "runs_s", "two_ranks_s"}
