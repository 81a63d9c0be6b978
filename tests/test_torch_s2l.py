"""Scribble2Label (s2l) in both packages, on the CPU in f32, at 32x32
planes and reduced widths (features (4, 8, 8, 16, 16), dropout 0).

* The S2L augmentation's plain version (image, scribble, weight rows;
  every map filled with 0) against the JAX ``augment_batch_s2l``, policy
  by policy: the JAX draw of each key (``_sample_policy``, the same key
  usage as ``_augment_one_multi``) is handed to the port. rot90 / flip and
  the identity are index maps, so bit-exact on all three maps; a rotation
  matches ``_rotate_nearest`` on >= 99.9% of pixels per map (cos / sin of
  the angle in f32 on two backends may move a source coordinate across a
  rounding boundary, the criterion of tests/test_torch_augment.py); the
  scribble fill is 0, never 4.
* Three train steps of ``make_step`` from the same parameters and weight
  buffer, with the pseudo-label gate closed throughout (thr_iter 100) and
  open from the second step (thr_iter 1). The augmentation is injected: a
  fixed rot90 / flip / identity policy on both sides. Every buffer value
  lies at least 0.05 from thr_conf, so that no pseudo label flips on
  rounding. Tolerances, those of tests/test_torch_train_step.py and for
  the same reason (the one-pass BN variance summed in different f32
  orders): losses rtol 1e-5, atol 1e-6 at every step; parameters and BN
  running statistics after the third step atol 2e-4, rtol 1e-3.
* The refresh sweep against the JAX ``make_refresh`` at N = 40 (a padded
  second chunk of 32) from a non-zero buffer: within 1e-6 (the eval
  logits agree to f32 rounding of convolutions summed in other orders;
  the buffer takes 0.2 of their softmax).
* ``build()`` + Trainer on a written H5 tree, period_iter 2: the hook
  refreshes on iterations 2 and 4 only; a resume from latest_full.ckpt
  (written at iteration 4 before that iteration's refresh, as the JAX
  trainer orders them) restores that buffer into the bundle's own tensor.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.engine.methods.s2l as js2l  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.data import augment_device as jad  # noqa: E402
from wsl4mis_tpu.data.acdc import AcdcSliceDataset as JaxSlices  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_tpu.ops.pallas.augment_pallas import _sample_policy  # noqa: E402
from wsl4mis_torch.data import synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods import s2l  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.ops import augment as taug  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
HW = 32
B = 4
STEPS = 3
THR_CONF = 0.8
# the injected augmentation of the step test: rot90 / flip and identity
STEP_POLICY = [(0, 1, 0, 0), (2, 0, 0, 0), (0, 2, 1, 0), (0, 3, 0, 0)]
STEP_INDEX = [[0, 1, 2, 3], [4, 5, 6, 7], [6, 1, 3, 4]]


def _maps(b, h, seed):
    """An image batch, scribbles (class 4 on ~80% of the pixels) and weight
    rows in [0, 1)."""
    rs = np.random.RandomState(seed)
    images = rs.standard_normal((b, h, h)).astype(np.float32)
    scribbles = np.where(rs.rand(b, h, h) < 0.2, rs.randint(0, 4, (b, h, h)),
                         4).astype(np.int32)
    weights = rs.rand(b, h, h, 4).astype(np.float32)
    return images, scribbles, weights


def _port_plain(images, scribbles, weights, policy):
    out = taug.augment_batch_s2l(
        torch.from_numpy(images), torch.from_numpy(scribbles),
        torch.from_numpy(weights), torch.tensor(policy, dtype=torch.int32))
    return [t.numpy() for t in out]


def test_s2l_augment_matches_jax_policy_by_policy():
    """The JAX augment_batch_s2l on 24 keyed samples against the port's
    plain version on the same per-sample policies."""
    b = 24
    images, scribbles, weights = _maps(b, HW, seed=0)
    rng = jax.random.key(5)
    branch, k, axis, angle, _ = _sample_policy(jax.random.split(rng, b),
                                               jnp.asarray(scribbles))
    policy = np.stack([np.asarray(v) for v in (branch, k, axis, angle)], 1)
    assert {0, 1, 2} <= set(policy[:, 0].tolist())
    want = [np.asarray(t) for t in jad.augment_batch_s2l(
        rng, jnp.asarray(images), jnp.asarray(scribbles),
        jnp.asarray(weights))]
    got = _port_plain(images, scribbles, weights, policy)
    rotated = policy[:, 0] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[~rotated], w[~rotated])
        assert np.mean(g[rotated] == w[rotated]) >= 0.999


def test_s2l_rotations_fill_every_map_with_zero():
    """All 40 angles at 32x32 against _rotate_nearest with the S2L fills
    (0 for all three maps), >= 99.9% per map; the rotated-in corners are 0
    in every map, the scribble's too although it holds class 4."""
    angles = np.arange(-20, 20)
    images, scribbles, weights = _maps(len(angles), HW, seed=1)
    assert (scribbles == 4).any(axis=(1, 2)).all()
    got = _port_plain(images, scribbles, weights,
                      [(1, 0, 0, a) for a in angles])
    rot = jax.vmap(jad._rotate_nearest, in_axes=(0, 0, None))
    a = jnp.asarray(angles)
    want_i = np.asarray(rot(jnp.asarray(images), a, 0.0))
    want_s = np.asarray(rot(jnp.asarray(scribbles), a, 0))
    want_w = np.stack([np.asarray(rot(jnp.asarray(weights[..., c]), a, 0.0))
                       for c in range(4)], -1)
    for g, w in zip(got, (want_i, want_s, want_w)):
        assert np.mean(g == w) >= 0.999
    img, scr, wgt = got
    for sample in (0, 39):  # -20 and 19 degrees: the corners rotate in
        assert img[sample, 0, 0] == 0.0 and scr[sample, 0, 0] == 0
        assert scr[sample, -1, -1] == 0 and (wgt[sample, 0, 0] == 0).all()
    # every non-zero angle moves the corner's source out of the plane
    turned = angles != 0
    assert (scr[turned, 0, 0] == 0).all() and (img[turned, 0, 0] == 0).all()


class _FakeLib:
    """Stands in for the built library: records the entry point's calls."""

    def __init__(self):
        self.calls = []

    def augment_s2l(self, *args):
        self.calls.append(args)
        return 0


def test_s2l_augment_wrapper_checks_before_it_launches(monkeypatch):
    """The kernel wrapper rejects bad dtypes, shapes, devices and layouts
    in Python before the library is called; a good call makes one call of
    the C entry point (batch and plane size last but the stream) and
    counts one launch. A tensor on neither the CPU nor a card raises."""
    from contextlib import nullcontext

    lib = _FakeLib()
    monkeypatch.setattr(taug._build, "lib", lambda name: lib)
    monkeypatch.setattr(taug._build, "on_device", lambda t: nullcontext())
    monkeypatch.setattr(taug._build, "stream", lambda t: 0)
    monkeypatch.setitem(taug.launches, "augment_s2l", 0)
    img = torch.zeros((3, 8, 8))
    scr = torch.zeros((3, 8, 8), dtype=torch.int32)
    wgt = torch.zeros((3, 8, 8, 4))
    pol = torch.zeros((3, 4), dtype=torch.int32)
    bad = [
        ((img, scr, wgt.double(), pol), TypeError, "float32"),
        ((img, scr.long(), wgt, pol), TypeError, "int32"),
        ((img, scr, wgt[..., :3].contiguous(), pol), ValueError, "disagree"),
        ((img, scr[:2], wgt, pol), ValueError, "disagree"),
        ((torch.zeros((3, 8, 6)), torch.zeros((3, 8, 6), dtype=torch.int32),
          torch.zeros((3, 8, 6, 4)), pol), ValueError, "square"),
        ((img, scr, wgt.to("meta"), pol), ValueError, "different devices"),
        ((img, scr, wgt.transpose(1, 2), pol), ValueError, "contiguous"),
    ]
    for args, err, match in bad:
        with pytest.raises(err, match=match):
            taug._augment_s2l_kernel(*args)
    assert lib.calls == [] and taug.launches["augment_s2l"] == 0
    out = taug._augment_s2l_kernel(img, scr, wgt, pol)
    (args,) = lib.calls
    assert args[7:10] == (3, 8, 8) and len(args) == 11
    assert [tuple(t.shape) for t in out] == [(3, 8, 8), (3, 8, 8),
                                             (3, 8, 8, 4)]
    assert taug.launches["augment_s2l"] == 1
    with pytest.raises(RuntimeError, match="no augment_s2l implementation"):
        taug.augment_batch_s2l(img.to("meta"), scr.to("meta"),
                               wgt.to("meta"), pol.to("meta"))


def _buffer(n, seed):
    """A weight buffer every value of which lies >= 0.05 from THR_CONF:
    [0, 0.75) or [0.85, 1.0), about half each."""
    u = np.random.RandomState(seed).rand(n, HW, HW, 4)
    w = np.where(u < 0.5, u * 1.5, 0.85 + (u - 0.5) * 0.3)
    assert np.abs(w - THR_CONF).min() >= 0.05 - 1e-7
    return w.astype(np.float32)


def _flax_variables(seed=0):
    """Flax UNet variables at reduced width, BN running statistics moved
    off their init so that eval mode reads them."""
    jmodel = junet.UNet(features=FEATURES, dropout=NO_DROPOUT,
                        dtype=jnp.float32)
    key = jax.random.key(seed)
    variables = jax.tree.map(np.array, jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, HW, HW, 1)),
        train=False))
    rs = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + 0.1 * rs.rand(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    return jmodel, variables


def _states(cfg_kw, weight):
    """(JAX state, port state) from the same variables and buffer."""
    jmodel, variables = _flax_variables()
    jcfg = JaxConfig(**cfg_kw)
    jstate = JaxState.create(
        apply_fn=jmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        tx=reference_sgd(jcfg.base_lr, jcfg.max_iterations),
        extra={"weight": jnp.asarray(weight)})
    cfg = TrainConfig(device="cpu", **cfg_kw)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    load_flax_variables(model, variables)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations),
        extra={"weight": torch.from_numpy(weight.copy())})
    return (jcfg, jstate), (cfg, state)


def _fixed_jax_augment(rng, images, scribbles, weights):
    """JAX's own rot90 / flip per STEP_POLICY row (identity for branch 2),
    channelwise on the weight rows, as _augment_one_multi applies them."""
    def one(arr, branch, k, axis):
        if branch == 2:
            return arr
        if arr.ndim == 2:
            return jad._rot90_flip(arr, k, axis)
        return jnp.stack([jad._rot90_flip(arr[..., c], k, axis)
                          for c in range(arr.shape[-1])], -1)

    return tuple(
        jnp.stack([one(m[i], *STEP_POLICY[i][:3]) for i in range(B)])
        for m in (images, scribbles, weights))


@pytest.mark.parametrize("thr_iter", [100, 1], ids=["gate_off", "gate_on"])
def test_three_steps_match(thr_iter, monkeypatch):
    n = 8
    images, scribbles, _ = _maps(n, HW, seed=2)
    weight = _buffer(n, seed=3)
    cfg_kw = dict(method="s2l", batch_size=B, patch_size=(HW, HW),
                  max_iterations=100, compute_dtype="float32",
                  sup_type="scribble", thr_iter=thr_iter, thr_conf=THR_CONF)
    (jcfg, jstate), (cfg, state) = _states(cfg_kw, weight)
    monkeypatch.setattr(js2l, "augment_batch_s2l", _fixed_jax_augment)
    jstep = jax.jit(js2l.make_step(jcfg))
    policy = torch.tensor(STEP_POLICY, dtype=torch.int32)
    monkeypatch.setattr(s2l, "augment_batch_s2l",
                        lambda gen, *maps: taug.augment_batch_s2l(*maps,
                                                                  policy))
    step = s2l.make_step(cfg)
    aux = {"images": torch.from_numpy(images),
           "labels": torch.from_numpy(scribbles.astype(np.uint8))}
    for t, idx in enumerate(STEP_INDEX):
        idx = np.asarray(idx, np.int32)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(images[idx]),
                                    "label": jnp.asarray(scribbles[idx]),
                                    "index": jnp.asarray(idx)},
                           jax.random.key(100 + t))
        tm = step(state, {"index": idx}, split_rngs(0, t, "cpu"), aux)
        assert set(tm) == set(jm)
        for k in tm:
            if k != "vis":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
        # the pseudo-label term is live, and counts only once the gate opens
        assert float(tm["loss_u"]) > 0
        opened = t >= thr_iter
        assert (float(tm["total_loss"]) != float(tm["loss_ce"])) == opened
    assert state.step == int(jstate.step) == STEPS
    want = from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = dict(state.model.state_dict())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=k)
    # the step reads the buffer, it does not write it
    np.testing.assert_array_equal(state.extra["weight"].numpy(), weight)


def test_pseudo_labels_later_class_wins():
    """Class c where unscribbled and weight[..., c] > thr, later c winning;
    scribbled pixels and pixels with no class over thr stay 4."""
    scribbles = torch.tensor([[[4, 4, 4, 1]]], dtype=torch.int32)
    weights = torch.tensor([[[[0.9, 0.9, 0.1, 0.1], [0.1, 0.1, 0.1, 0.1],
                              [0.9, 0.1, 0.1, 0.81], [0.9, 0.9, 0.9, 0.9]]]])
    got = s2l.pseudo_labels(scribbles, weights, 0.8)
    assert got.tolist() == [[[1, 4, 3, 4]]]


def test_refresh_matches_jax():
    n = 40  # a full chunk of 32 and a zero-padded one
    images = np.random.RandomState(4).standard_normal(
        (n, HW, HW)).astype(np.float32)
    weight = np.random.RandomState(5).rand(n, HW, HW, 4).astype(np.float32)
    cfg_kw = dict(method="s2l", patch_size=(HW, HW), compute_dtype="float32")
    (jcfg, jstate), (cfg, state) = _states(cfg_kw, weight)
    want = np.asarray(js2l.make_refresh(jcfg, images)(jstate).extra["weight"])
    stats = {k: v.clone() for k, v in state.model.state_dict().items()}
    s2l.make_refresh(cfg, torch.from_numpy(images))(state)
    got = state.extra["weight"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - weight).max() > 1e-2  # it moved, both chunks
    assert np.abs(got[32:] - weight[32:]).max() > 1e-2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, stats[k]), k  # no BN statistics touched


def _write_tree(root):
    """fold1 layout: 10 train slices of patient 21 (40x48; label and
    scribble keys), val volumes of patients 1-2 (3x40x48)."""
    os.makedirs(os.path.join(root, "ACDC_training_slices"))
    os.makedirs(os.path.join(root, "ACDC_training_volumes"))
    data = synthetic_slices(10, (40, 48), seed=5)
    scrib = synthetic_slices(10, (40, 48), seed=5, sup_type="scribble")
    for i in range(10):
        name = f"patient021_frame01_slice_{i}.h5"
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


def _recorded(bundle, log):
    """Wrap the bundle's host hook: log (iter_num, buffer before, after)."""
    hook = bundle.host_hook

    def recording(b, state, iter_num):
        before = state.extra["weight"].clone()
        hook(b, state, iter_num)
        log.append((iter_num, before, state.extra["weight"].clone()))

    bundle.host_hook = recording


def test_build_trainer_refreshes_and_resumes_the_buffer(tmp_path):
    root = _write_tree(tmp_path / "acdc")
    cfg = TrainConfig(method="s2l", device="cpu", root_path=root,
                      patch_size=(32, 32), batch_size=4, max_iterations=4,
                      val_every=4, ckpt_every=2, period_iter=2, thr_iter=2,
                      compute_dtype="float32", sup_type="label",
                      snapshot_root=str(tmp_path / "snap"), log_every=2,
                      seed=3)
    bundle = get_method("s2l").build(cfg)
    # scribbles whatever sup_type says, staged as the JAX build reads them
    train = JaxSlices(base_dir=root, sup_type="scribble", patch_size=(32, 32))
    np.testing.assert_array_equal(bundle.aux["images"].numpy(), train.images)
    np.testing.assert_array_equal(bundle.aux["labels"].numpy(), train.labels)
    assert bundle.steps_per_epoch == 10 // 4
    weight = bundle.state.extra["weight"]
    assert weight.shape == (10, 32, 32, 4) and not weight.any()
    log = []
    _recorded(bundle, log)
    assert Trainer(cfg, bundle, use_tensorboard=False).train() == \
        "Training Finished!"
    assert [it for it, _, _ in log] == [1, 2, 3, 4]
    moved = [it for it, before, after in log if not torch.equal(before,
                                                                after)]
    assert moved == [2, 4]
    snap = cfg.snapshot_path
    for name in ("iter_2.pth", "iter_4.pth", "latest_full.ckpt"):
        assert os.path.isfile(os.path.join(snap, name)), name
    with open(os.path.join(snap, "log.txt")) as f:
        assert "iteration 4 : mean_dice" in f.read()

    # the checkpoint of iteration 4 holds the buffer from before its refresh
    cfg2 = cfg.replace(max_iterations=6, resume=True)
    bundle2 = get_method("s2l").build(cfg2)
    weight2 = bundle2.state.extra["weight"]
    ptr = weight2.data_ptr()
    log2 = []
    _recorded(bundle2, log2)
    trainer2 = Trainer(cfg2, bundle2, use_tensorboard=False)
    assert bundle2.state.step == 4 and bundle2.state.opt.count == 4
    assert bundle2.state.extra["weight"] is weight2
    assert weight2.data_ptr() == ptr
    torch.testing.assert_close(weight2, log[-1][1], rtol=0, atol=0)
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(bundle2.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    trainer2.train()
    assert bundle2.state.step == 6
    assert [it for it, before, after in log2
            if not torch.equal(before, after)] == [6]
    assert bundle2.state.extra["weight"].data_ptr() == ptr
