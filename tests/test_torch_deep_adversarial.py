"""The FCDiscriminator and deep_adversarial (DAN) in both packages, on the
CPU in f32.

* The discriminator's eval forward at 256x256 (pool window 7, a 2x2x512
  map flattened in (h, w, c) order into the dense head) against flax,
  from the same parameters (through utils.params): logits within rtol
  1e-5, atol 1e-6 of the largest.
* The reference Adam against optax.adam over three updates: parameters and
  both moments within rtol 1e-6, atol 1e-9.
* Three DAN steps from the same parameters and batches (batch 4,
  labeled_bs 2, 64x64, features (4, 8, 8, 16, 16), dropout 0,
  augmentation the identity on both sides, the discriminator's two channel
  dropout masks of each D-step injected: on the JAX side by the key flax
  hands each dropout, found by an apply on zeros). Tolerances:
  losses rtol 1e-5, atol 1e-6 at every step; segmenter parameters and BN
  statistics after three steps atol 2e-4, rtol 1e-3 (as
  tests/test_torch_train_step.py); the discriminator's parameters within
  atol 5e-6, and both Adam moments within 1e-5 of each tensor's largest.
  The D-step's gradients come through the updated segmenter, which the two
  packages compute in other f32 orders: measured 1.5e-6 (parameters), 4.4e-6
  and 2.1e-6 of the largest (moments). A wrong update shows: each moves a
  weight by ~1e-4, and Adam without bias correction takes a 35% larger
  second step; b1 or b2 wrong by 0.01 moves a moment by 10%.
* build() on a synthetic H5 tree with a labeled patient, and a Trainer run
  with a latest_full.ckpt resume that restores the discriminator and its
  Adam state.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.deep_adversarial as jdan  # noqa: E402
import wsl4mis_tpu.models.discriminator as jdisc  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods.common import split_rngs as jax_split  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
import wsl4mis_torch.engine.methods.common as tcommon  # noqa: E402
from test_torch_semi import KeyedDraws, semi_cfg, write_semi_tree  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import deep_adversarial, get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import (  # noqa: E402
    ReferenceSGD,
    adam_init,
    reference_adam,
)
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.models import FCDiscriminator, net_factory  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
STEPS = 3
B, LBS, HW = 4, 2, 64


def _flax_disc(hw, seed=0):
    disc = jdisc.FCDiscriminator(num_classes=4, dtype=jnp.float32)
    key = jax.random.key(seed)
    params = disc.init({"params": key, "feature_perturb": key},
                       jnp.zeros((1, hw, hw, 4)), jnp.zeros((1, hw, hw, 1)),
                       train=False)["params"]
    return disc, params


def _port_disc(params, hw):
    disc = FCDiscriminator(4, (hw, hw), dtype=torch.float32)
    load_flax_variables(disc, {"params": jax.tree.map(np.asarray, params)})
    return disc


def test_discriminator_eval_forward_matches_flax_at_256():
    jd, params = _flax_disc(256)
    assert params["Dense_0"]["kernel"].shape == (2 * 2 * 512, 2)
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((2, 256, 256, 4)).astype(np.float32)
    seg = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    image = rs.standard_normal((2, 256, 256, 1)).astype(np.float32)
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(seg),
                               jnp.asarray(image), train=False))
    disc = _port_disc(params, 256)
    with torch.no_grad():
        got = disc(torch.from_numpy(seg), torch.from_numpy(image),
                   train=False)
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_reference_adam_matches_optax():
    rs = np.random.RandomState(1)
    shapes = {"a": (3, 5), "b": (7,)}
    params_np = {k: rs.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
    tx = optax.adam(1e-4, b1=0.9, b2=0.99, eps=1e-8)
    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    jopt = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    state = adam_init(params)
    for _ in range(3):
        grads_np = {k: (rs.standard_normal(s) * 10.0 ** rs.randint(-4, 2, s)
                        ).astype(np.float32) for k, s in shapes.items()}
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in
                                   grads_np.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        reference_adam(params, {k: torch.from_numpy(v) for k, v in
                                grads_np.items()}, state)
    assert state["count"] == int(jopt[0].count) == 3
    for k in shapes:
        for got, want in ((params[k], jparams[k]),
                          (state["mu"][k], jopt[0].mu[k]),
                          (state["nu"][k], jopt[0].nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def _batches():
    rs = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
        images = labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1
        out.append({"image": images.astype(np.float32), "label": labels})
    return out


def _disc_dropout_keys(jd, dparams, rng):
    """The keys the D-step's two channel dropouts are given at step key
    `rng` (flax derives them from rngs["disc"] and the module path alone,
    so an apply on zeros finds them)."""
    rngs = jax_split(rng, ("aug", "dropout", "dropout2", "feature_perturb",
                           "disc"))
    seen = []

    def record(key, x, rate=0.5):
        seen.append(key)
        return x

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jdisc, "channel_dropout", record)
        jd.apply({"params": dparams}, jnp.zeros((B, HW, HW, 4)),
                 jnp.zeros((B, HW, HW, 1)), train=True,
                 rngs={"feature_perturb": rngs["disc"]})
    return seen


def test_three_steps_match(monkeypatch):
    common = dict(method="deep_adversarial", batch_size=B, labeled_bs=LBS,
                  patch_size=(HW, HW), max_iterations=100,
                  compute_dtype="float32", sup_type="label")
    jd, dparams = _flax_disc(HW, seed=1)
    rs = np.random.RandomState(9)
    masks = [[rs.rand(B, 1, 1, c) < 0.5 for c in (128, 256)]
             for _ in range(STEPS)]
    tables = {128: KeyedDraws(), 256: KeyedDraws()}
    for t in range(STEPS):
        keys = _disc_dropout_keys(jd, dparams, jax.random.key(100 + t))
        for key, mask in zip(keys, masks[t]):
            tables[mask.shape[-1]].add(key, mask.astype(np.float32))

    def keyed_channel_dropout(rng, x, rate=0.5):
        keep = tables[x.shape[-1]](rng) > 0.5
        return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

    monkeypatch.setattr(jdisc, "channel_dropout", keyed_channel_dropout)
    monkeypatch.setattr(jcommon, "_augment_impl",
                        lambda: (lambda rng, images, labels: (images, labels)))
    monkeypatch.setattr(tcommon, "augment_batch",
                        lambda gen, images, labels: (images, labels))

    jcfg = JaxConfig(**common)
    jmodel = junet.UNet(features=FEATURES, dropout=NO_DROPOUT,
                        dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jmodel.init({"params": key, "dropout": key},
                            jnp.zeros((1, HW, HW, 1)), train=False)
    disc_tx = optax.adam(1e-4, b1=0.9, b2=0.99, eps=1e-8)
    jstate = JaxState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=reference_sgd(jcfg.base_lr, jcfg.max_iterations),
        extra={"disc_params": dparams,
               "disc_opt_state": disc_tx.init(dparams)})
    jstep = jax.jit(jdan.make_step(jcfg, jd, disc_tx))

    cfg = TrainConfig(device="cpu", **common)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    disc = _port_disc(dparams, HW)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations),
        extra=deep_adversarial.discriminator_extra(disc))
    step = deep_adversarial.make_step(cfg, disc)

    for t, batch in enumerate(_batches()):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.key(100 + t))
        tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  split_rngs(0, t, "cpu"),
                  channel_masks=[torch.from_numpy(m) for m in masks[t]])
        assert set(tm) == set(jm)
        for k in tm:
            if k != "vis":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == int(jstate.step) == STEPS

    want = from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=k)
    adam = jstate.extra["disc_opt_state"][0]
    assert state.extra["disc_opt_state"]["count"] == int(adam.count) == STEPS
    moved = 0.0
    for name, tree, atol in (
            ("disc_params", jstate.extra["disc_params"], 5e-6),
            ("mu", adam.mu, 1e-5), ("nu", adam.nu, 1e-5)):
        ours = (state.extra[name] if name == "disc_params"
                else state.extra["disc_opt_state"][name])
        for k, v in from_flax({"params": jax.tree.map(np.asarray, tree)}
                              ).items():
            scale = 1.0 if name == "disc_params" else float(v.abs().max())
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                       atol=atol * scale,
                                       err_msg=f"{name} {k}")
    for k, p in disc.named_parameters():  # the module computes with them
        assert p.data_ptr() == state.extra["disc_params"][k].data_ptr()
        moved = max(moved, float((p.detach() - torch.from_numpy(np.asarray(
            from_flax({"params": jax.tree.map(np.asarray, dparams)})[k]
        ))).abs().max()))
    assert moved > 1e-4


@pytest.fixture(scope="module")
def semi_tree(tmp_path_factory):
    return write_semi_tree(tmp_path_factory.mktemp("acdc_dan"))


def test_build_and_trainer_resume_restore_the_discriminator(semi_tree,
                                                             tmp_path):
    """build() stages [labeled; unlabeled] and a discriminator drawn from
    seed + 1; Trainer runs 4 steps (validation, checkpoints); a resume from
    latest_full.ckpt restores the discriminator and its Adam state into
    the new bundle's own tensors, and trains on."""
    cfg = semi_cfg(semi_tree, tmp_path, "deep_adversarial")
    bundle = get_method("deep_adversarial").build(cfg)
    assert bundle.aux["images"].shape == (10, 32, 32)
    assert bundle.steps_per_epoch == 3
    extra = bundle.state.extra
    assert set(extra) == {"disc_params", "disc_opt_state"}
    start = {k: v.clone() for k, v in extra["disc_params"].items()}
    Trainer(cfg, bundle, use_tensorboard=False).train()
    assert extra["disc_opt_state"]["count"] == 4
    assert any(not torch.equal(start[k], v)
               for k, v in extra["disc_params"].items())
    for name in ("iter_2.pth", "iter_4.pth", "latest_full.ckpt"):
        assert os.path.isfile(os.path.join(cfg.snapshot_path, name)), name

    cfg2 = cfg.replace(max_iterations=6, resume=True)
    bundle2 = get_method("deep_adversarial").build(cfg2)
    extra2 = bundle2.state.extra
    ptrs = {k: v.data_ptr() for k, v in extra2["disc_params"].items()}
    trainer2 = Trainer(cfg2, bundle2, use_tensorboard=False)
    assert bundle2.state.step == 4
    assert extra2["disc_opt_state"]["count"] == 4
    for k, v in extra["disc_params"].items():
        assert extra2["disc_params"][k].data_ptr() == ptrs[k]
        torch.testing.assert_close(extra2["disc_params"][k], v, rtol=0,
                                   atol=0)
        for m in ("mu", "nu"):
            torch.testing.assert_close(extra2["disc_opt_state"][m][k],
                                       extra["disc_opt_state"][m][k],
                                       rtol=0, atol=0)
    trainer2.train()
    assert bundle2.state.step == 6
    assert extra2["disc_opt_state"]["count"] == 6
