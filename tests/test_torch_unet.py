"""Parity of the port's UNet and UNetCCT (on the CPU, f32) with the JAX
package's, from the same flax variables through utils.params: eval-mode
logits, train-mode logits (dropout 0, injected channel-dropout masks) and
the updated BN running statistics. Tolerance 1e-4 (f32; the two differ
only in summation order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5


def _jax_model(name):
    cls = {"unet": junet.UNet, "unet_cct": junet.UNetCCT}[name]
    model = cls(features=FEATURES, dropout=NO_DROPOUT, dtype=jnp.float32)
    key = jax.random.key(0)
    variables = model.init({"params": key, "dropout": key,
                            "feature_perturb": key},
                           jnp.zeros((1, 32, 32, 1)), train=False)
    # give the BN statistics non-trivial values so eval mode tests them
    rs = np.random.RandomState(1)
    variables = jax.tree.map(np.asarray, variables)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + rs.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return model, variables


def _port_model(name, variables):
    model = net_factory(name, 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    load_flax_variables(model, variables)
    return model


def _x(seed=2):
    return np.random.RandomState(seed).standard_normal(
        (2, 32, 32, 1)).astype(np.float32)


def _masks(seed=3):
    rs = np.random.RandomState(seed)
    return [rs.rand(2, 1, 1, c) < 0.5 for c in FEATURES]


def _bn_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


def test_bridge_covers_every_entry():
    for name in ("unet", "unet_cct"):
        _, variables = _jax_model(name)
        sd = from_flax(variables)
        model = net_factory(name, 4, dtype=torch.float32, features=FEATURES)
        assert set(sd) == set(model.state_dict())
        assert all(sd[k].shape == v.shape
                   for k, v in model.state_dict().items())


@pytest.mark.parametrize("name", ["unet", "unet_cct"])
def test_eval_logits_match(name):
    jm, variables = _jax_model(name)
    tm = _port_model(name, variables)
    want = jm.apply(variables, jnp.asarray(_x()), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(_x()), train=False)
    if name == "unet":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("name", ["unet", "unet_cct"])
def test_train_logits_and_running_stats_match(name, monkeypatch):
    jm, variables = _jax_model(name)
    tm = _port_model(name, variables)
    masks = _masks()
    queue = list(masks)

    def fixed_channel_dropout(rng, x, rate=0.5):
        keep = jnp.asarray(queue.pop(0))
        return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

    monkeypatch.setattr(junet, "channel_dropout", fixed_channel_dropout)
    key = jax.random.key(5)
    want, mut = jm.apply(variables, jnp.asarray(_x()), train=True,
                         rngs={"dropout": key, "feature_perturb": key},
                         mutable=["batch_stats"])
    kwargs = {}
    if name == "unet_cct":
        kwargs["channel_masks"] = [torch.from_numpy(m) for m in masks]
    else:
        want = (want,)
    got = tm(torch.from_numpy(_x()), train=True, **kwargs)
    if name == "unet":
        got = (got,)
    for w, g in zip(want, got):
        _close(g.detach(), w)
    want_stats = {k: v.numpy() for k, v in from_flax(
        {"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}
    ).items()}
    got_stats = _bn_stats(tm)
    assert set(want_stats) == set(got_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k])
