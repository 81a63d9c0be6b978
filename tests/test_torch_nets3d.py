"""Parity of the port's 3D nets (net_factory_3d) and legacy GAN blocks with
the JAX package's (on the CPU, f32), from the same flax variables through
utils.params.

The 3D nets at their published filters (UNet3D and AttentionUNet3D at
feature_scale 4, VNet at 16 filters, VoxResNet at 64), 1 channel, 2
classes, on a 2x16x16x16 input (VNet's train mode at 32^3, TRAIN_D):
eval-mode logits to 1e-5 of the largest; train mode with the dropout
masks injected on both sides: logits and the
updated BN running statistics (VNet, the attention gates) to 1e-4 of the
largest and each parameter gradient of a fixed linear loss to GRAD_TOL
in norm (the BN-variance spread of ROADMAP Queue 3; a conv bias feeding a
train-mode BN has a zero gradient, which the port's must meet to
ZERO_GRAD of the largest gradient element).

The legacy GAN (ResnetGenerator, UnetGenerator, NLayerDiscriminator at
narrow widths on 2x32x32x1) likewise, its ResnetBlock dropout masks
injected; select_initializer's schemes against flax's initializers in
their statistics; get_schedule and gan_loss against the JAX functions.

``interp_axis`` (their and ScribbleVC's upsampling): its forward is the
index_select expression bit for bit, and its backward, a fixed-order
product with the interpolation matrix (index_select's index_add
accumulates with atomics on the card), agrees with index_select's
autograd and with jax.grad of nets3d._interp_axis to 1e-6 of the largest
gradient element."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.models.legacy_gan as jgan  # noqa: E402
import wsl4mis_tpu.models.nets3d as jnets  # noqa: E402
from wsl4mis_torch.models import legacy_gan as pgan  # noqa: E402
from wsl4mis_torch.models.layers import interp_axis  # noqa: E402
from wsl4mis_torch.models.nets3d import net_factory_3d  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

EVAL_RTOL = 1e-5
TRAIN_TOL = 1e-4
GRAD_TOL = 5e-2
ZERO_GRAD = 1e-5
NETS3D = ["unet_3D", "attention_unet", "vnet", "voxresnet"]
D = 16
# VNet normalises its 1^3 deepest level by the statistics of the batch's
# two values a channel at 16^3, where JAX against itself moves the
# train-mode logits by 3.5e-2 (batch reversed); at 32^3 (16 values) by
# 7e-5: its train-mode check runs there
TRAIN_D = {"vnet": 32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gan(name):
    """(JAX model, port model, input shape) of a narrow legacy GAN block."""
    if name == "resnet_generator":
        return (jgan.ResnetGenerator(ngf=8, n_blocks=2),
                pgan.ResnetGenerator(ngf=8, n_blocks=2))
    if name == "unet_generator":
        return (jgan.UnetGenerator(num_downs=4, ngf=8),
                pgan.UnetGenerator(num_downs=4, ngf=8))
    return (jgan.NLayerDiscriminator(ndf=8),
            pgan.NLayerDiscriminator(ndf=8))


def _models(name):
    if name in NETS3D:
        return (jnets.net_factory_3d(name, 2, dtype=jnp.float32),
                net_factory_3d(name, 2, dtype=torch.float32))
    return _gan(name)


def _x(name, seed=2, d=D):
    shape = (2, d, d, d, 1) if name in NETS3D else (2, 32, 32, 1)
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _kwargs(name, train):
    if name == "nlayer_discriminator":
        return {}
    return {"train": train}


_VARIABLES = {}


def _variables(name):
    """Flax variables of the JAX model (jitted init), BN running statistics
    moved by a seeded draw so that eval mode tests them."""
    if name not in _VARIABLES:
        jm = _models(name)[0]
        key = jax.random.key(0)
        v = jax.jit(lambda k: jm.init(
            {"params": k, "dropout": k}, jnp.asarray(_x(name)[:1]),
            **_kwargs(name, False)))(key)
        v = jax.tree.map(np.asarray, v)
        if "batch_stats" in v:
            rs = np.random.RandomState(1)
            v["batch_stats"] = jax.tree.map(
                lambda a: (a + rs.uniform(0.1, 0.5, a.shape)).astype(
                    np.float32), v["batch_stats"])
        _VARIABLES[name] = v
    return _VARIABLES[name]


def _port(name):
    model = _models(name)[1]
    load_flax_variables(model, _variables(name))
    return model


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


ALL = NETS3D + ["resnet_generator", "unet_generator", "nlayer_discriminator"]


@pytest.mark.parametrize("name", ALL)
def test_bridge_covers_every_entry(name):
    model = _models(name)[1]
    sd = from_flax(_variables(name), model.flax_key)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == v.shape for k, v in own.items())


@pytest.mark.parametrize("name", ALL)
def test_eval_logits_match(name):
    jm = _models(name)[0]
    want = jax.jit(lambda v, x: jm.apply(v, x, **_kwargs(name, False)))(
        _variables(name), jnp.asarray(_x(name)))
    with torch.no_grad():
        got = _port(name)(torch.from_numpy(_x(name)), **_kwargs(name, False))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= EVAL_RTOL


# the dropout draws of each model in train mode: (shape of a keep mask
# for batch 2, keep probability), in forward order
def _mask_shapes(name):
    if name == "unet_3D":
        return [((2, 1, 1, 1, 256), 0.7), ((2, D, D, D, 16), 0.7)]
    if name == "vnet":
        return [((2, 1, 1, 1, 256), 0.5), ((2, 1, 1, 1, 16), 0.5)]
    if name == "resnet_generator":
        return [((2, 8, 8, 32), 0.5)] * 2
    return []


TRAINED = ["unet_3D", "attention_unet", "vnet", "voxresnet",
           "resnet_generator", "unet_generator"]


@pytest.mark.parametrize("name", TRAINED)
def test_train_logits_stats_and_gradients_match(name, monkeypatch):
    """Train mode with injected masks. UNet3D's element dropout of the
    centre is flax's nn.Dropout over the full shape: its mask is drawn
    at (2, 1, 1, 1, 256) and broadcast, a valid draw of that shape (the
    centre is 1x1x1 at 16^3)."""
    rs = np.random.RandomState(3)
    masks = [rs.rand(*shape) < p for shape, p in _mask_shapes(name)]
    queue = list(masks)

    def bernoulli(key, p, shape=None):
        keep = jnp.asarray(queue.pop(0))
        return jnp.broadcast_to(keep, shape) if shape is not None else keep

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    jm, v = _models(name)[0], _variables(name)
    x = _x(name, d=TRAIN_D.get(name, D))
    out_shape = jax.eval_shape(
        lambda: jm.apply(v, jnp.asarray(x), **_kwargs(name, False))).shape
    w = np.random.RandomState(4).standard_normal(out_shape).astype(
        np.float32)
    mutable = ["batch_stats"] if "batch_stats" in v else []

    def loss(params):
        out, mut = jm.apply({**v, "params": params}, jnp.asarray(x),
                            train=True, rngs={"dropout": jax.random.key(5)},
                            mutable=mutable)
        return jnp.sum(out * w), (out, mut)

    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    assert not queue

    tm = _port(name)
    kwargs = {"drop_masks": [torch.from_numpy(np.broadcast_to(
        m, s).copy()) for m, (s, _) in zip(masks, _mask_shapes(name))]
        } if masks else {}
    got = tm(torch.from_numpy(x), train=True, **kwargs)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(got.detach(), want) <= TRAIN_TOL
    if mutable:
        stats = tm.state_dict()
        for k, val in from_flax({"batch_stats": jax.tree.map(
                np.asarray, mut["batch_stats"])}, tm.flax_key).items():
            assert _rel(stats[k], val) <= TRAIN_TOL, k
    want_grads = from_flax({"params": jax.tree.map(np.asarray, grads)},
                           tm.flax_key)
    params = dict(tm.named_parameters())
    assert set(want_grads) == set(params)
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for k, g in want_grads.items():
        got_g, g = params[k].grad.numpy(), g.numpy()
        if np.abs(g).max() <= ZERO_GRAD * gmax:
            assert np.abs(got_g).max() <= ZERO_GRAD * gmax, k
            continue
        err = np.linalg.norm(got_g - g) / np.linalg.norm(g)
        assert err <= GRAD_TOL, (k, err)


@pytest.mark.parametrize("name", ["unet_3D", "vnet", "resnet_generator"])
def test_dropout_draws_come_from_the_dropout_generator(name):
    model = _models(name)[1]
    x = torch.from_numpy(_x(name))

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, rngs={
                "dropout": torch.Generator().manual_seed(seed)})

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def _interp_index_select(x, axis, out_size, align_corners):
    """interp_axis's forward as it was written before its backward became
    deterministic: two index_selects, differentiated by autograd."""
    in_size = x.shape[axis]
    pos = torch.arange(out_size, dtype=torch.float32)
    if align_corners and out_size > 1:
        src = pos * ((in_size - 1) / (out_size - 1))
    else:
        src = (pos + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0, in_size - 1)
    lo = src.floor()
    w = (src - lo).to(x.dtype)
    lo = lo.long()
    hi = (lo + 1).clamp(max=in_size - 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.view(shape)
    return (x.index_select(axis, lo) * (1 - w)
            + x.index_select(axis, hi) * w)


def _grad_fns(fn):
    seen, stack = set(), [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack.extend(n for n, _ in f.next_functions)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("axis, out_size, align_corners", [
    (1, 14, True), (2, 10, False), (3, 12, True), (1, 3, False),
    (2, 5, True)])
def test_interp_axis_backward_has_no_index_add(axis, out_size,
                                               align_corners):
    rs = np.random.RandomState(axis * 100 + out_size)
    x_np = rs.standard_normal((2, 7, 5, 6, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = interp_axis(x, axis, out_size, align_corners)
    x0 = torch.from_numpy(x_np).requires_grad_(True)
    y0 = _interp_index_select(x0, axis, out_size, align_corners)
    assert torch.equal(y, y0)
    assert "IndexSelectBackward0" not in _grad_fns(y.grad_fn)
    assert "IndexSelectBackward0" in _grad_fns(y0.grad_fn)
    g_np = rs.standard_normal(tuple(y.shape)).astype(np.float32)
    g = torch.from_numpy(g_np)
    (got,) = torch.autograd.grad(y, x, g)
    (want,) = torch.autograd.grad(y0, x0, g)
    _, vjp = jax.vjp(lambda a: jnets._interp_axis(a, axis, out_size,
                                                  align_corners),
                     jnp.asarray(x_np))
    (jgrad,) = vjp(jnp.asarray(g_np))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got.numpy() - np.asarray(jgrad)).max() <= 1e-6 * scale


def test_net_factory_3d_builds_every_name():
    for name in NETS3D:
        model = net_factory_3d(name, 3, dtype=torch.float32)
        with torch.no_grad():
            out = model(torch.zeros(1, D, D, D, 1))
        assert out.shape == (1, D, D, D, 3) and out.dtype == torch.float32
    with pytest.raises(KeyError):
        net_factory_3d("resnet50")


def test_kaiming_init_of_the_3d_convs():
    """Conv3's kaiming-normal kernels (fan in), zero biases, DHWIO."""
    model = net_factory_3d("voxresnet", 2, dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))
    k = model.vox_rex[0].conv3[0].kernel.detach()
    assert k.shape == (3, 3, 3, 64, 64)
    assert abs(float(k.std()) / math.sqrt(2.0 / (27 * 64)) - 1) < 0.02
    assert float(model.conv3[0].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("scheme", ["normal", "xavier", "kaiming"])
def test_select_initializer_matches_flax_statistics(scheme):
    shape = (4, 4, 64, 96)
    want = np.asarray(jgan.select_initializer(scheme)(
        jax.random.key(0), shape, jnp.float32))
    got = pgan.select_initializer(scheme)(
        torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    assert abs(got.std() / want.std() - 1) < 0.02
    assert abs(got.mean()) < 0.05 * want.std()


def test_select_initializer_orthogonal():
    got = pgan.select_initializer("orthogonal")(
        torch.empty(3, 3, 8, 16), torch.Generator().manual_seed(0))
    m = got.reshape(-1, 16)
    np.testing.assert_allclose((m.t() @ m).numpy(), np.eye(16), atol=1e-5)
    with pytest.raises(ValueError):
        pgan.select_initializer("bogus")


@pytest.mark.parametrize("policy", ["lambda", "step"])
def test_get_schedule_matches(policy):
    kw = {"niter": 10, "niter_decay": 20, "lr_decay_iters": 7}
    want = jgan.get_schedule(policy, 0.01, **kw)
    got = pgan.get_schedule(policy, 0.01, **kw)
    for step in range(0, 40, 3):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)


@pytest.mark.parametrize("lsgan", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches(lsgan, real):
    logits = np.random.RandomState(0).standard_normal((2, 5, 5, 1)).astype(
        np.float32)
    want = float(jgan.gan_loss(jnp.asarray(logits), real, lsgan))
    got = float(pgan.gan_loss(torch.from_numpy(logits), real, lsgan))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_fc3d_discriminator_matches(train, monkeypatch):
    """FC3DDiscriminator (ndf 8, 2 classes) on a 2x32^3 softmax map and
    image, from the same flax variables: logits to 1e-5 of the largest;
    in train mode with its three channel-dropout masks injected on both
    sides (JAX draws them from the feature_perturb stream)."""
    from wsl4mis_tpu.models.discriminator import (
        FC3DDiscriminator as JaxFC3D,
    )
    from wsl4mis_torch.models.discriminator import FC3DDiscriminator

    rs = np.random.RandomState(6)
    seg = rs.rand(2, 32, 32, 32, 2).astype(np.float32)
    img = rs.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    masks = [rs.rand(2, 1, 1, 1, c) < 0.5 for c in (8, 16, 32)]
    queue = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(queue.pop(0)))
    jm = JaxFC3D(num_classes=2, ndf=8, dtype=jnp.float32)
    key = jax.random.key(0)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": key, "feature_perturb": key}, jnp.asarray(seg),
        jnp.asarray(img), train=False))
    want = jm.apply(v, jnp.asarray(seg), jnp.asarray(img), train=train,
                    rngs={"feature_perturb": key})
    assert not queue if train else len(queue) == 3
    tm = FC3DDiscriminator(num_classes=2, ndf=8, patch_size=(32, 32, 32),
                           dtype=torch.float32)
    load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(seg), torch.from_numpy(img), train=train,
                 channel_masks=[torch.from_numpy(m) for m in masks])
    assert got.shape == (2, 2) and got.dtype == torch.float32
    assert _rel(got, want) <= EVAL_RTOL
