"""Every loss and ramp this slice ported (wsl4mis_torch/ops/losses.py past
the main path's, ops/ramps.py, methods/common.sigmoid_rampup) against its
JAX counterpart on the CPU in f32: value and gradient with respect to the
first differentiable input, from inputs made with a numpy seed.

Tolerance: rtol 2e-5 and atol 1e-6 times the reference's largest magnitude,
for values and gradients alike: both sides are f32 and differ in summation
order and in exp/log by an ulp or two; mumford_shah and size_loss sum
~1e4 terms."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wsl4mis_tpu.engine.methods.common import sigmoid_rampup_jnp  # noqa: E402
from wsl4mis_tpu.ops import losses as jl  # noqa: E402
from wsl4mis_tpu.ops import ramps as jramps  # noqa: E402
from wsl4mis_torch.engine.methods.common import sigmoid_rampup  # noqa: E402
from wsl4mis_torch.ops import losses as tl  # noqa: E402
from wsl4mis_torch.ops import ramps as tramps  # noqa: E402

B, H, W, C = 2, 12, 10, 4


def _rs():
    return np.random.RandomState(11)


def _logits(rs, shape=(B, H, W, C)):
    return rs.standard_normal(shape).astype(np.float32)


def _probs(rs):
    z = _logits(rs) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _image(rs):
    return rs.rand(B, H, W, 1).astype(np.float32)


def _labels(rs):
    return rs.randint(0, C, (B, H, W)).astype(np.int32)


def _features(rs):
    f = rs.standard_normal((6, 2, 8)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


# name -> (function name, function making the arguments; the first is the one
# differentiated, kwargs)
CASES = {
    "entropy_loss": ("entropy_loss", lambda rs: [_probs(rs), C], {}),
    "entropy_minimization": ("entropy_minimization",
                             lambda rs: [_probs(rs)], {}),
    "entropy_map": ("entropy_map", lambda rs: [_probs(rs)], {}),
    "softmax_mse_loss": ("softmax_mse_loss",
                         lambda rs: [_logits(rs), _logits(rs)], {}),
    "softmax_kl_loss": ("softmax_kl_loss",
                        lambda rs: [_logits(rs), _logits(rs)], {}),
    "symmetric_mse_loss": ("symmetric_mse_loss",
                           lambda rs: [_logits(rs), _logits(rs)], {}),
    "tv_loss": ("tv_loss", lambda rs: [_probs(rs)[..., 1:]], {}),
    "maxpool3x3": ("_maxpool3x3", lambda rs: [_logits(rs)], {}),
    "mumford_shah_l1": ("mumford_shah_loss",
                        lambda rs: [_probs(rs), _image(rs)], {"swap": True}),
    "mumford_shah_l2": ("mumford_shah_loss",
                        lambda rs: [_probs(rs), _image(rs)],
                        {"swap": True, "penalty": "l2"}),
    "intensity_variance_inter": (
        "intensity_variance_losses",
        lambda rs: [_probs(rs), _image(rs), C], {"swap": True, "pick": 0}),
    "intensity_variance_intra": (
        "intensity_variance_losses",
        lambda rs: [_probs(rs), _image(rs), C], {"swap": True, "pick": 1}),
    "size_loss": ("size_loss", lambda rs: [_logits(rs) * 3, _labels(rs)],
                  {"margin": 0.3}),
    "focal_loss": ("focal_loss", lambda rs: [_logits(rs), _labels(rs)], {}),
    "focal_loss_alpha": (
        "focal_loss", lambda rs: [_logits(rs), _labels(rs)],
        {"gamma": 1.5, "alpha": [0.1, 0.2, 0.3, 0.4]}),
    "supcon_labels": (
        "supcon_loss",
        lambda rs: [_features(rs), np.array([0, 1, 0, 2, 1, 0], np.int32)],
        {}),
    "supcon_simclr_one": ("supcon_loss", lambda rs: [_features(rs)],
                          {"contrast_mode": "one", "temperature": 0.2}),
    "supcon_mask": (
        "supcon_loss",
        lambda rs: [_features(rs), None,
                    (rs.rand(6, 6) > 0.5).astype(np.float32)], {}),
}


def _call(fn, args, kw, to_array):
    kw = dict(kw)
    swap, pick = kw.pop("swap", False), kw.pop("pick", None)
    args = [to_array(a) if isinstance(a, np.ndarray) else a for a in args]
    if swap:  # the differentiated input is the function's second argument
        args[0], args[1] = args[1], args[0]
    out = fn(*args, **kw)
    return out if pick is None else out[pick]


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name):
    fn_name, build, kw = CASES[name]
    args = build(_rs())
    weights = _rs().standard_normal(64).astype(np.float32)

    def scalar(out, lib):
        # a fixed linear functional, so that map-valued losses have a
        # gradient worth comparing
        flat = out.reshape(-1)
        w = weights[np.arange(flat.shape[0]) % 64]
        return (flat * (jnp.asarray(w) if lib is jnp
                        else torch.from_numpy(w))).sum()

    x = torch.from_numpy(args[0]).requires_grad_()
    tout = _call(getattr(tl, fn_name), [x] + args[1:], kw, torch.from_numpy)
    scalar(tout, torch).backward()

    def jfn(a):
        return _call(getattr(jl, fn_name), [a] + args[1:], kw, jnp.asarray)

    jout = jfn(jnp.asarray(args[0]))
    jgrad = jax.grad(lambda a: scalar(jfn(a), jnp))(jnp.asarray(args[0]))
    for got, want in ((tout.detach().numpy(), np.asarray(jout)),
                      (x.grad.numpy(), np.asarray(jgrad))):
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=2e-5, atol=1e-6 * max(np.abs(want).max(), 1e-3))
    assert np.abs(np.asarray(jgrad)).max() > 0


def test_supcon_rejects_bad_arguments():
    f = torch.zeros((4, 2, 3))
    with pytest.raises(ValueError, match="batch, views, dim"):
        tl.supcon_loss(f[0])
    with pytest.raises(ValueError, match="not both"):
        tl.supcon_loss(f, labels=torch.zeros(4), mask=torch.eye(4))


@pytest.mark.parametrize("name,length", [
    ("sigmoid_rampup", 200.0), ("sigmoid_rampup", 0),
    ("linear_rampup", 80.0), ("linear_rampup", 0),
    ("cosine_rampdown", 300.0)])
def test_ramps_match_jax(name, length):
    for current in (0, 1, 37.5, 150, length, length + 10):
        if name == "cosine_rampdown" and current > length:
            with pytest.raises(ValueError):
                tramps.cosine_rampdown(current, length)
            continue
        assert getattr(tramps, name)(current, length) == \
            getattr(jramps, name)(current, length)


@pytest.mark.parametrize("length", [200.0, 0])
def test_sigmoid_rampup_on_int_and_tensor_steps(length):
    """The in-step ramp: an int step and a tensor of steps give the JAX
    package's f32 values (rtol 1e-6: one exp)."""
    steps = [0, 1, 7, 150, 199, 200, 4000]
    want = np.asarray(sigmoid_rampup_jnp(jnp.asarray(steps), length))
    got = sigmoid_rampup(torch.tensor(steps), length)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), want.shape),
                               want, rtol=1e-6)
    for s, w in zip(steps, np.broadcast_to(want, (len(steps),))):
        np.testing.assert_allclose(float(sigmoid_rampup(s, length)), w,
                                   rtol=1e-6)
