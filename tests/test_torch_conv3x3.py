"""Parity of the port's conv3x3 / conv3x3_stats (plain versions, on the
CPU) with the JAX package's banded Pallas conv in interpret mode: forward,
BN moments and the VJP (dx, dK, db, and the moment-cotangent fold).

Tolerance: f32 atol = rtol = 1e-4 as tests/test_banded_pallas.py uses,
with atol scaled by the largest reference magnitude for the reductions
(moments, dK, db), which sum thousands of terms in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wsl4mis_tpu.ops.pallas.banded_conv_pallas import (  # noqa: E402
    banded_conv3x3_pallas,
    banded_conv3x3_pallas_stats,
)
from wsl4mis_torch.ops import conv3x3 as tconv  # noqa: E402
from wsl4mis_torch.utils.device import resolve_device  # noqa: E402

# (C, O, H, W): a subset of test_banded_pallas.SHAPES plus the head (O=4):
# the stem (C=1), the head's dgrad family (C=4), a right-pad width.
SHAPES = [
    (1, 16, 8, 256),
    (4, 16, 8, 256),
    (16, 4, 8, 32),
    (32, 16, 8, 250),
]


def _inputs(c, o, h, w, seed=0):
    rs = np.random.RandomState(seed + c * 1000 + o + h + w)
    x = rs.standard_normal((2, h, w, c)).astype(np.float32)
    k = (rs.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    b = rs.standard_normal((o,)).astype(np.float32)
    gy = rs.standard_normal((2, h, w, o)).astype(np.float32)
    gs1 = rs.standard_normal((o,)).astype(np.float32)
    gs2 = (rs.standard_normal((o,)) * 0.1).astype(np.float32)
    return x, k, b, gy, gs1, gs2


def _close(got, want, rtol=1e-4, atol=1e-4, scaled=False):
    got, want = np.asarray(got), np.asarray(want)
    if scaled:
        atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


@pytest.mark.parametrize("c,o,h,w", SHAPES)
def test_forward_and_moments_match_pallas(c, o, h, w):
    x, k, b, *_ = _inputs(c, o, h, w)
    want = banded_conv3x3_pallas(x, k, b, interpret=True)
    _close(tconv.conv3x3(_t(x), _t(k), _t(b)).detach(), want)
    wy, ws1, ws2 = banded_conv3x3_pallas_stats(x, k, b, interpret=True)
    y, s1, s2 = tconv.conv3x3_stats(_t(x), _t(k), _t(b))
    _close(y.detach(), wy)
    _close(s1.detach(), ws1, scaled=True)
    _close(s2.detach(), ws2, scaled=True)


@pytest.mark.parametrize("c,o,h,w", SHAPES)
def test_stats_vjp_matches_pallas(c, o, h, w):
    """dx, dK, db of (y, s1, s2) under cotangents (gy, gs1, gs2): covers
    the dgrad through the forward kernel, the wgrad and the fold."""
    x, k, b, gy, gs1, gs2 = _inputs(c, o, h, w)
    _, vjp = jax.vjp(
        lambda x, k, b: banded_conv3x3_pallas_stats(x, k, b, interpret=True),
        x, k, b)
    wdx, wdk, wdb = vjp((gy, gs1, gs2))
    xt, kt, bt = _t(x, True), _t(k, True), _t(b, True)
    outs = tconv.conv3x3_stats(xt, kt, bt)
    dx, dk, db = torch.autograd.grad(outs, (xt, kt, bt),
                                     (_t(gy), _t(gs1), _t(gs2)))
    _close(dx, wdx)
    _close(dk, wdk, scaled=True)
    _close(db, wdb, scaled=True)


def test_plain_vjp_matches_pallas_without_stats():
    c, o, h, w = 16, 4, 8, 32
    x, k, b, gy, *_ = _inputs(c, o, h, w, seed=1)
    _, vjp = jax.vjp(
        lambda x, k, b: banded_conv3x3_pallas(x, k, b, interpret=True),
        x, k, b)
    wdx, wdk, wdb = vjp(jnp.asarray(gy))
    xt, kt, bt = _t(x, True), _t(k, True), _t(b, True)
    dx, dk, db = torch.autograd.grad(tconv.conv3x3(xt, kt, bt), (xt, kt, bt),
                                     _t(gy))
    _close(dx, wdx)
    _close(dk, wdk, scaled=True)
    _close(db, wdb, scaled=True)


def test_stem_skips_the_input_gradient(monkeypatch):
    """With x not requiring a gradient (the stem), the backward runs no
    dgrad conv: only the wgrad and the bias reduction."""
    x, k, b, gy, *_ = _inputs(1, 16, 8, 256)
    calls = []
    real = tconv.conv3x3_fwd
    monkeypatch.setattr(tconv, "conv3x3_fwd",
                        lambda *a: calls.append(1) or real(*a))
    kt, bt = _t(k, True), _t(b, True)
    y = tconv.conv3x3(_t(x), kt, bt)
    calls.clear()
    dk, db = torch.autograd.grad(y, (kt, bt), _t(gy))
    assert calls == [] and dk.shape == (3, 3, 1, 16) and db.shape == (16,)


def test_bfloat16_forward_within_two_ulps():
    """bf16 in and out: both round one f32 accumulation once, so they agree
    within 2 bf16 ulps of the reference (ulp floored at 2^-8 of the
    largest magnitude, for sums that cancel to near zero)."""
    x, k, b, *_ = _inputs(16, 16, 8, 32, seed=2)
    want = np.asarray(banded_conv3x3_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), interpret=True).astype(jnp.float32))
    got = tconv.conv3x3(_t(x).bfloat16(), _t(k).bfloat16(),
                        _t(b).bfloat16()).float().numpy()
    mag = np.maximum(np.abs(want), np.abs(want).max() * 2.0 ** -8)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= 2 * ulp)


def test_wrappers_take_the_plain_version_on_cpu_only():
    x, k, b, gy, *_ = _inputs(4, 16, 8, 256)
    before = dict(tconv.launches)
    y = tconv.conv3x3_fwd(_t(x), _t(k), _t(b))
    torch.testing.assert_close(y, tconv.conv3x3_plain(_t(x), _t(k), _t(b)))
    torch.testing.assert_close(tconv.conv3x3_wgrad(_t(x), _t(gy)),
                               tconv.conv3x3_wgrad_plain(_t(x), _t(gy)))
    assert tconv.launches == before  # no kernel launched on the CPU
    with pytest.raises(RuntimeError, match="no conv3x3 implementation"):
        tconv.conv3x3_fwd(_t(x).to("meta"), _t(k).to("meta"))


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
