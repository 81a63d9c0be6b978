"""The port's 2x2 max pool (wsl4mis_torch/ops/maxpool.py) on the CPU, where
the wrapper runs its plain version: forward and dx must be bit-equal to the
JAX package's Pallas kernel in interpret mode and to its jax.grad, ties
included (inputs drawn from a few levels) in f32 and bf16. Tolerance: none,
the comparison is exact. Inputs come from a numpy seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wsl4mis_tpu.ops.pallas.maxpool_pallas import max_pool_2x2_pallas  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.ops import maxpool as tpool  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, ties, seed=0):
    """x and g as f32 numpy arrays holding values exact in `dtype`."""
    rs = np.random.RandomState(seed)
    n, h, w, c = shape
    if ties:  # five levels, zeros among them: most windows tie
        x = rs.randint(-2, 3, shape).astype(np.float32) * 0.5
    else:
        x = rs.standard_normal(shape).astype(np.float32)
    g = rs.standard_normal((n, h // 2, w // 2, c)).astype(np.float32)

    def rounded(a):
        return torch.from_numpy(a).to(TORCH_DT[dtype]).float().numpy()

    return rounded(x), rounded(g)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (3, 16, 12, 5),
                                   (1, 32, 32, 16)])
def test_forward_and_dx_bit_equal_to_pallas(shape, dtype, ties):
    x, g = _inputs(shape, dtype, ties)
    jx = jnp.asarray(x, dtype=dtype)
    jy, vjp = jax.vjp(lambda a: max_pool_2x2_pallas(a, interpret=True), jx)
    (jdx,) = vjp(jnp.asarray(g, dtype=dtype))

    tx = torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_()
    ty = tpool.max_pool_2x2(tx)
    ty.backward(torch.from_numpy(g).to(TORCH_DT[dtype]))
    assert ty.dtype == tx.grad.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))
    if ties:  # the case is only a tie test if windows do tie
        taps = np.stack([x[:, a::2, b::2] for a in (0, 1) for b in (0, 1)])
        assert ((taps == taps.max(0)).sum(0) > 1).mean() > 0.3


def test_plain_function_is_the_cpu_route():
    """max_pool_2x2_plain (the differentiable plain version) and the
    dispatching max_pool_2x2 agree bit for bit on the CPU."""
    x, g = _inputs((2, 6, 10, 4), "float32", True, seed=3)
    outs = []
    for fn in (tpool.max_pool_2x2, tpool.max_pool_2x2_plain):
        tx = torch.from_numpy(x).requires_grad_()
        y = fn(tx)
        y.backward(torch.from_numpy(g))
        outs.append((y.detach(), tx.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_all_tied_window_sends_g_to_the_first_tap():
    x = torch.zeros((1, 4, 4, 1), requires_grad=True)
    tpool.max_pool_2x2(x).sum().backward()
    assert float(x.grad[0, 0, 0, 0]) == 1.0
    assert float(x.grad.sum()) == 4.0
    assert torch.equal(x.grad[0, ::2, ::2], torch.ones((2, 2, 1)))


def test_nan_window():
    """A NaN tap makes y NaN; dx goes to tap (1,1) of that window (no tap
    equals a NaN max) and every other window is untouched."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1).clone()
    x[0, 0, 1, 0] = float("nan")
    x.requires_grad_()
    y = tpool.max_pool_2x2(x)
    assert torch.isnan(y[0, 0, 0, 0]) and not torch.isnan(y).sum() > 1
    y.backward(torch.ones_like(y))
    want = torch.zeros((4, 4))
    want[1, 1] = want[1, 3] = want[3, 1] = want[3, 3] = 1.0
    assert torch.equal(x.grad[0, :, :, 0], want)


@pytest.mark.parametrize("shape", [(1, 5, 4, 2), (1, 4, 3, 2), (4, 4, 2)])
def test_odd_or_wrong_rank_raises(shape):
    with pytest.raises(ValueError, match="even H and W"):
        tpool.max_pool_2x2(torch.zeros(shape))


def test_kernel_wrapper_checks_before_it_launches():
    """The CUDA wrappers validate in Python first: these raise on the CPU
    without a build."""
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(TypeError, match="dtype"):
        tpool._fwd_kernel(x.double())
    with pytest.raises(ValueError, match="pooled shape"):
        tpool._bwd_kernel(x, torch.zeros((1, 2, 2, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        tpool._fwd_kernel(torch.zeros((1, 4, 2, 4)).transpose(2, 3))
    with pytest.raises(RuntimeError, match="no max_pool_2x2 implementation"):
        tpool.max_pool_2x2_fwd(torch.zeros((1, 4, 4, 2), device="meta"))
    assert tpool.launches == {"maxpool_fwd": 0, "maxpool_bwd": 0}


def test_unet_encoder_pools_through_ops_maxpool(monkeypatch):
    """Every encoder level but the first pools its NHWC input through
    ops.maxpool, forward and backward."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = tpool.max_pool_2x2_fwd, tpool.max_pool_2x2_bwd
    monkeypatch.setattr(tpool, "max_pool_2x2_fwd",
                        lambda x: seen["fwd"].append(tuple(x.shape)) or fwd(x))
    monkeypatch.setattr(
        tpool, "max_pool_2x2_bwd",
        lambda x, g: seen["bwd"].append(tuple(x.shape)) or bwd(x, g))
    model = net_factory("unet", 4, dtype=torch.float32,
                        features=(4, 8, 8, 16, 16), dropout=(0.0,) * 5)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 32, 32, 1)).astype(np.float32))
    model(x, train=True).sum().backward()
    shapes = [(2, 32, 32, 4), (2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 16)]
    assert seen["fwd"] == shapes
    assert seen["bwd"] == shapes[::-1]
