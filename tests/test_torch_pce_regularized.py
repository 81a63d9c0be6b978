"""Three train steps of each pCE + regularizer method (pce_tv,
pce_entropy_mini, pce_gatedcrf, pce_mumford_shah, pce_intensity_variance)
in both packages, from the same parameters and scribble batches (on the
CPU, f32): every metric of every step and the parameters after the first
and third step must agree. Augmentation is off on both sides
(aug_mode="host") and ConvBlock dropout is 0, since JAX and torch random
streams cannot match. On the CPU the JAX step takes the GatedCRF scan; the
port takes its Function over the plain contraction.

Tolerance: as tests/test_torch_train_step.py, for the reasons given there
(losses rtol 1e-5; parameters atol 1e-5 / rtol 1e-4 after one update, atol
2e-4 / rtol 1e-3 after three). loss_reg of pce_intensity_variance is a
difference of two statistics of similar size, so its absolute tolerance is
1e-6, a few f32 ulps of either.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods import get_method as jax_method  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods, get_method  # noqa: E402
from wsl4mis_torch.engine.methods import pce_regularized  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
STEPS = 3
B, HW = 2, 32


def _batches():
    rs = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
        images = (labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1)
        labels = np.where(rs.rand(B, HW, HW) < 0.2, labels, 4)
        out.append({"image": images.astype(np.float32),
                    "label": labels.astype(np.int32)})
    return out


def test_the_five_methods_are_registered():
    assert set(pce_regularized.METHODS) <= set(available_methods())
    for name in pce_regularized.METHODS:
        assert get_method(name) is pce_regularized
    with pytest.raises(ValueError, match="unhandled method"):
        pce_regularized.make_step(TrainConfig(method="pce"))
    cfg = TrainConfig()
    jcfg = JaxConfig()
    assert (cfg.consistency, cfg.consistency_rampup) == (
        jcfg.consistency, jcfg.consistency_rampup)


@pytest.mark.parametrize("method", pce_regularized.METHODS)
def test_three_steps_match(method):
    common = dict(method=method, batch_size=B, patch_size=(HW, HW),
                  max_iterations=100, compute_dtype="float32",
                  aug_mode="host", sup_type="scribble", consistency=0.7,
                  consistency_rampup=3.0)
    batches = _batches()

    jcfg = JaxConfig(**common)
    jmodel = junet.UNet(features=FEATURES, dropout=NO_DROPOUT,
                        dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jmodel.init({"params": key, "dropout": key,
                             "feature_perturb": key},
                            jnp.zeros((1, HW, HW, 1)), train=False)
    jstate = JaxState.create(apply_fn=jmodel.apply,
                             params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             tx=reference_sgd(jcfg.base_lr,
                                              jcfg.max_iterations))
    jstep = jax.jit(jax_method(method).make_step(jcfg))

    cfg = TrainConfig(device="cpu", **common)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations))
    step = get_method(method).make_step(cfg)
    if method == "pce_intensity_variance":
        # past the ramp's start (step // 150 = 1 of 3), so that the weight
        # is the ramp's and not its floor
        jstate = jstate.replace(step=jnp.asarray(150, jstate.step.dtype))
        state.step = 150

    def check_params(rtol, atol):
        want = from_flax(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
        got = model.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)

    for t, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.key(100 + t))
        tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  split_rngs(0, t, "cpu"))
        assert set(tm) == set(jm) == {"total_loss", "loss_ce", "loss_reg",
                                      "vis"}
        for k in ("total_loss", "loss_ce", "loss_reg"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {t}")
        assert float(tm["loss_reg"]) != 0.0
        if t == 0:
            check_params(rtol=1e-4, atol=1e-5)
    assert state.step == int(jstate.step)
    check_params(rtol=1e-3, atol=2e-4)
