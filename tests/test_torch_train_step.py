"""Three train steps of fully_supervised, pce and dmpls in both packages,
from the same parameters and batches (on the CPU, f32): losses per step
and parameters after the third step must agree.

Augmentation is off on both sides (aug_mode="host": the batches arrive
as they are), ConvBlock dropout is 0, and DMPLS's beta and its
channel-dropout masks are injected, since JAX and torch random streams
cannot match.

Tolerance: losses rtol 1e-5 at every step. Parameters after the first
update atol 1e-5, rtol 1e-4; after the third atol 2e-4, rtol 1e-3. Both
packages take the BN variance in one pass (E[y^2] - E[y]^2), whose
gradient cancels terms of size mean^2 against ones of size var; summed in
different f32 orders, single weight gradients then differ by up to ~1e-3
of their scale, i.e. ~3e-6 after one update at lr 0.03, and each step's
differences feed the next step's forward (measured: up to 1.3e-4 on one
weight after three). A wrong formula moves parameters by O(lr * grad),
~1e-3, which these bounds still catch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods import get_method as jax_method  # noqa: E402
from wsl4mis_tpu.engine.methods.common import split_rngs as jax_split  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import from_flax, load_flax_variables  # noqa: E402

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
STEPS = 3
B, HW = 2, 64


def _batches(sup):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
        if sup == "scribble":
            labels = np.where(rs.rand(B, HW, HW) < 0.2, labels, 4)
        images = (labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1)
        out.append({"image": images.astype(np.float32),
                    "label": labels.astype(np.int32)})
    return out


@pytest.mark.parametrize("method", ["fully_supervised", "pce", "dmpls"])
def test_three_steps_match(method, monkeypatch):
    model_name = "unet_cct" if method == "dmpls" else "unet"
    sup = "label" if method == "fully_supervised" else "scribble"
    common = dict(method=method, batch_size=B, patch_size=(HW, HW),
                  max_iterations=100, compute_dtype="float32",
                  aug_mode="host", sup_type=sup)
    batches = _batches(sup)
    masks = [np.random.RandomState(9).rand(B, 1, 1, c) < 0.5
             for c in FEATURES]

    calls = []

    def fixed_channel_dropout(rng, x, rate=0.5):
        # UNetCCT calls this once per encoder feature, in order
        keep = jnp.asarray(masks[len(calls) % len(masks)])
        calls.append(x.shape)
        return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

    monkeypatch.setattr(junet, "channel_dropout", fixed_channel_dropout)

    # JAX reference
    jcfg = JaxConfig(**common)
    jmodel = {"unet": junet.UNet, "unet_cct": junet.UNetCCT}[model_name](
        features=FEATURES, dropout=NO_DROPOUT, dtype=jnp.float32)
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

    # port
    cfg = TrainConfig(device="cpu", **common)
    model = net_factory(model_name, 4, dtype=torch.float32,
                        features=FEATURES, dropout=NO_DROPOUT)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations))
    step = get_method(method).make_step(cfg)

    def check_params(rtol, atol):
        want = from_flax(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
        got = model.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)

    for t, batch in enumerate(batches):
        rng = jax.random.key(100 + t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, rng)
        kwargs = {}
        if method == "dmpls":
            beta = float(jax.random.uniform(jax_split(rng)["method"])
                         + 1e-10)
            kwargs = {"beta": beta, "channel_masks": [
                torch.from_numpy(m) for m in masks]}
        tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  split_rngs(0, t, "cpu"), **kwargs)
        for k in tm:
            if k != "vis":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, atol=1e-6)
        if t == 0:
            check_params(rtol=1e-4, atol=1e-5)
    assert state.step == int(jstate.step) == STEPS
    check_params(rtol=1e-3, atol=2e-4)
