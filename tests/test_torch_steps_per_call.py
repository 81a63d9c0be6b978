"""``steps_per_call`` (the JAX trainer's K-step device call) and
``profile_steps`` in the port's Trainer, on the CPU (where the K steps of a
call run eagerly; on the card chip_smoke's phase 10 holds the captured
CUDA graph to the eager steps).

* Every method runs K = 2 steps a call, and all 17 can be captured on the
  card: no bundle names a host decision; ustm, s2l and scribblevc name the
  step's variant (``MethodBundle.variant``, a graph for each value), the
  others have one shape of computation.
* A K = 3 run of 6 steps is bit-equal to the K = 1 run for
  fully_supervised, dmpls, pce_gatedcrf and uamt (parameters, BN
  statistics, momenta, extras, the step and optimizer counts, and each
  call's metrics against the K = 1 run's at the same step): every step
  keeps its (seed, step) draws.
* The iterations at which the Trainer validates, checkpoints, logs and
  writes images, and its warnings, equal the JAX Trainer's over a grid of
  (K, val_every, ckpt_every), both over a stub step.
* ``profile_steps`` writes a Chrome trace of iterations 10 .. 10 + N under
  ``{snapshot}/profile`` where the JAX trainer's window opens (K dividing
  10), and none where it does not.

Narrow models (UNet features 4..16, ScribbleVC base 8, embed 32, 2 heads)
at 32x32 (ScribbleVC 64x64), f32, one torch thread.
"""

import functools
import itertools
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import wsl4mis_tpu.engine.trainer as jtrainer  # noqa: E402
import wsl4mis_torch.engine.trainer as ptrainer  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods.common import (  # noqa: E402
    MethodBundle as JaxBundle,
)
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods  # noqa: E402
from wsl4mis_torch.engine.methods.common import MethodBundle  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402

HW, SVC_HW, B = 32, 64, 4
FEATURES = (4, 8, 8, 16, 16)
SVC_WIDTHS = dict(base_channel=8, embed_dim=32, num_heads=2)
VARIANTS = {"ustm": {"rot_times"}, "s2l": {"gate"},
            "scribblevc": {"use_class_rep"}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
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


def _train(method, k, steps, root):
    """A Trainer run of `steps` steps, K = k, on the method's phantoms:
    (the bundle, the final state's leaves, each call's metrics)."""
    method, model, batch, kind = chip_smoke.dp_cell(method, B)
    hw = SVC_HW if method == "scribblevc" else HW
    cfg = TrainConfig(
        method=method, model=model, batch_size=batch, labeled_bs=batch // 2,
        max_iterations=steps, val_every=10 ** 9, ckpt_every=10 ** 9,
        compute_dtype="float32", seed=3, device="cpu", patch_size=(hw, hw),
        sup_type=chip_smoke.sup_type_of(method), snapshot_root=str(root),
        steps_per_call=k)
    data = chip_smoke.dp_data(kind, hw, 3)
    bundle, _ = chip_smoke.method_bundle(cfg, data, None)
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    trainer._snapshot_code = lambda: None
    calls = []
    call = trainer._call
    trainer._call = lambda batches, it: calls.append(call(batches, it)) \
        or calls[-1]
    trainer.train()
    assert trainer.captured is None
    assert trainer.uncaptured == ("cpu has no CUDA graph" if k > 1 else None)
    return bundle, chip_smoke.state_leaves(bundle.state), calls


@pytest.mark.parametrize("method", sorted(available_methods()))
def test_every_method_runs_k_steps_a_call(narrow, tmp_path, method):
    bundle, leaves, calls = _train(method, 2, 2, tmp_path)
    assert leaves["/step"] == 2 and len(calls) == 1
    assert np.isfinite(float(calls[0]["total_loss"]))
    assert not hasattr(bundle, "host_decision")
    if method in VARIANTS:
        assert set(bundle.variant(bundle.state, 3)) == VARIANTS[method]
    else:
        assert bundle.variant is None


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("method", ["fully_supervised", "dmpls",
                                    "pce_gatedcrf", "uamt"])
def test_k_steps_a_call_equal_single_steps(narrow, tmp_path, method):
    _, one, one_calls = _train(method, 1, 6, tmp_path / "k1")
    _, three, three_calls = _train(method, 3, 6, tmp_path / "k3")
    bad, worst = chip_smoke.leaves_diff(one, three)
    assert bad == [], (bad[:10], worst)
    assert one["/step"] == 6 and one["/opt/count"] == 6
    assert len(three_calls) == 2
    for i, m in enumerate(three_calls):  # steps 3 and 6
        assert _equal(m, one_calls[3 * i + 2]), i


# ---- cadences against the JAX Trainer ----------------------------------------


class _JaxState(NamedTuple):
    step: jnp.ndarray


def _stub_batches():
    return itertools.repeat({"index": np.zeros(2, np.int32)})


def _jax_run(root, monkeypatch, events, **kw):
    cfg = JaxConfig(snapshot_root=str(root), num_devices=1, **kw)

    def step_fn(state, batch, rng, aux):
        return _JaxState(state.step + 1), {"total_loss": jnp.zeros(())}

    bundle = JaxBundle(model=None, state=_JaxState(jnp.zeros((), jnp.int32)),
                       step_fn=step_fn, data_iter=_stub_batches(),
                       val_volumes=None, steps_per_epoch=1,
                       predictor=object())
    _record(jtrainer, monkeypatch, events)
    jtrainer.Trainer(cfg, bundle, use_tensorboard=False).train()


def _port_run(root, monkeypatch, events, **kw):
    cfg = TrainConfig(snapshot_root=str(root), device="cpu", **kw)
    model = torch.nn.Linear(1, 1)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), 0.01, cfg.max_iterations))

    def step_fn(state, batch, rngs, aux=None):
        loss = model(torch.ones(1)).sum()
        state.minimize(loss)
        return {"total_loss": loss.detach()}

    bundle = MethodBundle(model=model, state=state, step_fn=step_fn,
                          data_iter=_stub_batches(), val_volumes=None,
                          steps_per_epoch=1)
    _record(ptrainer, monkeypatch, events)
    ptrainer.Trainer(cfg, bundle, use_tensorboard=False).train()


def _record(mod, monkeypatch, events):
    """Record the Trainer's validations, checkpoints, logged LRs and image
    writes in `events`."""
    cls = mod.Trainer
    monkeypatch.setattr(cls, "_snapshot_code", lambda self: None)
    monkeypatch.setattr(cls, "validate", lambda self, it: events.setdefault(
        "val", []).append(it) or (0.0, 0.0))
    monkeypatch.setattr(cls, "_images", lambda self, vis, it: events
                        .setdefault("image", []).append(it))
    monkeypatch.setattr(cls, "_scalar", lambda self, tag, v, it: events
                        .setdefault("log", []).append(it)
                        if tag == "info/lr" else None)
    monkeypatch.setattr(mod, "save_model_checkpoint", lambda path, *a, **k:
                        events.setdefault("ckpt", []).append(
                            os.path.basename(path)))
    monkeypatch.setattr(mod, "save_train_state", lambda *a, **k: None)


def _warnings(root):
    path = next(os.path.join(d, "log.txt") for d, _, files in os.walk(root)
                if "log.txt" in files)
    with open(path) as f:
        return [line.split("] ", 1)[1] for line in f
            if "does not divide" in line]


@pytest.mark.parametrize("val_every,ckpt_every", [(4, 6), (5, 8), (6, 3)])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_cadences_equal_the_jax_trainers(tmp_path, monkeypatch, k, val_every,
                                         ckpt_every):
    kw = dict(max_iterations=25, val_every=val_every, ckpt_every=ckpt_every,
              steps_per_call=k)
    want, got = {}, {}
    _jax_run(tmp_path / "jax", monkeypatch, want, **kw)
    _port_run(tmp_path / "port", monkeypatch, got, **kw)
    assert got == want
    assert want["log"][-1] == 25 + (-25) % k
    assert _warnings(tmp_path / "port") == _warnings(tmp_path / "jax")
    assert bool(_warnings(tmp_path / "port")) == bool(val_every % k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_profile_steps_writes_a_trace(tmp_path, monkeypatch, k):
    _port_run(tmp_path, monkeypatch, {}, max_iterations=14,
              profile_steps=2, steps_per_call=k)
    path = os.path.join(TrainConfig(snapshot_root=str(tmp_path))
                        .snapshot_path, "profile", "trace.json")
    if k == 3:  # the window opens at a call's start at iteration 10 only
        assert not os.path.exists(path)
        return
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::linear"
               for e in trace["traceEvents"])
