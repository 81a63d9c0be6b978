"""Resuming a JAX run in the port, and the port's state in the JAX layout
(on the CPU, f32, small planes).

For each of the five layouts of the JAX package's ``latest_full.ckpt``
(SGD alone: fully_supervised; SGD + ema_params: uamt; SGD + disc_params +
disc_opt_state: deep_adversarial; SGD + weight: s2l; AdamW +
class_memory: scribblevc), the JAX method takes 2 steps and writes its
file with ``save_train_state``. The port restores it (through
``restore_train_state``, which must tell the format) into a state whose
every tensor was first set to NaN, and every leaf must be bit-equal:
parameters, BN statistics, optimizer state, step and extras. Then each
package takes one more step from its state, on the same batches and
injected draws, and they must agree at the tolerances of that layout's
step test:

- fully_supervised: tests/test_torch_train_step.py::test_three_steps_match,
  losses rtol 1e-5 (atol 1e-6), parameters after one update rtol 1e-4,
  atol 1e-5;
- uamt, deep_adversarial, s2l: tests/test_torch_semi.py,
  tests/test_torch_deep_adversarial.py and tests/test_torch_s2l.py's
  test_three_steps_match, losses rtol 1e-5 (atol 1e-6), parameters, BN
  statistics and EMA parameters rtol 1e-3, atol 2e-4; DAN's
  discriminator atol 5e-6 and its Adam moments 1e-5 of their largest;
  s2l's buffer exactly;
- scribblevc: tests/test_torch_scribblevc.py::test_three_steps_match,
  losses LOSS_RTOL 1e-4, the step's gradient (from the Adam moments)
  GRAD_TOL 1e-2 in norm, the update UPDATE_TOL 3e-2, BN statistics rtol
  1e-3, atol 2e-4, the class memory TRAIN_TOL 1e-3 of its largest.

Written back at once with ``save_jax_train_state``, the restored state
gives the JAX package's file byte for byte. Last, the port writes its
state after the step, and the JAX package's ``restore_train_state`` loads
it into its own state as a template: every leaf bit-equal to the port's,
of the template's dtype and shape. s2l's run lowers flax's chunk threshold (and the port's) so that
its buffer is written and read as a chunk dict of 32 pieces.

Also: chunked leaves both ways against flax itself, bytes included; the
flax path of every model a train state can hold, inverted; a JAX
Trainer's latest_full.ckpt resumed by the port's Trainer in the same
snapshot_path; and a checkpoint of another method, optimizer or model
raising with the key named.
"""

import functools
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

import test_torch_deep_adversarial as tdan  # noqa: E402
import test_torch_s2l as ts2l  # noqa: E402
import test_torch_scribblevc as tsvc  # noqa: E402
import test_torch_semi as tsemi  # noqa: E402
import test_torch_train_step as tstep  # noqa: E402
import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.deep_adversarial as jdan  # noqa: E402
import wsl4mis_tpu.engine.methods.s2l as js2l  # noqa: E402
import wsl4mis_tpu.engine.methods.scribblevc as jsvc  # noqa: E402
import wsl4mis_tpu.models.discriminator as jdisc  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
import wsl4mis_torch.engine.methods.common as tcommon  # noqa: E402
import wsl4mis_torch.utils.checkpoint as tck  # noqa: E402
from test_torch_scribblevc import jax_model  # noqa: E402,F401 (fixture)
from test_torch_trainer import acdc_tree  # noqa: E402,F401 (fixture)
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods import get_method as jax_method  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_tpu.engine.trainer import Trainer as JaxTrainer  # noqa: E402
from wsl4mis_tpu.models.factory import net_factory as jax_factory  # noqa: E402
from wsl4mis_tpu.utils import checkpoint as jck  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import deep_adversarial, get_method  # noqa: E402
from wsl4mis_torch.engine.methods import s2l as ts2l_method  # noqa: E402
from wsl4mis_torch.engine.methods import scribblevc as tsvc_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceAdamW, ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.models.discriminator import FCDiscriminator  # noqa: E402
from wsl4mis_torch.ops import augment as taug  # noqa: E402
from wsl4mis_torch.utils.params import (  # noqa: E402
    flax_naming,
    from_flax,
    named_from_flax,
)

FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
LAYOUTS = ("fully_supervised", "uamt", "deep_adversarial", "s2l",
           "scribblevc")
S2L_CHUNK = 4096  # bytes: s2l's (8, 32, 32, 4) f32 buffer in 32 pieces


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclass
class Run:
    """A layout's JAX state and step ((jstate, t) -> (jstate, metrics)),
    the port's state and step (t -> metrics) on the same batches and
    draws, and how the step after the resume is compared."""

    jstate: object
    jstep: Callable
    state: TrainState
    step: Callable
    compare: Callable  # (state, jstate, port metrics, JAX metrics, before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree, key) -> dict:
    return named_from_flax(_np_tree(tree), key)


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_losses(tm, jm, rtol=1e-5, atol=1e-6):
    assert set(tm) == set(jm)
    for k in tm:
        if k != "vis":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                       atol=atol, err_msg=k)


def _close_model(state, jstate, rtol, atol):
    want = from_flax(_np_tree({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}),
                     flax_naming(state.model).key)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _unet_compare(rtol, atol, ema=False):
    def compare(state, jstate, tm, jm, before):
        _close_losses(tm, jm)
        _close_model(state, jstate, rtol, atol)
        if ema:
            want = _named(jstate.extra["ema_params"],
                          flax_naming(state.model).key)
            for k, v in want.items():
                np.testing.assert_allclose(
                    state.extra["ema_params"][k].numpy(), v.numpy(),
                    rtol=rtol, atol=atol, err_msg=k)
    return compare


# ---- the five layouts -------------------------------------------------------


def _fully_supervised(monkeypatch):
    b, hw = tstep.B, tstep.HW
    common = dict(method="fully_supervised", batch_size=b,
                  patch_size=(hw, hw), max_iterations=100,
                  compute_dtype="float32", aug_mode="host", sup_type="label")
    jmodel = junet.UNet(features=FEATURES, dropout=NO_DROPOUT,
                        dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jmodel.init({"params": key, "dropout": key},
                            jnp.zeros((1, hw, hw, 1)), train=False)
    jcfg = JaxConfig(**common)
    jstate = JaxState.create(apply_fn=jmodel.apply,
                             params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             tx=reference_sgd(jcfg.base_lr,
                                              jcfg.max_iterations))
    jstep = jax.jit(jax_method("fully_supervised").make_step(jcfg))
    cfg = TrainConfig(device="cpu", **common)
    model = net_factory("unet", 4, dtype=torch.float32, features=FEATURES,
                        dropout=NO_DROPOUT)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations))
    step = get_method("fully_supervised").make_step(cfg)
    batches = tstep._batches("label")
    return Run(
        jstate, lambda js, t: jstep(js, _jnp(batches[t]),
                                    jax.random.key(100 + t)),
        state, lambda t: step(state, _torch(batches[t]),
                              split_rngs(0, t, "cpu")),
        _unet_compare(rtol=1e-4, atol=1e-5))


def _uamt(monkeypatch):
    (jstate, jstep), (state, step), draws, batches = tsemi._jax_and_port(
        "uamt", monkeypatch)

    def port_step(t):
        d = draws[t]
        return step(state, _torch(batches[t]), split_rngs(0, t, "cpu"),
                    noise=torch.from_numpy(d["noise"]),
                    mc_noise=[torch.from_numpy(n) for n in d["mc"]])

    return Run(jstate, lambda js, t: jstep(js, _jnp(batches[t]),
                                           draws[t]["rng"]),
               state, port_step, _unet_compare(1e-3, 2e-4, ema=True))


def _deep_adversarial(monkeypatch):
    b, lbs, hw = tdan.B, tdan.LBS, tdan.HW
    common = dict(method="deep_adversarial", batch_size=b, labeled_bs=lbs,
                  patch_size=(hw, hw), max_iterations=100,
                  compute_dtype="float32", sup_type="label")
    jd, dparams = tdan._flax_disc(hw, seed=1)
    rs = np.random.RandomState(9)
    masks = [[rs.rand(b, 1, 1, c) < 0.5 for c in (128, 256)]
             for _ in range(tdan.STEPS)]
    tables = {128: tsemi.KeyedDraws(), 256: tsemi.KeyedDraws()}
    for t in range(tdan.STEPS):
        keys = tdan._disc_dropout_keys(jd, dparams, jax.random.key(100 + t))
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
                            jnp.zeros((1, hw, hw, 1)), train=False)
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
    disc = FCDiscriminator(4, (hw, hw), dtype=torch.float32)
    state = TrainState(model=model, opt=ReferenceSGD(
        model.parameters(), cfg.base_lr, cfg.max_iterations),
        extra=deep_adversarial.discriminator_extra(disc))
    step = deep_adversarial.make_step(cfg, disc)
    batches = tdan._batches()

    def compare(state, jstate, tm, jm, before):
        _close_losses(tm, jm)
        _close_model(state, jstate, 1e-3, 2e-4)
        adam = jstate.extra["disc_opt_state"][0]
        assert state.extra["disc_opt_state"]["count"] == int(adam.count)
        for name, tree, atol in (("disc_params",
                                  jstate.extra["disc_params"], 5e-6),
                                 ("mu", adam.mu, 1e-5), ("nu", adam.nu, 1e-5)):
            ours = (state.extra[name] if name == "disc_params"
                    else state.extra["disc_opt_state"][name])
            for k, v in _named(tree, None).items():
                scale = 1.0 if name == "disc_params" else float(
                    v.abs().max())
                np.testing.assert_allclose(ours[k].numpy(), v.numpy(),
                                           rtol=0, atol=atol * scale,
                                           err_msg=f"{name} {k}")
        for k, p in disc.named_parameters():  # the module computes with them
            assert p.data_ptr() == state.extra["disc_params"][k].data_ptr()

    return Run(
        jstate, lambda js, t: jstep(js, _jnp(batches[t]),
                                    jax.random.key(100 + t)),
        state, lambda t: step(state, _torch(batches[t]),
                              split_rngs(0, t, "cpu"),
                              channel_masks=[torch.from_numpy(m)
                                             for m in masks[t]]),
        compare)


def _s2l(monkeypatch):
    n, hw = 8, ts2l.HW
    images, scribbles, _ = ts2l._maps(n, hw, seed=2)
    weight = ts2l._buffer(n, seed=3)
    cfg_kw = dict(method="s2l", batch_size=ts2l.B, patch_size=(hw, hw),
                  max_iterations=100, compute_dtype="float32",
                  sup_type="scribble", thr_iter=1, thr_conf=ts2l.THR_CONF)
    (jcfg, jstate), (cfg, state) = ts2l._states(cfg_kw, weight)
    monkeypatch.setattr(js2l, "augment_batch_s2l", ts2l._fixed_jax_augment)
    jstep = jax.jit(js2l.make_step(jcfg))
    policy = torch.tensor(ts2l.STEP_POLICY, dtype=torch.int32)
    monkeypatch.setattr(ts2l_method, "augment_batch_s2l",
                        lambda gen, *maps: taug.augment_batch_s2l(*maps,
                                                                  policy))
    step = ts2l_method.make_step(cfg)
    aux = {"images": torch.from_numpy(images),
           "labels": torch.from_numpy(scribbles.astype(np.uint8))}
    index = [np.asarray(i, np.int32) for i in ts2l.STEP_INDEX]

    def jax_step(js, t):
        idx = index[t]
        return jstep(js, {"image": jnp.asarray(images[idx]),
                          "label": jnp.asarray(scribbles[idx]),
                          "index": jnp.asarray(idx)},
                     jax.random.key(100 + t))

    def compare(state, jstate, tm, jm, before):
        _close_losses(tm, jm)
        _close_model(state, jstate, 1e-3, 2e-4)
        np.testing.assert_array_equal(state.extra["weight"].numpy(), weight)

    return Run(jstate, jax_step, state,
               lambda t: step(state, {"index": index[t]},
                              split_rngs(0, t, "cpu"), aux), compare)


def _scribblevc(monkeypatch, jax_model):
    """test_torch_scribblevc's step at state.step 4, 5 and 6 (one step an
    epoch): the resume is at 6, the class memory's EMA branch."""
    jm, shapes = jax_model
    variables, model, memory = tsvc._variables(shapes, 6, random_stats=False)
    draws = tsvc.KeyedDraws()
    betas = (0.3, 0.8, 0.55)
    rngs_j = [jax.random.key(40 + t) for t in range(3)]
    for rng, beta in zip(rngs_j, betas):
        draws.add(jcommon.split_rngs(rng)["method"], beta - 1e-10)
    monkeypatch.setattr(jcommon, "_augment_impl",
                        lambda: (lambda rng, images, labels: (images, labels)))
    monkeypatch.setattr(tcommon, "augment_batch",
                        lambda gen, images, labels: (images, labels))
    monkeypatch.setattr(jsvc.jax.random, "uniform", draws)
    common = dict(method="scribblevc", batch_size=tsvc.B,
                  patch_size=(tsvc.HW, tsvc.HW), sup_type="scribble",
                  compute_dtype="float32")
    jstate = JaxState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray,
                                               variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        tx=optax.adamw(5e-4, eps=1e-8, weight_decay=5e-4),
        extra={"class_memory": jax.tree.map(jnp.asarray,
                                            variables["class_memory"])},
    ).replace(step=jnp.int32(4))
    jstep = jax.jit(jsvc.make_step(JaxConfig(**common), jm, 1))
    state = TrainState(model=model, opt=ReferenceAdamW(model.parameters()),
                       step=4, extra={"class_memory": memory})
    step = tsvc_method.make_step(TrainConfig(device="cpu", **common), 1)
    batches = tsvc._batches()
    names = [k for k, _ in model.named_parameters()]

    def compare(state, jstate, tm, jm_, before):
        for k in ("total_loss", "loss_ce", "loss_pseudo", "loss_crf",
                  "loss_cls"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=tsvc.LOSS_RTOL, atol=1e-6,
                                       err_msg=k)
        mu_prev, nu_prev, p_prev = before
        adam = jstate.opt_state[0]
        g_j, _ = tsvc._step_grads(tsvc._flat(adam.mu), tsvc._flat(adam.nu),
                                  mu_prev, nu_prev)
        g_t, _ = tsvc._step_grads(
            {k: m.numpy() for k, m in zip(names, state.opt.mu)},
            {k: m.numpy() for k, m in zip(names, state.opt.nu)},
            mu_prev, nu_prev)
        assert tsvc._norm_rel(g_t, g_j) <= tsvc.GRAD_TOL
        want = {k: v.numpy() for k, v in from_flax(_np_tree({
            "params": jstate.params, "batch_stats": jstate.batch_stats}),
            model.flax_key).items()}
        got = {k: v.numpy() for k, v in model.state_dict().items()}
        dp_j = {k: np.float64(want[k]) - p_prev[k] for k in names}
        dp_t = {k: np.float64(got[k]) - p_prev[k] for k in names}
        assert tsvc._norm_rel(dp_t, dp_j) <= tsvc.UPDATE_TOL
        for k in got:
            if k not in names:  # BN running statistics
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                           atol=2e-4, err_msg=k)
        for k, v in memory.items():
            assert tsvc._rel(v.numpy(), np.asarray(
                jstate.extra["class_memory"][k])) <= tsvc.TRAIN_TOL, k

    return Run(jstate, lambda js, t: jstep(js, _jnp(batches[t]), rngs_j[t]),
               state, lambda t: step(state, _torch(batches[t]),
                                     split_rngs(0, t, "cpu"),
                                     beta=torch.tensor(betas[t])),
               compare)


# ---- bit-equality -----------------------------------------------------------


def _state_tensors(state) -> list:
    """Every float tensor of a port state: the model's, the optimizer's,
    the extras'."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    opt = state.opt
    out += (opt.momentum_buffers if isinstance(opt, ReferenceSGD)
            else opt.mu + opt.nu)

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    walk(state.extra)
    return out


@torch.no_grad()
def _scramble(state) -> None:
    """NaN in every tensor, -1 in every count: what a restore leaves
    unwritten shows."""
    for t in _state_tensors(state):
        t.fill_(float("nan"))
    state.step = state.opt.count = -1
    if state.extra and "disc_opt_state" in state.extra:
        state.extra["disc_opt_state"]["count"] = -1


def _raw(path):
    """The file's msgpack tree as written: chunk dicts unjoined, arrays
    left as None."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), raw=False,
                               ext_hook=lambda code, data: None)


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        assert torch.equal(got[k].detach().cpu(), v), f"{what} {k}"


def assert_same(state, jstate) -> None:
    """Every leaf of the port's state bit-equal to the JAX state's."""
    key = flax_naming(state.model).key
    assert state.step == int(jstate.step)
    _same(state.model.state_dict(), from_flax(_np_tree({
        "params": jstate.params, "batch_stats": jstate.batch_stats}), key),
        "model")
    names = [k for k, _ in state.model.named_parameters()]
    if isinstance(state.opt, ReferenceSGD):
        trace, sched = jstate.opt_state[1]
        _same(dict(zip(names, state.opt.momentum_buffers)),
              _named(trace.trace, key), "trace")
        assert state.opt.count == int(sched.count)
    else:
        adam = jstate.opt_state[0]
        _same(dict(zip(names, state.opt.mu)), _named(adam.mu, key), "mu")
        _same(dict(zip(names, state.opt.nu)), _named(adam.nu, key), "nu")
        assert state.opt.count == int(adam.count)
    if jstate.extra is None:
        assert state.extra is None
        return
    assert set(state.extra) == set(jstate.extra)
    extra = state.extra
    for k, v in jstate.extra.items():
        if k == "ema_params":
            _same(extra[k], _named(v, key), k)
        elif k == "disc_params":
            _same(extra[k], _named(v, None), k)
        elif k == "disc_opt_state":
            _same(extra[k]["mu"], _named(v[0].mu, None), "disc mu")
            _same(extra[k]["nu"], _named(v[0].nu, None), "disc nu")
            assert extra[k]["count"] == int(v[0].count)
        elif k == "weight":
            assert torch.equal(extra[k], torch.from_numpy(np.array(v)))
        elif k == "class_memory":
            _same(extra[k], {m: torch.from_numpy(np.array(a)) for m, a in
                             v.items()}, k)
        else:
            raise AssertionError(f"unchecked extra {k}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_resume_a_jax_run_and_write_it_back(layout, tmp_path, monkeypatch,
                                            request):
    if layout == "scribblevc":
        run = _scribblevc(monkeypatch, request.getfixturevalue("jax_model"))
    else:
        run = globals()[f"_{layout}"](monkeypatch)
    if layout == "s2l":  # the buffer in 32 chunks, both ways
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", S2L_CHUNK)
        monkeypatch.setattr(tck, "MAX_CHUNK_BYTES", S2L_CHUNK)
    jstate = run.jstate
    for t in range(2):
        jstate, _ = run.jstep(jstate, t)
    path = str(tmp_path / "jax" / "latest_full.ckpt")
    jck.save_train_state(path, jstate)
    if layout == "s2l":
        assert len(_raw(path)["extra"]["weight"]["chunks"]) == 32
    _scramble(run.state)
    assert tck.restore_train_state(path, run.state) == "jax"
    assert_same(run.state, jstate)
    # written back at once: the JAX package's bytes
    again = str(tmp_path / "again" / "latest_full.ckpt")
    tck.save_jax_train_state(again, run.state)
    assert open(again, "rb").read() == open(path, "rb").read()

    # one more step from each package's state
    before = None
    if layout == "scribblevc":
        adam = jstate.opt_state[0]
        before = (tsvc._flat(adam.mu), tsvc._flat(adam.nu),
                  tsvc._flat(jstate.params))
    tm = run.step(2)
    jstate, jm = run.jstep(jstate, 2)
    assert run.state.step == int(jstate.step)
    run.compare(run.state, jstate, tm, jm, before)

    # the port's state in the JAX layout, into the JAX state as template
    out = str(tmp_path / "port" / "latest_full.ckpt")
    tck.save_jax_train_state(out, run.state)
    back = jck.restore_train_state(out, jstate)
    leaves, tree = jax.tree.flatten(back)
    assert tree == jax.tree.structure(jstate)
    for a, b in zip(leaves, jax.tree.leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert_same(run.state, back)


# ---- chunks, paths, the Trainer, mismatches ---------------------------------


def test_chunked_leaves_both_ways_match_flax(tmp_path, monkeypatch):
    """With flax's threshold (and the port's) lowered to 256 bytes: the
    port writes the JAX package's save_checkpoint bytes, a leaf of 16
    chunks (keys "10".."15" sort before "2" as strings) among them, and
    each package reads the other's file back to the same arrays."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(tck, "MAX_CHUNK_BYTES", 256)
    rs = np.random.RandomState(0)
    tree = {"b": {"big": rs.randint(-9, 9, 1000).astype(np.int32),
                  "two": rs.standard_normal((3, 5, 7)).astype(np.float32)},
            "a": rs.standard_normal(8).astype(np.float32),
            "step": np.asarray(7, np.int32), "none": None}
    flax_file = tmp_path / "flax.ckpt"
    jck.save_checkpoint(str(flax_file), tree)
    port_file = str(tmp_path / "port.ckpt")
    tck.save_flax_msgpack(port_file, tree)
    raw = _raw(port_file)["b"]
    assert len(raw["big"]["chunks"]) == 16 and len(raw["two"]["chunks"]) == 2
    assert open(port_file, "rb").read() == flax_file.read_bytes()
    for got in (tck.load_jax_checkpoint(str(flax_file)),
                serialization.msgpack_restore(open(port_file, "rb").read())):
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _flax_paths(variables):
    out = set()
    for col in ("params", "batch_stats"):
        for path, _ in jax.tree_util.tree_flatten_with_path(
                dict(variables.get(col, {})))[0]:
            out.add((col,) + tuple(p.key for p in path))
    return out


@pytest.mark.parametrize("name", ["unet", "unet_cct", "unet_cct_3h",
                                  "unet_ds", "unet_urds", "pnet",
                                  "efficient_unet", "scribblevc", "disc"])
def test_flax_paths_of_every_trainable_model_invert(name, request):
    """The port's flax paths of each model a train state can hold are the
    JAX model's (jax.eval_shape of its init), and each inverts the
    renaming."""
    x = jnp.zeros((1, 32, 32, 1))
    key = jax.random.key(0)
    if name == "scribblevc":
        _, shapes = request.getfixturevalue("jax_model")
        model = tsvc._port_model()
    elif name == "disc":
        disc = jdisc.FCDiscriminator(num_classes=4, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: disc.init(
            {"params": k, "feature_perturb": k}, jnp.zeros((1, 32, 32, 4)),
            x, train=False), key)
        model = FCDiscriminator(4, (32, 32), dtype=torch.float32)
    else:
        jm = jax_factory(name, 4, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: jm.init(
            {"params": k, "dropout": k}, x, train=False), key)
        model = net_factory(name, 4, dtype=torch.float32)
    naming = flax_naming(model)
    want = _flax_paths(shapes)
    port = {}
    for col, named in (("params", dict(model.named_parameters())),
                       ("batch_stats", dict(model.named_buffers()))):
        for k in named:
            path = naming.path(k)
            assert naming.key(path) == k
            port[(col,) + path] = k
    assert set(port) == want


def test_jax_trainer_checkpoint_resumes_in_the_port_trainer(
        acdc_tree, tmp_path, monkeypatch):
    """The JAX Trainer runs fully_supervised 2 steps (narrow UNet) and
    writes latest_full.ckpt; the port's Trainer with resume=True in the
    same snapshot_path restores it bit for bit, logs the step and the
    format, and trains on to step 4, writing its own checkpoints."""
    monkeypatch.setattr(jcommon, "net_factory",
                        lambda name, n, dtype: junet.UNet(
                            features=FEATURES, num_classes=n, dtype=dtype))
    monkeypatch.setattr(tcommon, "net_factory",
                        functools.partial(net_factory, features=FEATURES))
    common = dict(method="fully_supervised", root_path=acdc_tree,
                  patch_size=(32, 32), batch_size=2, max_iterations=2,
                  val_every=10 ** 9, ckpt_every=2, compute_dtype="float32",
                  snapshot_root=str(tmp_path), log_every=1, seed=3)
    jcfg = JaxConfig(num_devices=1, **common)
    jtrainer = JaxTrainer(jcfg, jax_method("fully_supervised").build(jcfg),
                          use_tensorboard=False)
    jtrainer.train()
    ckpt = os.path.join(jcfg.snapshot_path, "latest_full.ckpt")
    assert os.path.isfile(ckpt)

    cfg = TrainConfig(device="cpu", resume=True,
                      **{**common, "max_iterations": 4})
    assert cfg.snapshot_path == jcfg.snapshot_path
    bundle = get_method("fully_supervised").build(cfg)
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    assert_same(bundle.state, jtrainer.state)
    with open(os.path.join(cfg.snapshot_path, "log.txt")) as f:
        assert f"{ckpt} (jax format) at step 2" in f.read()
    trainer.train()
    assert bundle.state.step == bundle.state.opt.count == 4
    for name in ("iter_4.pth", "latest_full.ckpt"):
        assert os.path.isfile(os.path.join(cfg.snapshot_path, name))
    assert tck._is_torch_file(ckpt)


def _jax_file(path, extra=None):
    jmodel = junet.UNet(features=FEATURES, dtype=jnp.float32)
    key = jax.random.key(0)
    v = jmodel.init({"params": key, "dropout": key},
                    jnp.zeros((1, 32, 32, 1)), train=False)
    js = JaxState.create(apply_fn=jmodel.apply, params=v["params"],
                         batch_stats=v["batch_stats"],
                         tx=reference_sgd(0.01, 100),
                         extra={"ema_params": v["params"]} if extra else None)
    jck.save_train_state(str(path), js)
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("extra missing", "ema_params"), ("extra left over", "ema_params"),
    ("optimizer", "opt_state"), ("model", "decoder")])
def test_mismatched_checkpoint_raises_naming_the_key(case, match, tmp_path):
    path = _jax_file(tmp_path / "latest_full.ckpt",
                     extra=case == "extra left over")
    model = net_factory("unet_cct" if case == "model" else "unet", 4,
                        dtype=torch.float32, features=FEATURES)
    opt = (ReferenceAdamW(model.parameters()) if case == "optimizer"
           else ReferenceSGD(model.parameters(), 0.01, 100))
    extra = None
    if case == "extra missing":
        extra = {"ema_params": {k: p.detach().clone()
                                for k, p in model.named_parameters()}}
    state = TrainState(model=model, opt=opt, extra=extra)
    with pytest.raises((KeyError, RuntimeError), match=match):
        tck.restore_train_state(path, state)
