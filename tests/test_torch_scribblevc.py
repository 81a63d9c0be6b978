"""ScribbleVC in both packages, on the CPU in f32 (the port's model, memory
step, method step, AdamW, decision rules, NaN-aware metric and folds
against the JAX package in the same process).

The reduced config keeps the published structure: depth 12 (the decoder
taps stages 4, 8 and 12), base_channel 8, embed_dim 32, 2 heads, patch 16,
64x64, batch 2. Both models take the same parameters: the port's seeded
init, written into the flax tree through ``utils.params``' renaming (the
JAX side is never initialised, only shaped by ``jax.eval_shape``).
Inputs are synthetic phantoms; random draws are injected (beta by the JAX
key each step's draw gets, the augmentation as the identity) or switched
off (drop-path 0).

Tolerances:
- the memory step alone: rtol 1e-5, atol 1e-6 (outputs and gradients);
- eval-mode outputs: 1e-4 of the largest magnitude;
- train-mode outputs and the new memory: TRAIN_TOL = 1e-3 of the largest
  magnitude. Train-mode BatchNorm normalises the deep stages by the
  statistics of 32 values a channel (4x4 at batch 2), which amplifies
  rounding: a 1e-7 relative perturbation of the input moves the outputs by
  up to 8e-5 of their largest (the port's own forward), and the two
  packages' eval outputs (the same graph without batch statistics), 3e-6
  apart, come out 2e-5-4.6e-4 apart in train mode (four seeds). A
  known-wrong variant, exact GELU in place of flax's tanh form, lands at
  1.5e-3-3.8e-3 on the same seeds and must exceed TRAIN_TOL here;
- the three steps, each from the same state (parameters drawn from seed
  6, whose class memory injections are live at both gate-open steps):
  losses rtol LOSS_RTOL = 1e-4 (measured <= 6.8e-5), the memory TRAIN_TOL
  (<= 2.6e-4), BN running statistics rtol 1e-3, atol 2e-4. Each step's
  gradient, recovered from the Adam moments, in norm over all parameters:
  GRAD_TOL = 1e-2 (measured 6.9e-4, 6.3e-3, 3.3e-3; the planted fault of
  a memory path without gradient 0.146 and 0.0149), its square from nu
  G2_TOL = 5e-2 (<= 2.1e-2); the update p_after - p_before of the two
  later steps UPDATE_TOL = 3e-2 (1.9e-2, 1.0e-2; planted 0.145, 0.042).
  Each parameter also stays within one AdamW step of the JAX one
  (ADAM_REACH, a sanity bound: the first update is lr * sign(g), and an
  element whose gradient lies inside the spread takes +lr in one package
  and -lr in the other). The train-mode spread can cross a discrete
  threshold: from seed 1's parameters one pixel of 8192 sits at the
  pseudo-label gate (smaller probability 0.50129 in JAX, 0.49871 in the
  port) and loss_pseudo differs by 1.3e-4 at the first step;
- decisions exact; the NaN-aware metric exact; fold lists equal.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.scribblevc as jsvc  # noqa: E402
import wsl4mis_tpu.models.scribblevc as jmodel  # noqa: E402
from wsl4mis_tpu.data import acdc as jacdc  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_tpu.eval.metrics import (  # noqa: E402
    calculate_metric_percase_nan as jax_nan_metric,
)
import wsl4mis_torch.engine.methods.common as tcommon  # noqa: E402
import wsl4mis_torch.models.scribblevc as tmodel  # noqa: E402
from wsl4mis_torch.data import acdc as tacdc  # noqa: E402
from wsl4mis_torch.data import synthetic_slices, synthetic_volumes  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods, get_method  # noqa: E402
from wsl4mis_torch.engine.methods import scribblevc as tsvc  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceAdamW  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.eval.metrics import calculate_metric_percase_nan  # noqa: E402
from wsl4mis_torch.eval.val2d import VolumePredictor, evaluate_fold  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import (  # noqa: E402
    from_flax,
    load_flax_variables,
    scribblevc_key,
)

KW = dict(num_classes=4, batch_size=2, base_channel=8, embed_dim=32,
          depth=12, num_heads=2, patch_size=16, drop_path_rate=0.0)
B, HW = 2, 64
TRAIN_TOL = 1e-3
LOSS_RTOL = 1e-4
ADAM_REACH = 2 * 5e-4 + 1e-6  # two AdamW updates of opposite sign
B1, B2 = 0.9, 0.999  # optax.adamw's defaults
GRAD_TOL = 0.01
G2_TOL = 0.05
UPDATE_TOL = 0.03
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.detach().cpu().numpy()


def _port_model(seed=0):
    return net_factory("scribblevc", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed),
                       **{k: v for k, v in KW.items() if k != "num_classes"})


def _fill(shapes, state, rs, col, prefix=()):
    """The flax tree of `shapes` holding the port's tensors (params,
    batch_stats) or random values (batch_stats drawn when rs is given,
    class_memory)."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, state, rs, col, prefix + (k,))
        elif col == "class_memory":
            out[k] = (np.zeros(v.shape, np.float32) if rs is None else
                      np.float32(1.0) if k == "initialized" else
                      (0.3 * rs.standard_normal(v.shape)).astype(np.float32))
        elif col == "batch_stats" and rs is not None:
            out[k] = ((0.5 + rs.rand(*v.shape)) if k == "var" else
                      0.1 * rs.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = _np(state[scribblevc_key(prefix + (k,))]).copy()
    return out


@pytest.fixture(scope="module")
def jax_model():
    model = jmodel.ScribbleVC(dtype=jnp.float32, **KW)
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k, "dropout": k},
                             jnp.zeros((1, HW, HW, 1)), train=False),
        jax.random.key(0))
    return model, shapes


def _variables(shapes, seed, random_stats):
    """(flax variables, the port model holding them, its memory)."""
    model = _port_model(seed)
    rs = np.random.RandomState(seed)
    state = model.state_dict()
    variables = {c: _fill(t, state, rs if random_stats else None, c)
                 for c, t in shapes.items()}
    memory = model.init_memory((HW, HW))
    load_flax_variables(model, variables, memory)
    return variables, model, memory


def _images(seed=0, n=B):
    return synthetic_slices(n, (HW, HW), seed=seed).images[..., None]


# ---- the memory step alone ---------------------------------------------------


def _memory_inputs(seed):
    rs = np.random.RandomState(seed)
    ncls, h, c, t, e = 3, 4, 16, 17, 8
    arrays = {
        "hf": rs.standard_normal((B, h, h, c)),
        "tf": rs.standard_normal((B, t, e)),
        "conv_cls": 2.0 * rs.standard_normal((B, ncls)),
        "tran_cls": 2.0 * rs.standard_normal((B, ncls)),
        "hist_conv": rs.standard_normal((ncls, h, h, c)),
        "hist_tran": rs.standard_normal((ncls, t, e)),
        "kc": 0.3 * rs.standard_normal((3, 3, c, ncls)),
        "kt": 0.3 * rs.standard_normal((e, ncls)),
        "bt": 0.1 * rs.standard_normal((ncls,)),
        "g_dh": rs.standard_normal((B, h, h, c)),
        "g_tr": rs.standard_normal((B, t, e)),
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _jax_memory(a, initialized):
    def conv_head(z):
        y = jax.lax.conv_general_dilated(
            z, jnp.asarray(a["kc"]), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.mean(y, axis=(1, 2))

    def trans_head(z):
        return z @ jnp.asarray(a["kt"]) + jnp.asarray(a["bt"])

    def f(hf, tf, conv_cls, tran_cls):
        dh, t_rep, nh, nt = jmodel.class_memory_update(
            hf, tf, conv_cls, tran_cls, jnp.asarray(a["hist_conv"]),
            jnp.asarray(a["hist_tran"]), jnp.float32(initialized), 0.5,
            conv_head, trans_head)
        loss = jnp.sum(dh * a["g_dh"]) + jnp.sum(t_rep * a["g_tr"])
        return loss, (dh, t_rep, nh, nt)

    args = [jnp.asarray(a[k]) for k in ("hf", "tf", "conv_cls", "tran_cls")]
    (_, outs), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True)(*args)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_memory(a, initialized):
    kc = torch.from_numpy(a["kc"])

    def conv_head(z):
        y = torch.nn.functional.conv2d(z.permute(0, 3, 1, 2),
                                       kc.permute(3, 2, 0, 1), padding=1)
        return y.mean((2, 3))

    def trans_head(z):
        return z @ torch.from_numpy(a["kt"]) + torch.from_numpy(a["bt"])

    args = [torch.tensor(a[k], requires_grad=True)
            for k in ("hf", "tf", "conv_cls", "tran_cls")]
    dh, t_rep, nh, nt = tmodel.class_memory_update(
        *args, torch.from_numpy(a["hist_conv"]),
        torch.from_numpy(a["hist_tran"]), torch.tensor(float(initialized)),
        0.5, conv_head, trans_head)
    assert not nh.requires_grad and not nt.requires_grad
    loss = ((dh * torch.from_numpy(a["g_dh"])).sum()
            + (t_rep * torch.from_numpy(a["g_tr"])).sum())
    loss.backward()
    return [_np(o) for o in (dh, t_rep, nh, nt)], [_np(x.grad) for x in args]


@pytest.mark.parametrize("initialized,seed", [(0, 4), (1, 21)])
def test_class_memory_update_matches(initialized, seed):
    """Injections, new prototypes and the gradients to the features and
    both heads' logits, on inputs where some prototypes of both heads pass
    the class-max test (so every term is live): the fresh (1 - w) *
    rep_masked term reaches the gradient (no gradient is all zero)."""
    a = _memory_inputs(seed)
    (jo, jg), (to, tg) = _jax_memory(a, initialized), _port_memory(
        a, initialized)
    for name, got, want in zip(("dh", "t_rep", "hist_conv", "hist_tran"),
                               to, jo):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert np.abs(want).max() > 0, name
    for name, got, want in zip(("hf", "tf", "conv_cls", "tran_cls"), tg, jg):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert np.abs(want).max() > 0, name


# ---- the model ---------------------------------------------------------------


def _outputs(out):
    seg_conv, seg_trans, (conv_cls, tran_cls) = out
    return [np.asarray(o) if not isinstance(o, torch.Tensor) else _np(o)
            for o in (seg_conv, seg_trans, conv_cls, tran_cls)]


@pytest.mark.parametrize("with_memory", [False, True])
def test_eval_forward_matches(jax_model, with_memory):
    """Eval mode, random BN running statistics and memory: all four
    outputs to 1e-4 of their largest magnitude."""
    jm, shapes = jax_model
    variables, model, memory = _variables(shapes, 1, random_stats=True)
    x = _images(1)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                         use_class_rep=with_memory))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False, memory=memory,
                    use_class_rep=with_memory)
    for g, w in zip(_outputs(got), _outputs(want)):
        assert _rel(g, w) <= 1e-4


@pytest.fixture(scope="module")
def jax_train_forward(jax_model):
    jm, _ = jax_model
    return jax.jit(lambda v, x, gate: jm.apply(
        v, x, train=True, use_class_rep=True, rep_gate=gate,
        mutable=["batch_stats", "class_memory"]))


@pytest.mark.parametrize("gate", [0, 1])
def test_train_forward_matches(jax_model, jax_train_forward, gate, monkeypatch):
    """Train mode from a stored memory (initialized 1): at gate 0 the port
    runs without the memory and keeps it, at gate 1 it updates it; the
    outputs, the new memory and the BN running statistics agree to
    TRAIN_TOL, and the exact-GELU variant does not."""
    _, shapes = jax_model
    variables, model, memory = _variables(shapes, 2, random_stats=True)
    x = _images(2)
    out, mut = jax_train_forward(variables, jnp.asarray(x), float(gate))
    kept = {k: v.clone() for k, v in memory.items()}
    got = model(torch.from_numpy(x), train=True, memory=memory,
                use_class_rep=bool(gate))
    errs = [_rel(g, w) for g, w in zip(_outputs(got), _outputs(out))]
    assert max(errs) <= TRAIN_TOL, errs
    for k, v in memory.items():
        want = np.asarray(mut["class_memory"][k])
        if gate:
            assert _rel(v, want) <= TRAIN_TOL, k
        else:
            np.testing.assert_array_equal(_np(v), _np(kept[k]))
            np.testing.assert_array_equal(want, variables["class_memory"][k])
    stats = from_flax({"params": variables["params"],
                       "batch_stats": mut["batch_stats"]}, scribblevc_key)
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(_np(v), stats[k].numpy(), rtol=1e-3,
                                       atol=2e-4, err_msg=k)
    # the wrong variant, from the same state
    _, wrong, wmem = _variables(shapes, 2, random_stats=True)
    monkeypatch.setattr(tmodel, "_gelu", torch.nn.functional.gelu)
    bad = wrong(torch.from_numpy(x), train=True, memory=wmem,
                use_class_rep=bool(gate))
    bad_errs = [_rel(g, w) for g, w in zip(_outputs(bad), _outputs(out))]
    assert max(bad_errs) > TRAIN_TOL, bad_errs


def test_flax_tree_maps_onto_the_model(jax_model):
    """Every flax path maps to one port tensor of its shape, and back."""
    _, shapes = jax_model
    model = _port_model()
    state = model.state_dict()
    flat = from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                  {c: shapes[c] for c in ("params",
                                                          "batch_stats")}),
                     model.flax_key)
    assert set(flat) == set(state)
    for k, v in flat.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
    mem = model.init_memory((HW, HW))
    for k, v in shapes["class_memory"].items():
        assert tuple(mem[k].shape) == tuple(v.shape), k


def test_drop_path_takes_a_keep_mask():
    x = torch.ones((3, 2, 2))
    keep = torch.tensor([True, False, True])[:, None, None]
    y = tmodel.drop_path(x, 0.25, keep=keep)
    scaled = np.float32(1.0) / np.float32(0.75)
    np.testing.assert_array_equal(_np(y[:, 0, 0]), [scaled, 0.0, scaled])
    assert tmodel.drop_path(x, 0.0) is x
    g = torch.Generator().manual_seed(0)
    kept = (tmodel.drop_path(torch.ones((4000, 1)), 0.1, g) > 0).float()
    assert abs(float(kept.mean()) - 0.9) < 0.02


# ---- the step ----------------------------------------------------------------


class KeyedDraws:
    """A JAX draw inside jit replaced by the value registered for its key
    (NaN for an unknown key, so a miss shows)."""

    def __init__(self):
        self.keys, self.values = [], []

    def add(self, key, value):
        self.keys.append(np.asarray(jax.random.key_data(key)).ravel())
        self.values.append(np.float32(value))

    def __call__(self, key, *args, **kwargs):
        known = jnp.asarray(np.stack(self.keys))
        hit = jnp.all(jax.random.key_data(key).ravel() == known, axis=1)
        value = jnp.asarray(np.stack(self.values))[jnp.argmax(hit)]
        return jnp.where(hit.any(), value, jnp.nan)


def _batches():
    data = synthetic_slices(STEPS * B, (HW, HW), seed=5, sup_type="scribble")
    cats = tsvc.slice_categories(data.dense_labels, 4)
    return [{"image": data.images[i * B:(i + 1) * B],
             "label": data.labels[i * B:(i + 1) * B],
             "category": cats[i * B:(i + 1) * B]} for i in range(STEPS)]


def _adam_state(opt_state):
    return opt_state[0]  # optax.adamw: (ScaleByAdamState, decay, scale)


def _flat(tree):
    """A flax params tree (JAX arrays) -> numpy arrays by port name."""
    return {k: v.numpy() for k, v in from_flax(
        {"params": jax.tree.map(np.asarray, tree)}, scribblevc_key).items()}


def _norm_rel(got, want):
    """||got - want|| / ||want|| over all parameters (dicts by name)."""
    diff = sum(float(((np.float64(got[k]) - want[k]) ** 2).sum())
               for k in want)
    norm = sum(float((np.float64(want[k]) ** 2).sum()) for k in want)
    return (diff / norm) ** 0.5


def _step_grads(mu, nu, mu_prev, nu_prev):
    """The step's gradient and its square, recovered from Adam's moments
    before and after it: mu = b1 mu_prev + (1 - b1) g, nu likewise."""
    g = {k: (np.float64(mu[k]) - B1 * mu_prev[k]) / (1 - B1) for k in mu}
    g2 = {k: (np.float64(nu[k]) - B2 * nu_prev[k]) / (1 - B2) for k in nu}
    return g, g2


def _sync(state, memory, jstate):
    """Load the JAX state (parameters, BN statistics, Adam moments, memory)
    into the port's, in place."""
    load_flax_variables(state.model, jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "class_memory": jstate.extra["class_memory"]}), memory)
    adam = _adam_state(jstate.opt_state)
    names = [k for k, _ in state.model.named_parameters()]
    for moments, jtree in ((state.opt.mu, adam.mu), (state.opt.nu, adam.nu)):
        ref = _flat(jtree)
        with torch.no_grad():
            for name, m in zip(names, moments):
                m.copy_(torch.from_numpy(ref[name]))


def _detached_memory(update):
    """class_memory_update with no gradient through the memory path (a
    planted fault: the fresh (1 - w) * rep_masked term detached)."""
    def planted(hf, tf, conv_cls, tran_cls, *args):
        return update(hf.detach(), tf.detach(), conv_cls.detach(),
                      tran_cls.detach(), *args)
    return planted


def test_three_steps_match(jax_model, monkeypatch):
    """Steps at state.step 4, 5, 6 with one step an epoch: the memory gate
    is closed at the first, opens at the second (initialized 0 -> 1) and
    takes its EMA branch at the third, with both injections live (nonzero)
    at the two gate-open steps. Each step starts from the same state in
    both packages (the port's is reloaded from the JAX one before it): a
    train-mode gradient agrees only to its rounding spread (module
    docstring), and AdamW's first update is lr * sign(g), so free-running
    trajectories part by ~1% of the loss in one step.

    Each step's gradient, recovered from the Adam moments before and after
    it, is held in norm to JAX's (GRAD_TOL; its square from nu, G2_TOL);
    from the second step on, so is the parameter update p_after - p_before
    (UPDATE_TOL). Planted faults must fail these checks: the halved
    gradient, the update not applied, and at each gate-open step a port
    step with no gradient through the memory path (the fresh term
    detached)."""
    jm, shapes = jax_model
    variables, model, memory = _variables(shapes, 6, random_stats=False)
    draws = KeyedDraws()
    betas = (0.3, 0.8, 0.55)
    rngs_j = [jax.random.key(40 + t) for t in range(STEPS)]
    for rng, beta in zip(rngs_j, betas):
        draws.add(jcommon.split_rngs(rng)["method"], beta - 1e-10)
    monkeypatch.setattr(jcommon, "_augment_impl",
                        lambda: (lambda rng, images, labels: (images, labels)))
    monkeypatch.setattr(tcommon, "augment_batch",
                        lambda gen, images, labels: (images, labels))
    monkeypatch.setattr(jsvc.jax.random, "uniform", draws)

    common = dict(method="scribblevc", batch_size=B, patch_size=(HW, HW),
                  sup_type="scribble", compute_dtype="float32")
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
    step = tsvc.make_step(TrainConfig(device="cpu", **common), 1)
    names = [k for k, _ in model.named_parameters()]

    def port_step(t, batch):
        state.step = 4 + t
        state.opt.count = int(_adam_state(jstate.opt_state).count)
        _sync(state, memory, jstate)
        return step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    split_rngs(0, t, "cpu"), beta=torch.tensor(betas[t]))

    def moments():
        return ([_np(m).copy() for m in state.opt.mu],
                [_np(m).copy() for m in state.opt.nu])

    for t, batch in enumerate(_batches()):
        adam = _adam_state(jstate.opt_state)
        mu_prev, nu_prev = _flat(adam.mu), _flat(adam.nu)
        p_prev = _flat(jstate.params)
        planted = None
        if t >= 1:  # the gate is open
            with monkeypatch.context() as m:
                m.setattr(tmodel, "class_memory_update",
                          _detached_memory(tmodel.class_memory_update))
                port_step(t, batch)
            planted = moments() + ([_np(v).copy()
                                    for v in model.parameters()],)
        tm = port_step(t, batch)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, rngs_j[t])
        assert set(tm) == set(jm_)
        for k in ("total_loss", "loss_ce", "loss_pseudo", "loss_crf",
                  "loss_cls"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"{k} step {t}")
        for k in ("proto_acc_conv", "proto_acc_tran"):
            assert float(tm[k]) == float(jm_[k]), k
        for k in ("mem_conv_absmax", "mem_conv_absmean", "mem_tran_absmax"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=TRAIN_TOL, atol=1e-6, err_msg=k)
        assert float(memory["initialized"]) == (t >= 1)
        assert state.step == int(jstate.step) == 5 + t

        adam = _adam_state(jstate.opt_state)
        g_j, g2_j = _step_grads(_flat(adam.mu), _flat(adam.nu), mu_prev,
                                nu_prev)

        def grads(mu, nu):
            return _step_grads(dict(zip(names, mu)), dict(zip(names, nu)),
                               mu_prev, nu_prev)

        g_t, g2_t = grads(*moments())
        err = _norm_rel(g_t, g_j)
        assert err <= GRAD_TOL, (t, err)
        assert _norm_rel(g2_t, g2_j) <= G2_TOL, t
        halved = {k: 0.5 * v for k, v in g_t.items()}
        assert _norm_rel(halved, g_j) > GRAD_TOL
        if planted is not None:
            err = _norm_rel(grads(*planted[:2])[0], g_j)
            assert err > GRAD_TOL, (t, err)

        want = from_flax(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}),
            scribblevc_key)
        got = {k: _np(v) for k, v in model.state_dict().items()}
        for k in names:  # a sanity bound: one AdamW step of each other
            np.testing.assert_array_less(
                np.abs(got[k] - want[k].numpy()), ADAM_REACH, err_msg=k)
        if t:
            dp_j = {k: np.float64(want[k].numpy()) - p_prev[k] for k in names}

            def update_err(params):
                return _norm_rel({k: np.float64(params[k]) - p_prev[k]
                                  for k in names}, dp_j)

            assert update_err(got) <= UPDATE_TOL, (t, update_err(got))
            assert update_err(p_prev) > UPDATE_TOL  # not applied
            if planted is not None:
                assert update_err(dict(zip(names, planted[2]))) > UPDATE_TOL
        for k in got:
            if k not in names:  # BN running statistics
                np.testing.assert_allclose(got[k], want[k].numpy(),
                                           rtol=1e-3, atol=2e-4, err_msg=k)
        for k, v in memory.items():
            want_m = np.asarray(jstate.extra["class_memory"][k])
            if t == 0:
                np.testing.assert_array_equal(_np(v), want_m)
            else:
                assert _rel(_np(v), want_m) <= TRAIN_TOL, k


def test_adamw_matches_optax():
    """Five updates of ReferenceAdamW and optax.adamw(5e-4, eps 1e-8, wd
    5e-4) on the same gradients: parameters and moments to rtol 1e-6."""
    rs = np.random.RandomState(0)
    init = {"a": rs.standard_normal((5, 7)), "b": rs.standard_normal((3,))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    params = [torch.tensor(v, requires_grad=True) for v in init.values()]
    opt = ReferenceAdamW(params)
    tx = optax.adamw(5e-4, eps=1e-8, weight_decay=5e-4)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    for _ in range(5):
        g = {k: rs.standard_normal(v.shape).astype(np.float32)
             for k, v in init.items()}
        opt.zero_grad()
        for p, gv in zip(params, g.values()):
            p.grad = torch.from_numpy(gv)
        opt.step()
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
    for i, k in enumerate(init):
        np.testing.assert_allclose(_np(params[i]), np.asarray(jp[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(opt.mu[i]), np.asarray(st[0].mu[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(opt.nu[i]), np.asarray(st[0].nu[k]),
                                   rtol=1e-6)
    assert opt.count == int(st[0].count) == 5
    # no mask: a parameter without a gradient still decays, by lr * wd
    p = torch.tensor([2.0, -1.0], requires_grad=True)
    ReferenceAdamW([p]).step()
    np.testing.assert_allclose(_np(p), np.array([2.0, -1.0]) * (1 - 2.5e-7),
                               rtol=1e-7)


# ---- validation rules, metrics, folds ------------------------------------------


@pytest.mark.parametrize("rule", ["cam_decision", "mean_softmax_decision"])
def test_decisions_match(rule):
    rs = np.random.RandomState(1)
    outs = [(3.0 * rs.standard_normal((2, 16, 16, 4))).astype(np.float32)
            for _ in range(2)]
    want = np.asarray(getattr(jsvc, rule)([jnp.asarray(o) for o in outs]))
    got = getattr(tsvc, rule)([torch.from_numpy(o) for o in outs])
    np.testing.assert_array_equal(_np(got), want)
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("case", ["absent", "false_positive", "missed",
                                  "both"])
def test_nan_metric_matches(case):
    gt = np.zeros((4, 12, 12), bool)
    pred = np.zeros((4, 12, 12), bool)
    if case in ("missed", "both"):
        gt[1:3, 2:8, 3:9] = True
    if case in ("false_positive", "both"):
        pred[1:3, 4:9, 2:7] = True
    got = calculate_metric_percase_nan(pred, gt)
    want = jax_nan_metric(pred, gt)
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


@pytest.mark.parametrize("fold", ["fold1", "fold5", "MAAGfold", "MAAGfold70",
                                  "MAAGfold20", "MSCMRfold",
                                  "prostate_fold2", "prostate_a"])
def test_fold_ids_match(fold):
    assert tacdc.fold_ids(fold) == jacdc.resolve_fold_ids(fold)


def test_unknown_fold_raises():
    for fold in ("fold6", "prostate_fold5", "mscmr"):
        with pytest.raises(KeyError):
            tacdc.fold_ids(fold)


def test_slice_categories_match():
    labels = synthetic_slices(6, (16, 16), seed=2).dense_labels
    labels[0] = 0
    np.testing.assert_array_equal(tsvc.slice_categories(labels, 4),
                                  jsvc.slice_categories(labels, 4))


def test_all_seventeen_methods():
    names = available_methods()
    assert len(names) == 17 and "scribblevc" in names
    assert get_method("scribblevc") is tsvc


# ---- the bundle through the Trainer --------------------------------------------


@pytest.fixture
def narrow(monkeypatch):
    """make_bundle builds the test's narrow ScribbleVC (depth 12)."""
    monkeypatch.setattr(tsvc, "net_factory", functools.partial(
        net_factory, base_channel=8, embed_dim=32, num_heads=2))


def test_trainer_runs_the_bundle(tmp_path, narrow):
    """make_bundle on phantoms, two Trainer steps (the gate closed) and one
    validation: the memory lands in every inference checkpoint, the select
    predictor's metric names the snapshot and writes the best model, and a
    resume restores the memory into the bundle's own tensors."""
    cfg = TrainConfig(method="scribblevc", device="cpu", batch_size=B,
                      patch_size=(HW, HW), max_iterations=2, val_every=2,
                      ckpt_every=2, compute_dtype="float32", log_every=1,
                      sup_type="scribble", snapshot_root=str(tmp_path),
                      seed=3)
    train = synthetic_slices(4, (HW, HW), seed=3, sup_type="scribble")
    val = synthetic_volumes(2, 3, 40, 48, seed=4)
    bundle = tsvc.make_bundle(cfg, train, val)
    assert bundle.steps_per_epoch == 2 and bundle.nan_val_metrics
    np.testing.assert_array_equal(
        _np(bundle.aux["category"]),
        tsvc.slice_categories(train.dense_labels, 4))
    memory = bundle.state.extra["class_memory"]
    memory["hist_conv"].normal_(generator=torch.Generator().manual_seed(0))
    # a select rule with a known score: class 1 everywhere
    bundle.select_predictor = VolumePredictor(
        bundle.model, cfg.patch_size, device="cpu",
        decision_fn=lambda out: torch.ones_like(out[0][..., 0],
                                                dtype=torch.int64))
    bundle.dice_snapshot_threshold = 0.0
    assert Trainer(cfg, bundle, use_tensorboard=False).train() == \
        "Training Finished!"
    select = evaluate_fold(bundle.select_predictor, val, 4, nan_aware=True)
    dice = float(np.nanmean(select, axis=0)[0])
    assert dice > 0
    snap = cfg.snapshot_path
    names = ("iter_2.pth", f"{cfg.model}_best_model.pth",
             f"iter_2_dice_{round(dice, 4)}.pth",
             f"{cfg.model}_{str(dice)[0:6]}_model.pth")
    for name in names:
        ck = torch.load(os.path.join(snap, name), weights_only=True)
        assert set(ck) == {"model", "step", "class_memory"}, name
        for k, v in memory.items():
            torch.testing.assert_close(ck["class_memory"][k], v)
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    assert "val(train-rule)" in log and "val(select-rule)" in log

    cfg2 = cfg.replace(max_iterations=3, resume=True, val_every=10)
    bundle2 = tsvc.make_bundle(cfg2, train, val)
    mem2 = bundle2.state.extra["class_memory"]
    ptr = mem2["hist_conv"].data_ptr()
    Trainer(cfg2, bundle2, use_tensorboard=False)
    assert bundle2.state.step == 2 and bundle2.state.opt.count == 2
    assert mem2["hist_conv"].data_ptr() == ptr
    torch.testing.assert_close(mem2["hist_conv"], memory["hist_conv"],
                               rtol=0, atol=0)


def test_light_val_runs_only_the_select_rule(tmp_path, narrow):
    cfg = TrainConfig(method="scribblevc", device="cpu", batch_size=B,
                      patch_size=(32, 32), compute_dtype="float32",
                      snapshot_root=str(tmp_path), light_val=True)
    bundle = tsvc.make_bundle(cfg, synthetic_slices(2, (32, 32), seed=1),
                              synthetic_volumes(1, 2, 32, 32, seed=2))
    calls = []
    for name in ("predictor", "select_predictor"):
        pred = getattr(bundle, name)
        pred._predict = (lambda f, n: lambda *a: calls.append(n) or f(*a))(
            pred._predict, name)
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    perf, _ = trainer.validate(0)
    assert calls and set(calls) == {"select_predictor"}
    assert np.isfinite(perf) or np.isnan(perf)
    trainer.cfg = cfg.replace(light_val=False)
    calls.clear()
    trainer.validate(0)
    assert set(calls) == {"predictor", "select_predictor"}
