"""Parity of the port's UNet_DS, UNet_URDS, UNet_CCT_3H and PNet2D (on the
CPU, f32) with the JAX package's, from the same flax variables through
utils.params, at reduced widths (features 8..128, PNet 8 filters) on
64x64, batch 2: eval-mode logits (1e-5 of the largest), train-mode logits
with the random draws injected on both sides (channel-dropout masks, the
feature-dropout cut, feature noise; encoder dropout 0), the updated BN
running statistics and the parameter gradients of a fixed linear loss of
every output. Train mode normalises by batch statistics, whose one-pass
variance differs between the packages in f32 summation order (ROADMAP
Queue 3): logits and statistics to 1e-4. Gradients: each tensor to
GRAD_TOL in norm, the limit chip_smoke holds the card's UNet gradients
to. JAX against itself with the batch reversed (the same function,
another summation order in every BN sum) moves the encoder's gradients by
up to 2.2e-2 in norm at this size, and the port lies as close (2.6e-2 at
worst, UNet_URDS; PNet 4e-6). A conv bias that feeds a train-mode BN has
a gradient of 0 by construction (JAX's below 1e-5 of the model's largest
gradient element): there the port's must be below that too.

Also utils.feature_extractor against the JAX package's (flax
capture_intermediates through the bridge's renaming) and the profiling
helpers on the CPU; and the factory: every name builds, with MODEL_NUM_OUTPUTS outputs; a
single-output method given a multi-head model raises ValueError (the JAX
step raises TypeError on the tuple); no NotImplementedError is left in
the port."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_tpu.models.pnet as jpnet  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods.common import make_model_and_state  # noqa: E402
from wsl4mis_torch.models import (  # noqa: E402
    MODEL_NUM_OUTPUTS,
    PERTURBED_MODELS,
    net_factory,
)
from wsl4mis_torch.utils.params import (  # noqa: E402
    from_flax,
    load_flax_variables,
    zoo_key,
)

FEATURES = (8, 16, 32, 64, 128)
NO_DROPOUT = (0.0,) * 5
HW = 64
EVAL_RTOL = 1e-5
TRAIN_TOL = 1e-4
GRAD_TOL = 5e-2
ZERO_GRAD = 1e-5  # of the largest gradient element
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(name):
    if name == "pnet":
        return jpnet.PNet2D(num_filters=8, dtype=jnp.float32)
    cls = {"unet_ds": junet.UNetDS, "unet_urds": junet.UNetURDS,
           "unet_cct_3h": junet.UNetCCT3H}[name]
    return cls(features=FEATURES, dropout=NO_DROPOUT, dtype=jnp.float32)


def _port_kwargs(name):
    if name == "pnet":
        return {"num_filters": 8}
    return {"features": FEATURES, "dropout": NO_DROPOUT}


_VARIABLES = {}


def _variables(name):
    """Flax variables of the JAX model: its init, every leaf then moved by
    a seeded draw (BN scales and biases, running statistics) so that eval
    mode tests them."""
    if name not in _VARIABLES:
        key = jax.random.key(0)
        v = _jax_model(name).init(
            {"params": key, "dropout": key, "feature_perturb": key},
            jnp.zeros((1, HW, HW, 1)), train=False)
        v = jax.tree.map(np.asarray, v)
        rs = np.random.RandomState(1)
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rs.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            v["batch_stats"])
        _VARIABLES[name] = v
    return _VARIABLES[name]


def _port_model(name):
    model = net_factory(name, 4, dtype=torch.float32, **_port_kwargs(name))
    load_flax_variables(model, _variables(name))
    return model


def _x(seed=2):
    return np.random.RandomState(seed).standard_normal(
        (2, HW, HW, 1)).astype(np.float32)


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _rel_close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= tol, err


NAMES = ["unet_ds", "unet_urds", "unet_cct_3h", "pnet"]


def test_bridge_covers_every_entry():
    for name in NAMES:
        sd = from_flax(_variables(name),
                       getattr(net_factory(name), "flax_key", None))
        model = net_factory(name, 4, dtype=torch.float32,
                            **_port_kwargs(name))
        assert set(sd) == set(model.state_dict()), name
        assert all(sd[k].shape == v.shape
                   for k, v in model.state_dict().items()), name


_EVAL = {}


def _jax_eval(name):
    """The JAX model's eval outputs on _x(), once a name."""
    if name not in _EVAL:
        _EVAL[name] = _tuple(_jax_model(name).apply(
            _variables(name), jnp.asarray(_x()), train=False))
    return _EVAL[name]


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match(name):
    want = _jax_eval(name)
    with torch.no_grad():
        got = _tuple(_port_model(name)(torch.from_numpy(_x()), train=False))
    assert len(got) == len(want) == MODEL_NUM_OUTPUTS[name]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _rel_close(g, w, EVAL_RTOL)


def _draws(name, seed=3):
    """The train-mode draws of `name` at 64x64, batch 2, from numpy: JAX's
    functions to patch in and the port's forward kwargs."""
    rs = np.random.RandomState(seed)
    shapes = [(HW >> i, FEATURES[i]) for i in range(5)]
    if name == "unet_cct_3h":
        masks = [rs.rand(2, 1, 1, c) < 0.5 for _, c in shapes]
        noises = [rs.uniform(-0.3, 0.3, (h, h, c)).astype(np.float32)
                  for h, c in shapes]
        return ({"channel_dropout": masks, "feature_noise": noises},
                {"channel_masks": [torch.from_numpy(m) for m in masks],
                 "noises": [torch.from_numpy(n) for n in noises]})
    if name == "unet_urds":  # before the heads at 1/8, 1/4, 1/2
        mask = rs.rand(2, 1, 1, FEATURES[3]) < 0.5
        cut = np.float32(rs.uniform(0.7, 0.9))
        noise = rs.uniform(-0.3, 0.3, (HW // 2, HW // 2, FEATURES[1])
                           ).astype(np.float32)
        return ({"channel_dropout": [mask], "feature_dropout": [cut],
                 "feature_noise": [noise]},
                {"draws": {"channel_mask": torch.from_numpy(mask),
                           "cut": torch.tensor(cut),
                           "noise": torch.from_numpy(noise)}})
    if name == "pnet":
        masks = [rs.rand(2, 1, 1, c) < 0.7 for c in (16, 8)]
        return ({"channel_dropout": masks},
                {"channel_masks": [torch.from_numpy(m) for m in masks]})
    return {}, {}


def _patch_jax_draws(monkeypatch, name, draws):
    """JAX's draw functions replaced by ones that take the given draws in
    call order."""
    queues = {k: list(v) for k, v in draws.items()}

    def channel_dropout(rng, x, rate=0.5):
        keep = jnp.asarray(queues["channel_dropout"].pop(0))
        return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

    def feature_noise(rng, x, uniform_range=0.3):
        noise = jnp.asarray(queues["feature_noise"].pop(0)).astype(x.dtype)
        return x * noise[None] + x

    def feature_dropout(rng, x):
        attention = jnp.mean(x, axis=-1, keepdims=True)
        max_val = jnp.max(attention.reshape(x.shape[0], -1), axis=1)
        thresh = max_val * queues["feature_dropout"].pop(0)
        mask = (attention < thresh[:, None, None, None]).astype(x.dtype)
        return x * mask

    module = jpnet if name == "pnet" else junet
    for fn in (channel_dropout, feature_noise, feature_dropout):
        if fn.__name__ in queues:
            monkeypatch.setattr(module, fn.__name__, fn)
    return queues


def _loss_weights(n, seed=4):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((2, HW, HW, 4)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("name", NAMES)
def test_train_logits_stats_and_gradients_match(name, monkeypatch):
    jax_draws, port_draws = _draws(name)
    queues = _patch_jax_draws(monkeypatch, name, jax_draws)
    jm, variables = _jax_model(name), _variables(name)
    ws = _loss_weights(MODEL_NUM_OUTPUTS[name])
    key = jax.random.key(5)

    def loss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(_x()), train=True,
                            rngs={"dropout": key, "feature_perturb": key},
                            mutable=["batch_stats"])
        out = _tuple(out)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws)), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    assert all(not q for q in queues.values())  # every draw taken

    tm = _port_model(name)
    got = _tuple(tm(torch.from_numpy(_x()), train=True, **port_draws))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(got, ws)).backward()
    for g, w in zip(got, want):
        _rel_close(g.detach(), w, TRAIN_TOL)
    key_fn = getattr(tm, "flax_key", None)
    want_stats = from_flax({"batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])}, key_fn)
    stats = tm.state_dict()
    for k, v in want_stats.items():
        _rel_close(stats[k], v, TRAIN_TOL)
    want_grads = from_flax({"params": jax.tree.map(np.asarray, grads)},
                           key_fn)
    params = dict(tm.named_parameters())
    assert set(want_grads) == set(params)
    gmax = max(float(np.abs(v.numpy()).max()) for v in want_grads.values())
    for k, v in want_grads.items():
        got_g, v = params[k].grad.numpy(), v.numpy()
        if np.abs(v).max() <= ZERO_GRAD * gmax:
            assert np.abs(got_g).max() <= ZERO_GRAD * gmax, k
            continue
        err = np.linalg.norm(got_g - v) / np.linalg.norm(v)
        assert err <= GRAD_TOL, (k, err)


def test_port_draws_come_from_the_feature_perturb_generator():
    """A perturbed model's train forward repeats under the same
    feature_perturb seed and changes under another; the other models
    draw nothing from it."""
    x = torch.from_numpy(_x())

    def run(name, seed):
        torch.manual_seed(0)
        model = net_factory(name, 4, dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0),
                            **_port_kwargs(name))
        rngs = {"dropout": torch.Generator().manual_seed(9),
                "feature_perturb": torch.Generator().manual_seed(seed)}
        with torch.no_grad():
            return _tuple(model(x, train=True, rngs=rngs))[-1]

    for name in NAMES + ["unet"]:
        same = torch.equal(run(name, 1), run(name, 1))
        differ = not torch.equal(run(name, 1), run(name, 2))
        assert same and differ == (name in PERTURBED_MODELS), name


@pytest.mark.parametrize("name", sorted(MODEL_NUM_OUTPUTS))
def test_factory_builds_every_name(name):
    kwargs = {"pnet": {"num_filters": 8},
              "efficient_unet": {"encoder_name": "efficientnet-b0"}}.get(
                  name, {"features": FEATURES})
    model = net_factory(name, 4, dtype=torch.float32, **kwargs)
    with torch.no_grad():
        out = _tuple(model(torch.zeros(1, 32, 32, 1), train=False))
    assert len(out) == MODEL_NUM_OUTPUTS[name]
    assert all(o.shape == (1, 32, 32, 4) for o in out)


@pytest.mark.parametrize("model", ["unet_ds", "unet_urds", "unet_cct_3h",
                                   "unet_cct"])
def test_single_output_method_rejects_a_multi_head_model(model):
    cfg = TrainConfig(method="fully_supervised", model=model, device="cpu")
    with pytest.raises(ValueError, match=f"{model}.*returns"):
        make_model_and_state(cfg)


def test_jax_raises_on_a_tuple_in_the_single_output_loss():
    """What the port's ValueError stands for: the JAX package's
    supervised loss on a multi-head model's outputs fails."""
    from wsl4mis_tpu.engine.methods.common import supervised_ce_dice

    outs = tuple(jnp.zeros((1, 8, 8, 4)) for _ in range(4))
    with pytest.raises(TypeError):
        supervised_ce_dice(outs, jnp.zeros((1, 8, 8), jnp.int32), 4)


def test_no_not_implemented_error_left_in_the_port():
    found = []
    for root, _dirs, files in os.walk(os.path.join(REPO, "wsl4mis_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    if re.search(r"\bNotImplementedError\b", f.read()):
                        found.append(name)
    assert not found


def _port_path(flax_name):
    """The port module of a flax capture_intermediates entry
    ("PNetBlock_0/DilatedConv_1/__call__/0"), by the bridge's renaming."""
    parts = flax_name.split("/")
    assert parts[-2:] == ["__call__", "0"], flax_name
    return zoo_key(tuple(parts[:-2]))


@pytest.mark.parametrize("layer_name,upscale_to", [(None, None),
                                                   ("Block_3", (96, 96))])
def test_extract_features_matches_capture_intermediates(layer_name,
                                                        upscale_to):
    """utils.feature_extractor on PNet2D against the JAX package's
    extract_features (flax capture_intermediates): every module output
    JAX captures is the port's output of the module the bridge maps it to,
    to 1e-5 of its largest; with a filter and a nearest upscale too."""
    from wsl4mis_tpu.utils.feature_extractor import (
        extract_features as jax_extract,
    )
    from wsl4mis_torch.utils.feature_extractor import extract_features

    x = _x()
    jm, v = _jax_model("pnet"), _variables("pnet")
    want_out, want = jax_extract(jm, v, jnp.asarray(x), layer_name,
                                 upscale_to, train=False)
    port_filter = None if layer_name is None else "pnet_block.3"
    with torch.no_grad():
        got_out, got = extract_features(_port_model("pnet"),
                                        torch.from_numpy(x), port_filter,
                                        upscale_to, train=False)
    _rel_close(got_out, want_out, EVAL_RTOL)
    assert len(want) > (3 if layer_name else 20)
    for name, value in want.items():
        if name == "__call__/0":  # the model's own output, compared above
            continue
        path = _port_path(name)
        assert path in got, (name, path)
        assert tuple(got[path].shape) == value.shape, name
        _rel_close(got[path], value, EVAL_RTOL)
    # the port records every submodule; the filter keeps its subtree
    if layer_name:
        assert all(k.startswith("pnet_block.3") for k in got)


def test_measure_fwd_bwd_time_and_trace(tmp_path):
    """The profiling helpers on the CPU (the host clock; CUDA events on
    the card): positive times per iteration, the model's gradients left
    untouched, and a Chrome trace written by trace()."""
    from wsl4mis_torch.utils.profiling import measure_fwd_bwd_time, trace

    model = net_factory("unet_ds", 4, dtype=torch.float32,
                        features=FEATURES)
    x = torch.from_numpy(_x())
    fwd, fwd_bwd = measure_fwd_bwd_time(model, x, n_warmup=1, n_iters=2)
    assert 0 < fwd and 0 < fwd_bwd
    assert all(p.grad is None for p in model.parameters())
    with trace(str(tmp_path / "prof")):
        with torch.no_grad():
            model(x, train=False)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("name", NAMES)
def test_jax_inference_checkpoint_loads(name, tmp_path):
    """The JAX package's inference checkpoint of each model (its
    save_model_checkpoint: params, batch_stats, step) loads through the
    port's load_model_checkpoint, as the test command reads it: the
    step, and every head's eval logits within 1e-5 of the largest."""
    import types

    from wsl4mis_tpu.utils.checkpoint import save_model_checkpoint
    from wsl4mis_torch.utils.checkpoint import load_model_checkpoint

    v = _variables(name)
    path = str(tmp_path / f"{name}_best_model.pth")
    save_model_checkpoint(path, types.SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], step=7,
        extra=None))
    port = net_factory(name, 4, dtype=torch.float32, **_port_kwargs(name))
    assert load_model_checkpoint(path, port) == 7
    want = _jax_eval(name)
    with torch.no_grad():
        got = _tuple(port(torch.from_numpy(_x()), train=False))
    for g, w in zip(got, want):
        _rel_close(g, w, EVAL_RTOL)
