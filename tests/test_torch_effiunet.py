"""Parity of the port's EfficientNet-UNet and its weight converter with the
JAX package's (on the CPU, f32).

The model: EffiUNet-b0 (and b0 with scSE attention) on 64x64, batch 2,
from the same flax variables through utils.params: eval-mode logits to
1e-5 of the largest; train mode with the drop-connect masks injected on
both sides: logits and the updated BN running statistics to 1e-4 of the
largest, and each parameter gradient of a fixed linear loss to GRAD_TOL
in norm. Train mode normalises the stride-32 features by batch
statistics over 2x2 maps at batch 2 (8 values a channel), where f32
summation order moves single gradients (ROADMAP Queue 3, BN variance):
JAX against itself with the batch reversed differs by up to 1.8e-2 in
norm at this size; the port lies as close.

The converter: the port's convert_efficientnet_encoder gives the JAX
package's tree on synthesized efficientnet_pytorch state_dicts (b0, b3;
every in_channels rule of patch_first_conv); the port's
convert_torch_weights command writes the bytes the JAX script's
save_checkpoint writes; one converted file, loaded by each package into
the same EffiUNet, gives the same logits; the strict shape check refuses
a file of another model; and the train command's --encoder_weights starts
an efficient_unet from the file. No ImageNet weights exist offline, so
every state_dict is synthesized (tests/test_torch_import.py's
synth_state_dict)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402
from test_torch_import import synth_state_dict  # noqa: E402

import wsl4mis_tpu.models.efficientunet as jeff  # noqa: E402
import wsl4mis_tpu.utils.torch_import as jimport  # noqa: E402
from wsl4mis_tpu.utils.checkpoint import load_checkpoint as jax_load  # noqa: E402
from wsl4mis_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods.common import make_model_and_state  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils import torch_import as pimport  # noqa: E402
from wsl4mis_torch.utils.checkpoint import load_jax_checkpoint  # noqa: E402
from wsl4mis_torch.utils.params import (  # noqa: E402
    _flatten,
    from_flax,
    load_flax_variables,
)

HW = 64
EVAL_RTOL = 1e-5
TRAIN_TOL = 1e-4
GRAD_TOL = 5e-2
ZERO_GRAD = 1e-5  # of the largest gradient element


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_VARIABLES = {}


def _jax_model(name="efficientnet-b0", attention=None):
    return jeff.EffiUNet(encoder_name=name, attention=attention,
                         dtype=jnp.float32)


def _variables(name="efficientnet-b0", attention=None):
    """Flax variables of the JAX model (its init, jitted), the running
    statistics moved by a seeded draw (means by U(-0.2, 0.2), variances
    scaled by U(0.5, 1.5)) so that eval mode tests them."""
    if (name, attention) not in _VARIABLES:
        key = jax.random.key(0)
        jm = _jax_model(name, attention)
        v = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                      jnp.zeros((1, HW, HW, 1)),
                                      train=False))(key)
        v = jax.tree.map(np.asarray, v)
        rs = np.random.RandomState(1)

        def move(path, a):
            if path[-1].key == "mean":
                return (a + rs.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
            return (a * rs.uniform(0.5, 1.5, a.shape)).astype(np.float32)

        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            move, v["batch_stats"])
        _VARIABLES[name, attention] = v
    return _VARIABLES[name, attention]


def _port_model(variables, name="efficientnet-b0", attention=None):
    model = net_factory("efficient_unet", 4, dtype=torch.float32,
                        encoder_name=name, attention=attention)
    load_flax_variables(model, variables)
    return model


def _x(seed=2, hw=HW):
    return np.random.RandomState(seed).standard_normal(
        (2, hw, hw, 1)).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("attention", [None, "scse"])
def test_bridge_covers_every_entry(attention):
    sd = from_flax(_variables(attention=attention),
                   net_factory("efficient_unet").flax_key)
    model = net_factory("efficient_unet", 4, dtype=torch.float32,
                        encoder_name="efficientnet-b0", attention=attention)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == v.shape for k, v in own.items())


_EVAL = {}


def _jax_eval(attention=None):
    """The JAX EffiUNet-b0's eval logits on _x() (jitted), once."""
    if attention not in _EVAL:
        jm = _jax_model(attention=attention)
        _EVAL[attention] = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            _variables(attention=attention), jnp.asarray(_x()))
    return _EVAL[attention]


@pytest.mark.parametrize("attention", [None, "scse"])
def test_eval_logits_match(attention):
    v = _variables(attention=attention)
    want = _jax_eval(attention)
    with torch.no_grad():
        got = _port_model(v, attention=attention)(torch.from_numpy(_x()),
                                                  train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= EVAL_RTOL


def _drop_masks(model, seed=3):
    """One (2,1,1,1) keep mask per residual block with a non-zero rate, in
    block order, from numpy: each sample kept with probability 1/2, so
    that the few masks drop some samples (b0's rates stay under 0.2)."""
    rs = np.random.RandomState(seed)
    encoder = model.efficient_net_encoder[0]
    return [rs.rand(2, 1, 1, 1) < 0.5
            for b in encoder.mbconv if b.residual and b.drop_rate > 0]


def test_train_logits_stats_and_gradients_match(monkeypatch):
    v = _variables()
    tm = _port_model(v)
    masks = _drop_masks(tm)
    assert len(masks) > 4 and not all(m.all() for m in masks)
    queue = list(masks)

    def bernoulli(key, p, shape):  # MBConv's drop-connect draw
        keep = jnp.asarray(queue.pop(0))
        assert keep.shape == tuple(shape)
        return keep

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    w = np.random.RandomState(4).standard_normal(
        (2, HW, HW, 4)).astype(np.float32)
    jm = _jax_model()

    def loss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(_x()), train=True,
                            rngs={"dropout": jax.random.key(5)},
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    assert not queue  # every block drew its mask

    got = tm(torch.from_numpy(_x()), train=True,
             drop_masks=[torch.from_numpy(m) for m in masks])
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(got.detach(), want) <= TRAIN_TOL
    key = tm.flax_key
    stats = tm.state_dict()
    for k, val in from_flax({"batch_stats": jax.tree.map(
            np.asarray, mut["batch_stats"])}, key).items():
        assert _rel(stats[k], val) <= TRAIN_TOL, k
    want_grads = from_flax({"params": jax.tree.map(np.asarray, grads)}, key)
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


def test_drop_connect_draws_come_from_the_dropout_generator():
    model = net_factory("efficient_unet", 4, dtype=torch.float32,
                        encoder_name="efficientnet-b0")
    x = torch.from_numpy(_x())

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, rngs={
                "dropout": torch.Generator().manual_seed(seed)})

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def _trees_equal(a, b):
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("in_channels", [1, 2, 3, 4])
@pytest.mark.parametrize("model_name", ["efficientnet-b0",
                                        "efficientnet-b3"])
def test_converter_matches_the_jax_converter(model_name, in_channels):
    sd = synth_state_dict(model_name, np.random.RandomState(0))
    sd = {k: v.numpy() for k, v in sd.items()}
    want = jimport.convert_efficientnet_encoder(sd, model_name, in_channels)
    got = pimport.convert_efficientnet_encoder(sd, model_name, in_channels)
    for g, w in zip(got, want):
        _trees_equal(g, w)


def test_converter_refuses_another_models_file():
    sd = synth_state_dict("efficientnet-b0", np.random.RandomState(0))
    with pytest.raises(ValueError, match="blocks"):
        pimport.convert_efficientnet_encoder(sd, "efficientnet-b3")
    del sd["_blocks.3._bn1.running_var"]
    with pytest.raises(KeyError):
        pimport.convert_efficientnet_encoder(sd, "efficientnet-b0")


def _convert(tmp_path, model_name):
    """(the port command's file, the JAX script's file) of one synthesized
    .pth."""
    pth = str(tmp_path / "enc.pth")
    torch.save(synth_state_dict(model_name, np.random.RandomState(0)), pth)
    port_file = str(tmp_path / "port.msgpack")
    cli.main(["convert_torch_weights", "--torch_ckpt", pth, "--model_name",
              model_name, "--out", port_file])
    sd = {k: v.numpy() for k, v in torch.load(pth, weights_only=True).items()}
    params, stats = jimport.convert_efficientnet_encoder(sd, model_name, 1)
    jax_file = str(tmp_path / "jax.msgpack")
    jax_save(jax_file, {"encoder_params": params,
                        "encoder_batch_stats": stats,
                        "in_channels": np.int32(1)})
    return port_file, jax_file


def test_convert_command_writes_the_jax_scripts_file(tmp_path):
    port_file, jax_file = _convert(tmp_path, "efficientnet-b0")
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    payload = load_jax_checkpoint(jax_file)
    assert int(payload["in_channels"]) == 1
    _trees_equal(payload["encoder_params"],
                 serialization.msgpack_restore(
                     open(port_file, "rb").read())["encoder_params"])


def test_one_file_gives_the_same_logits_in_both_packages(tmp_path):
    """The port's converted file merged by the JAX package
    (merge_encoder_subtrees, as its train command does) and loaded by the
    port (load_encoder_weights, as --encoder_weights does) into the same
    EffiUNet-b0: eval logits to 1e-5."""
    port_file, _ = _convert(tmp_path, "efficientnet-b0")
    v = _variables()
    payload = jax_load(port_file)
    merged = jimport.merge_encoder_subtrees(
        v, payload["encoder_params"], payload["encoder_batch_stats"])
    jm = _jax_model()
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        merged, jnp.asarray(_x()))
    tm = _port_model(v)
    mine = load_jax_checkpoint(port_file)
    pimport.load_encoder_weights(tm, mine["encoder_params"],
                                 mine["encoder_batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(_x()), train=False)
    assert _rel(got, want) <= EVAL_RTOL
    # every encoder entry came from the file
    enc = {k: t for k, t in tm.state_dict().items()
           if k.startswith("efficient_net_encoder.")}
    merged_sd = from_flax(merged, tm.flax_key)
    assert all(torch.equal(t, merged_sd[k]) for k, t in enc.items())
    assert not torch.equal(enc["efficient_net_encoder.0.conv.0.kernel"],
                           from_flax(v, tm.flax_key)[
                               "efficient_net_encoder.0.conv.0.kernel"])


def test_load_encoder_weights_checks_shapes(tmp_path):
    port_file, _ = _convert(tmp_path, "efficientnet-b0")
    mine = load_jax_checkpoint(port_file)
    b3 = net_factory("efficient_unet", 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="shape"):
        pimport.load_encoder_weights(b3, mine["encoder_params"],
                                     mine["encoder_batch_stats"])
    params = dict(mine["encoder_params"])
    params["MBConv_99"] = params["MBConv_0"]
    b0 = net_factory("efficient_unet", 4, dtype=torch.float32,
                     encoder_name="efficientnet-b0")
    with pytest.raises(ValueError, match="no target"):
        pimport.load_encoder_weights(b0, params, mine["encoder_batch_stats"])


def test_load_pretrained_encoder_matches_the_jax_package():
    """The flax-tree route (load_pretrained_encoder on an EffiUNet's
    variables) gives the JAX package's merged tree."""
    sd = synth_state_dict("efficientnet-b0", np.random.RandomState(0))
    sd = {k: v.numpy() for k, v in sd.items()}
    v = _variables()
    want = jimport.load_pretrained_encoder(v, sd, "efficientnet-b0")
    got = pimport.load_pretrained_encoder(v, sd, "efficientnet-b0")
    _trees_equal(got["params"], want["params"])
    _trees_equal(got["batch_stats"], want["batch_stats"])


def test_train_command_starts_from_encoder_weights(tmp_path):
    """--encoder_weights through the train command's config: the b3
    efficient_unet of make_model_and_state holds the file's encoder; other
    models ignore it, as the JAX package's do."""
    port_file, _ = _convert(tmp_path, "efficientnet-b3")
    args = cli.build_parser({}).parse_args([
        "--model", "efficient_unet", "--encoder_weights", port_file,
        "--device", "cpu", "--compute_dtype", "float32"])
    cfg = cli.config_from_args(args, "fully_supervised")
    assert cfg.encoder_weights == port_file
    model, _ = make_model_and_state(cfg)
    stem = model.state_dict()["efficient_net_encoder.0.conv.0.kernel"]
    payload = load_jax_checkpoint(port_file)
    np.testing.assert_array_equal(
        stem.numpy(), payload["encoder_params"]["Conv_0"]["kernel"])
    fresh, _ = make_model_and_state(TrainConfig(
        model="efficient_unet", device="cpu", compute_dtype="float32"))
    assert not torch.equal(
        fresh.state_dict()["efficient_net_encoder.0.conv.0.kernel"], stem)
    unet, _ = make_model_and_state(TrainConfig(
        model="unet", device="cpu", encoder_weights=port_file))
    assert "encoder.blocks.0.conv1.kernel" in unet.state_dict()


def test_jax_inference_checkpoint_loads(tmp_path):
    """The JAX package's inference checkpoint of an EffiUNet-b0 loads
    through the port's load_model_checkpoint (the test command's reader):
    the step, and the eval logits within 1e-5 of the largest."""
    import types

    from wsl4mis_tpu.utils.checkpoint import save_model_checkpoint
    from wsl4mis_torch.utils.checkpoint import load_model_checkpoint

    v = _variables()
    path = str(tmp_path / "efficient_unet_best_model.pth")
    save_model_checkpoint(path, types.SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], step=3,
        extra=None))
    port = net_factory("efficient_unet", 4, dtype=torch.float32,
                       encoder_name="efficientnet-b0")
    assert load_model_checkpoint(path, port) == 3
    want = _jax_eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_x()), train=False)
    assert _rel(got, want) <= EVAL_RTOL
