"""The rest of the JAX package's public surface in the port, against the
JAX package on the CPU.

* Surface parity: every name in a ``wsl4mis_tpu`` sub-package's
  ``__all__``, every lazy top-level name and every public top-level
  function, class and constant of each JAX module resolves in the port's
  counterpart, unless TPU_ONLY lists it (TPU lowerings, their selectors
  and flax layout helpers; ROADMAP). The JAX sources are read with
  ``ast``.
* ``test_scribblevc ACDC --checkpoints`` scores HD95 / ASD at
  (10, 1, 1), as scripts/test_scribblevc_multi.py does: JAX's
  calculate_metric_percase_spacing at that spacing over the port's own
  predictions, to 1e-12.
* AverageMeter gives the same floats; save_checkpoint writes the JAX
  package's bytes and either package's load_checkpoint reads the other's
  file, with and without a target; a key the target lacks or adds raises.
* test_single_volume (a narrow f32 UNet from the JAX package's variables,
  a 3-slice 64x64 volume): the predictions agree with JAX's on at least
  99.9% of the voxels, the metrics are JAX's metric_fn's on the same
  prediction to 1e-12.
* init_model gives JAX's keys, shapes and dtypes for every net_factory
  name; apply_model in eval mode on JAX's variables JAX's logits to 1e-5.
* VNet with each normalization from JAX's variables, 16 filters, 2x32^3
  (at 16^3 JAX against itself moves VNet's train-mode logits by 3.5e-2):
  eval logits to 1e-5, train-mode logits to 1e-4, each parameter gradient
  to 5e-2 in norm (tests/test_torch_nets3d.py's tolerances).
* prepare_random_walker writes the random_walker arrays of JAX's
  prepare_random_walker_tree; collect_matrix prints the text of
  scripts/collect_matrix.py on the port Trainer's logs.
"""

import ast
import contextlib
import functools
import importlib
import io
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import wsl4mis_torch  # noqa: E402
from wsl4mis_tpu.data import random_walker as jrw  # noqa: E402
from wsl4mis_tpu.eval import metrics as jmetrics  # noqa: E402
from wsl4mis_tpu.eval import val2d as jval2d  # noqa: E402
from wsl4mis_tpu.models import factory as jfactory  # noqa: E402
from wsl4mis_tpu.models import nets3d as jnets  # noqa: E402
from wsl4mis_tpu.utils import checkpoint as jck  # noqa: E402
from wsl4mis_tpu.utils import logging_utils as jlog  # noqa: E402
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.data import synthetic_slices, synthetic_volumes  # noqa: E402
from wsl4mis_torch.data.acdc import AcdcVolumeDataset, maag_test_ids  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import (  # noqa: E402
    MethodBundle,
    make_model_and_state,
    stage_dataset,
    train_batches,
)
from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision  # noqa: E402
from wsl4mis_torch.engine.trainer import Trainer  # noqa: E402
from wsl4mis_torch.eval import infer  # noqa: E402
from wsl4mis_torch.eval import val2d as tval2d  # noqa: E402
from wsl4mis_torch.models import apply_model, init_model, net_factory  # noqa: E402
from wsl4mis_torch.models import nets3d  # noqa: E402
from wsl4mis_torch.models.nets3d import VNet  # noqa: E402
from wsl4mis_torch.utils import checkpoint as tck  # noqa: E402
from wsl4mis_torch.utils.logging_utils import AverageMeter  # noqa: E402
from wsl4mis_torch.utils.params import (  # noqa: E402
    from_flax,
    load_flax_variables,
    to_flax_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "wsl4mis_tpu")
NARROW = (4, 8, 8, 16, 16)  # UNet features
SVC_NARROW = dict(base_channel=8, embed_dim=32, num_heads=2)
AGREE = 0.999
EVAL_RTOL = 1e-5
TRAIN_TOL = 1e-4
GRAD_TOL = 5e-2
ZERO_GRAD = 1e-5

# JAX file -> its public names with no port counterpart (None: every
# name), each a TPU lowering, its selector or a flax layout helper
TPU_ONLY = {
    # the TPU lowerings of the one 3x3 conv and 2x2 pool, and the
    # Pallas kernels' package (each kernel has a CUDA counterpart)
    "ops/banded_conv.py": None,
    "ops/pallas/__init__.py": None,
    "ops/pallas/augment_pallas.py": None,
    "ops/pallas/banded_conv_pallas.py": None,
    "ops/pallas/gated_crf_pallas.py": None,
    "ops/pallas/maxpool_pallas.py": None,
    "ops/maxpool.py": {"max_pool_2x2_flat", "max_pool_2x2_v2",
                       "max_pool_2x2_v3"},
    # lowering selectors
    "ops/gated_crf.py": {"select_gated_crf"},
    "data/augment_device.py": {"select_augment"},
    # flax layout helpers: wrapper scopes the port folds into one module
    "models/unet.py": {"TorchConv", "TorchConvTranspose", "batch_norm",
                       "block_emits_flat", "chain_ok", "DecoderURDS"},
    "models/nets3d.py": {"Conv3"},
    "models/pnet.py": {"DilatedConv"},
    "models/scribblevc.py": {"BN"},
    # NamedShardings: a process group places rows with shard_batch
    "parallel/mesh.py": {"batch_sharding", "replicated_sharding",
                         "DATA_AXIS"},
    "parallel/__init__.py": {"batch_sharding", "replicated_sharding"},
    # flax mutable plumbing and a jnp ramp (ops/ramps has the ramp)
    "engine/methods/common.py": {"forward_train", "sigmoid_rampup_jnp"},
}
TYPE_ALIASES = {"Dtype"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_files():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), JAX_PKG))
    return sorted(out)


def _port_module(rel):
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts.pop()
    return importlib.import_module(".".join(["wsl4mis_torch", *parts]))


def _tree(rel):
    with open(os.path.join(JAX_PKG, rel)) as f:
        return ast.parse(f.read())


def _missing(rel, names):
    skip = TPU_ONLY.get(rel, set())
    if rel in TPU_ONLY and skip is None:
        return []
    port = _port_module(rel)
    return sorted(n for n in names if n not in skip and n not in TYPE_ALIASES
                  and not hasattr(port, n))


INITS = [f for f in _jax_files() if f.endswith("__init__.py")]
MODULES = [f for f in _jax_files() if not f.endswith("__init__.py")]


@pytest.mark.parametrize("rel", INITS)
def test_every_exported_name_resolves_in_the_port(rel):
    """A package's __all__, and at the top the lazy names of its
    __getattr__ (``if name == "X"``)."""
    names = set()
    for node in _tree(rel).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= set(ast.literal_eval(node.value))
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.comparators[0].value for c in ast.walk(node)
                      if isinstance(c, ast.Compare)
                      and isinstance(c.comparators[0], ast.Constant)}
    if rel == "__init__.py":
        assert names == {"TrainConfig", "Trainer", "get_method",
                         "net_factory"}
    assert _missing(rel, names) == []


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_module_name_resolves_in_the_port(rel):
    names = set()
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    names = {n for n in names if not n.startswith("_")}
    assert _missing(rel, names) == []


def test_top_level_names_are_lazy():
    """The package's import loads no engine or model module; each lazy
    name is the sub-module's object."""
    code = ("import sys, wsl4mis_torch as w\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'wsl4mis_torch.') and m.split('.')[1] in ('engine', 'models', "
            "'ops')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    from wsl4mis_torch.engine.config import TrainConfig as Config
    from wsl4mis_torch.engine.methods import get_method as gm

    assert wsl4mis_torch.TrainConfig is Config
    assert wsl4mis_torch.Trainer is Trainer
    assert wsl4mis_torch.get_method is gm
    assert wsl4mis_torch.net_factory is net_factory
    with pytest.raises(AttributeError):
        wsl4mis_torch.no_such_name


# ---- test_scribblevc --checkpoints at the multi script's spacing ------------


def _write_volumes(root, cases, seed):
    os.makedirs(os.path.join(root, "ACDC_training_volumes"), exist_ok=True)
    vols = synthetic_volumes(len(cases), 2, 40, 48, seed=seed)
    for case, vol in zip(cases, vols):
        with h5py.File(os.path.join(root, "ACDC_training_volumes",
                                    f"{case}_frame01.h5"), "w") as f:
            f["image"] = vol["image"]
            f["label"] = vol["label"].astype(np.uint8)


def test_checkpoints_flag_scores_at_the_multi_scripts_spacing(
        tmp_path, monkeypatch, capsys):
    """Two of MAAG's test patients, a narrow ScribbleVC saved with and
    without its memory; the command's metrics against JAX's metric at
    (10, 1, 1) over the select rule's predictions of each checkpoint."""
    monkeypatch.setattr(infer, "net_factory",
                        functools.partial(net_factory, **SVC_NARROW))
    monkeypatch.setattr(infer, "VolumePredictor", functools.partial(
        tval2d.VolumePredictor, bucket=2, chunk=4))
    root = str(tmp_path / "acdc")
    _write_volumes(root, maag_test_ids()[:2], seed=3)
    snapshot = tmp_path / "model" / "ACDC_ScribbleVC_MAAGfold" / "scribble"
    model = net_factory("scribblevc", 4, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0),
                        **SVC_NARROW)
    memory = {k: v + 1 for k, v in model.init_memory((256, 256)).items()}
    for name, extra in (("with.pth", {"class_memory": memory}),
                        ("without.pth", {})):
        state = type("S", (), {"model": model, "step": 1, "extra": extra})
        tck.save_model_checkpoint(str(snapshot / name), state,
                                  eval_extra=tuple(extra))
    out = cli.scribblevc_test_main(
        [f"--root_path={root}", f"--snapshot_root={tmp_path / 'model'}",
         "--device=cpu", "--compute_dtype=float32", "--checkpoints",
         "with.pth", "gone.pth", "without.pth"], "ACDC")
    assert list(out) == ["with.pth", "without.pth"]
    assert "gone.pth MISSING" in capsys.readouterr().out
    volumes = list(AcdcVolumeDataset(base_dir=root,
                                     custom_patients=maag_test_ids()))
    for name in out:
        loaded, mem = infer.load_scribblevc(str(snapshot / name), 4,
                                            "float32", "cpu")
        preds = tval2d.VolumePredictor(
            loaded, (256, 256), device="cpu", bucket=2, chunk=4,
            decision_fn=mean_softmax_decision,
            forward_kwargs={"use_class_rep": False}).predict_volumes(
            [v["image"] for v in volumes], {"memory": mem})
        want = np.mean([[jmetrics.calculate_metric_percase_spacing(
            p == i, v["label"] == i, (10.0, 1.0, 1.0)) for i in range(1, 4)]
            for p, v in zip(preds, volumes)], axis=0)
        assert want[:, 1].max() > 0  # distances, so the spacing shows
        np.testing.assert_allclose(out[name], want, rtol=0, atol=1e-12)


# ---- AverageMeter and the pytree checkpoints --------------------------------


def test_average_meter_gives_the_jax_floats():
    calls = [("add", {"loss": 0.1, "dice": np.float32(0.3)}),
             ("add", {"loss": torch.tensor(0.7).item(), "dice": 2}),
             ("get", "loss"), ("add", {"loss": 1e-9}), ("pop", "dice"),
             ("add", {"dice": 5.5}), ("get", "dice"), ("pop", "loss")]
    results = []
    for meter in (jlog.AverageMeter(), AverageMeter()):
        seen = []
        for op, arg in calls:
            seen.append(meter.add(**arg) if op == "add"
                        else getattr(meter, op)(arg))
        results.append((seen, meter.sums, meter.counts))
    assert results[0] == results[1]
    assert all(type(v) is float for v in results[1][0] if v is not None)
    assert type(results[1][2]["dice"]) is int


def _trees(seed=0):
    """The same tree for each package: numpy, and tensors (JAX arrays on
    the JAX side) with a bfloat16 leaf."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((3, 5)).astype(np.float32)
    bf = rs.standard_normal((4,)).astype(np.float32)
    bf = np.array(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    common = {"step": np.int32(7), "flags": np.array([True, False]),
              "list": [np.arange(3), 2.5, None], "10": np.float64(1.5),
              "2": np.zeros((0, 2), np.float32)}
    jtree = {"params": {"w": jnp.asarray(x),
                        "bf": jnp.asarray(bf, jnp.bfloat16)}, **common}
    ttree = {"params": {"w": torch.from_numpy(x),
                        "bf": torch.from_numpy(bf).bfloat16()}, **common}
    return jtree, ttree


def test_save_checkpoint_writes_the_jax_bytes(tmp_path):
    jtree, ttree = _trees()
    jck.save_checkpoint(str(tmp_path / "jax.ckpt"), jtree)
    tck.save_checkpoint(str(tmp_path / "port.ckpt"), ttree)
    tck.save_checkpoint(str(tmp_path / "numpy.ckpt"), jax.tree.map(
        np.asarray, {**jtree, "params": {"w": jtree["params"]["w"]}}))
    jck.save_checkpoint(str(tmp_path / "jax_np.ckpt"),
                        {**jtree, "params": {"w": jtree["params"]["w"]}})
    data = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    assert data["jax.ckpt"] == data["port.ckpt"]
    assert data["jax_np.ckpt"] == data["numpy.ckpt"]
    assert not any(p.suffix == ".tmp" for p in tmp_path.iterdir())


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif want is None:
        assert got is None
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    else:
        np.testing.assert_array_equal(np.asarray(got, np.float64),
                                      np.asarray(want, np.float64))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_load_checkpoint_reads_the_others_file(tmp_path, writer):
    jtree, ttree = _trees(1)
    path = str(tmp_path / "c.ckpt")
    if writer == "jax":
        jck.save_checkpoint(path, jtree)
    else:
        tck.save_checkpoint(path, ttree)
    # no target: the nested dicts of msgpack_restore (a list as "0", ...)
    plain_j, plain_t = jck.load_checkpoint(path), tck.load_checkpoint(path)
    assert set(plain_t["list"]) == {"0", "1", "2"}
    _same(plain_t, jax.tree.map(np.asarray, plain_j))
    # a target: its structure, tensor leaves back as tensors of its dtype
    got_t = tck.load_checkpoint(path, ttree)
    _same(got_t, ttree)
    got_j = jck.load_checkpoint(path, jtree)
    _same(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                       got_j["params"]),
          {k: v.float().numpy() for k, v in ttree["params"].items()})


def test_a_key_mismatch_raises(tmp_path):
    """A key the file lacks raises in both packages; one the target lacks
    raises here, where flax's from_bytes drops it."""
    jtree, ttree = _trees(2)
    path = str(tmp_path / "c.ckpt")
    tck.save_checkpoint(path, ttree)
    more = {**ttree, "params": {**ttree["params"], "extra": torch.zeros(1)}}
    with pytest.raises(ValueError):
        tck.load_checkpoint(path, more)
    with pytest.raises(ValueError):
        jck.load_checkpoint(path, {**jtree, "params": {
            **jtree["params"], "extra": jnp.zeros(1)}})
    fewer = {k: v for k, v in ttree.items() if k != "step"}
    with pytest.raises(ValueError):
        tck.load_checkpoint(path, fewer)
    assert "step" not in jck.load_checkpoint(
        path, {k: v for k, v in jtree.items() if k != "step"})
    with pytest.raises(ValueError):
        tck.load_checkpoint(path, {**ttree, "params": {
            **ttree["params"], "w": torch.zeros(2, 2)}})


# ---- test_single_volume, init_model, apply_model ----------------------------


@functools.lru_cache(maxsize=None)
def _unet_variables(name="unet"):
    """A narrow f32 JAX model of the UNet family and variables for it:
    the port's init_model of the same model (so JAX's apply_model takes
    the port's trees), the BN running statistics moved by a seeded draw."""
    jm = jfactory._REGISTRY[name](num_classes=4, features=NARROW,
                                  dtype=jnp.float32)
    v = init_model(net_factory(name, 4, dtype=torch.float32,
                               features=NARROW),
                   torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + rs.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return jm, v


def test_single_volume_matches_the_jax_function():
    jm, v = _unet_variables()
    vol = synthetic_volumes(1, 3, 64, 64, seed=4)[0]
    port = net_factory("unet", 4, dtype=torch.float32, features=NARROW)
    load_flax_variables(port, v)
    jpred = jval2d.VolumePredictor(jm, (64, 64)).predict_volume(
        v, vol["image"])
    tpred = tval2d.VolumePredictor(port, (64, 64), device="cpu"
                                   ).predict_volume(vol["image"])
    assert (tpred == jpred).mean() >= AGREE
    got = tval2d.test_single_volume(vol["image"], vol["label"],
                                    tval2d.VolumePredictor(
                                        port, (64, 64), device="cpu"), 4)
    want = [jmetrics.calculate_metric_percase(tpred == i, vol["label"] == i)
            for i in range(1, 4)]
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-12)
    # evaluate_fold's per-volume result is the same
    np.testing.assert_array_equal(tval2d.evaluate_fold(
        tval2d.VolumePredictor(port, (64, 64), device="cpu"), [vol], 4),
        np.asarray(got, np.float64))


def _leaves(tree):
    return {"/".join(map(str, (getattr(k, "key", k) for k in path))):
            (tuple(np.shape(x)), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", sorted(jfactory._REGISTRY))
def test_init_model_gives_the_jax_trees(name):
    """Keys, shapes and dtypes of every collection at the published
    widths (JAX's by eval_shape)."""
    jm = jfactory.net_factory(name, 4, dtype=jnp.float32)
    want = jax.eval_shape(lambda: jfactory.init_model(
        jm, jax.random.key(0), (1, 64, 64, 1)))
    model = net_factory(name, 4, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = init_model(model, torch.Generator().manual_seed(1))
    assert set(got) == set(want) == {"params", "batch_stats"}
    for c in got:
        assert _leaves(got[c]) == _leaves(want[c]), c
    # drawn anew, in place, from the generator: the same draws again
    state = {k: v.clone() for k, v in model.state_dict().items()}
    assert any(not torch.equal(state[k], before[k]) for k in state)
    init_model(model, torch.Generator().manual_seed(1))
    assert all(torch.equal(model.state_dict()[k], state[k]) for k in state)


def test_init_model_needs_a_factory_model():
    with pytest.raises(TypeError):
        init_model(VNet(2, 4, dtype=torch.float32))


@pytest.mark.parametrize("name", ["unet", "unet_cct", "unet_ds"])
def test_apply_model_eval_matches_jax(name):
    jm, v = _unet_variables(name)
    x = np.random.RandomState(5).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jfactory.apply_model(jm, v, x, train=False)
                   )(v, jnp.asarray(x))
    port = net_factory(name, 4, dtype=torch.float32, features=NARROW)
    with torch.no_grad():
        got = apply_model(port, v, torch.from_numpy(x), train=False)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= EVAL_RTOL * np.abs(w).max()


def test_apply_model_train_returns_the_updated_batch_stats():
    """train=True: (outputs, {"batch_stats"}), the statistics the module's
    own train forward leaves, from the same dropout draws."""
    _, v = _unet_variables()
    x = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (2, 64, 64, 1)).astype(np.float32))
    own = net_factory("unet", 4, dtype=torch.float32, features=NARROW)
    load_flax_variables(own, v)
    want = own(x, train=True,
               rngs={"dropout": torch.Generator().manual_seed(7)})
    port = net_factory("unet", 4, dtype=torch.float32, features=NARROW)
    got, stats = apply_model(port, v, x, train=True,
                             generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, want) and set(stats) == {"batch_stats"}
    named = from_flax(stats)
    assert named and all(torch.equal(t, own.state_dict()[k])
                         for k, t in named.items())
    moved = from_flax({"batch_stats": v["batch_stats"]})
    assert not any(torch.equal(t, moved[k]) for k, t in named.items())


# ---- VNet's normalizations --------------------------------------------------


def _vnet_f64(model, x, monkeypatch):
    """The instance-norm VNet `model`'s eval logits computed in f64 (its
    f32 parameters, every conv and instance norm in f64)."""
    def instance_norm64(z, eps=1e-5):
        dims = tuple(range(1, z.ndim - 1))
        var, mean = torch.var_mean(z, dim=dims, keepdim=True, correction=0)
        return (z - mean) * torch.rsqrt(var + eps)

    monkeypatch.setattr(nets3d, "instance_norm", instance_norm64)
    exact = VNet(2, normalization="instancenorm", dtype=torch.float64)
    exact.load_state_dict(model.state_dict())
    with torch.no_grad():
        return exact(torch.from_numpy(x).double(), train=False).numpy()


@pytest.mark.parametrize("norm", ["batchnorm", "groupnorm", "instancenorm",
                                  "none"])
def test_vnet_normalization_matches(norm, monkeypatch):
    """The variables are the port's (to_flax_variables: GroupNorm_k both
    ways), the BN running statistics moved by a seeded draw. Without a
    normalization ("none", any other string) the eval logits alone."""
    jm = jnets.VNet(num_classes=2, normalization=norm, dtype=jnp.float32)
    tm = VNet(2, normalization=norm, dtype=torch.float32,
              generator=torch.Generator().manual_seed(0))
    lists = {"batchnorm": {"batch_norm"}, "groupnorm": {"group_norm"}}
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "conv3", "conv_transpose", *lists.get(norm, ())}
    v = to_flax_variables(tm)
    rs = np.random.RandomState(1)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + rs.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    if not v["batch_stats"]:
        del v["batch_stats"]
    load_flax_variables(tm, v)
    x = np.random.RandomState(2).standard_normal((2, 32, 32, 32, 1)).astype(
        np.float32)
    w = np.random.RandomState(4).standard_normal((2, 32, 32, 32, 2)).astype(
        np.float32)
    mutable = ["batch_stats"] if "batch_stats" in v else []

    def both(params):
        def loss(p):
            out, mut = jm.apply({**v, "params": p}, jnp.asarray(x),
                                train=True, turnoff_drop=True,
                                mutable=mutable)
            return jnp.sum(out * w), (out, mut)

        logits = jm.apply({**v, "params": params}, jnp.asarray(x))
        if norm == "none":
            return logits, None
        return logits, jax.value_and_grad(loss, has_aux=True)(params)

    want_eval, train = jax.jit(both)(v["params"])
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), train=False)

    def rel(a, b):
        b = np.asarray(b)
        return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())

    if norm == "instancenorm":
        # its deepest level normalizes 8 voxels a channel: two f32
        # evaluations of this net part by more than 1e-5 (the port 2.2e-5,
        # JAX 1.6e-5 from the f64 one); the port is held to the f64
        # evaluation within three times JAX's distance from it
        exact = _vnet_f64(tm, x, monkeypatch)
        assert rel(got_eval, exact) <= max(EVAL_RTOL,
                                           3 * rel(want_eval, exact))
    else:
        assert rel(got_eval, want_eval) <= EVAL_RTOL
    if train is None:
        return
    (_, (want, mut)), grads = train
    got = tm(torch.from_numpy(x), train=True, turnoff_drop=True)
    (got * torch.from_numpy(w)).sum().backward()
    assert rel(got.detach(), want) <= TRAIN_TOL
    if mutable:
        stats = tm.state_dict()
        for k, val in from_flax({"batch_stats": jax.tree.map(
                np.asarray, mut["batch_stats"])}, tm.flax_key).items():
            assert rel(stats[k], val) <= TRAIN_TOL, k
    want_grads = from_flax({"params": jax.tree.map(np.asarray, grads)},
                           tm.flax_key)
    params = dict(tm.named_parameters())
    assert set(want_grads) == set(params)
    gmax = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for k, g in want_grads.items():
        got_g, g = params[k].grad.numpy(), g.numpy()
        if np.abs(g).max() <= ZERO_GRAD * gmax:
            assert np.abs(got_g).max() <= ZERO_GRAD * gmax, k
            continue
        assert np.linalg.norm(got_g - g) / np.linalg.norm(g) <= GRAD_TOL, k


# ---- the two commands -------------------------------------------------------


def _scribble_tree(root):
    """Two patients of two 32x32 slices: slice files with image and
    scribble (the dense label on ~15% of the pixels, 4 elsewhere),
    volume files with image and label."""
    data = synthetic_slices(4, (32, 32), seed=8)
    keep = np.random.RandomState(8).rand(*data.labels.shape) < 0.15
    scribbles = np.where(keep, data.labels, 4).astype(np.uint8)
    for sub in ("ACDC_training_slices", "ACDC_training_volumes"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for p, case in enumerate(("patient001_frame01", "patient002_frame01")):
        rows = slice(2 * p, 2 * p + 2)
        with h5py.File(os.path.join(root, "ACDC_training_volumes",
                                    f"{case}.h5"), "w") as f:
            f["image"] = data.images[rows]
            f["label"] = data.labels[rows].astype(np.uint8)
        for i in range(2):
            with h5py.File(os.path.join(root, "ACDC_training_slices",
                                        f"{case}_slice_{i}.h5"), "w") as f:
                f["image"] = data.images[2 * p + i]
                f["label"] = data.labels[2 * p + i].astype(np.uint8)
                f["scribble"] = scribbles[2 * p + i]


def _h5_arrays(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            with h5py.File(os.path.join(dirpath, name), "r") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = {
                    k: f[k][()] for k in f}
    return out


@pytest.mark.parametrize("argv, kwargs", [
    ([], {}), (["--limit", "3"], {"limit": 3}),
    (["--cases", "patient002"], {"cases": ["patient002"]})])
def test_prepare_random_walker_writes_the_jax_arrays(tmp_path, capsys, argv,
                                                     kwargs):
    src = str(tmp_path / "src")
    _scribble_tree(src)
    want_n = jrw.prepare_random_walker_tree(src, str(tmp_path / "jax"),
                                            **kwargs)
    cli.main(["prepare_random_walker", "--src", src, "--out",
              str(tmp_path / "port"), *argv])
    port_out = str(tmp_path / "port")
    assert capsys.readouterr().out == f"done: {want_n} slices solved -> " \
        f"{port_out}\n"
    want, got = _h5_arrays(tmp_path / "jax"), _h5_arrays(port_out)
    assert set(got) == set(want)
    assert sum("random_walker" in a for a in got.values()) > 0
    for name, arrays in want.items():
        assert set(got[name]) == set(arrays), name
        for k, a in arrays.items():
            np.testing.assert_array_equal(got[name][k], a)
    args = cli.prepare_random_walker_parser().parse_args([])
    assert (args.src, args.out, args.limit, args.cases) == (
        None, "data/ACDC_rw", None, None)


@pytest.fixture(scope="module")
def matrix_root(tmp_path_factory):
    """A snapshot root of three port Trainer runs (fully_supervised, 4
    steps on the CPU, a validation every 2): ACDC_a on fold1 and fold3,
    ACDC_b on fold2, and a run whose name names no fold."""
    root = str(tmp_path_factory.mktemp("matrix"))
    data = synthetic_slices(4, (32, 32), seed=5)
    for exp, fold, seed in (("ACDC_a", "fold1", 1), ("ACDC_a", "fold3", 2),
                            ("ACDC_b", "fold2", 3), ("ACDC_c", "MAAGfold",
                                                     4)):
        cfg = TrainConfig(method="fully_supervised", device="cpu",
                          batch_size=2, patch_size=(32, 32), max_iterations=4,
                          val_every=2, ckpt_every=4, log_every=2, seed=seed,
                          compute_dtype="float32", snapshot_root=root,
                          exp=exp, fold=fold, sup_type="label")
        model, state = make_model_and_state(cfg)
        bundle = MethodBundle(
            model=model, state=state,
            step_fn=get_method("fully_supervised").make_step(cfg),
            data_iter=train_batches(cfg, data),
            val_volumes=synthetic_volumes(1, 2, 32, 32, seed=seed),
            steps_per_epoch=2, aux=stage_dataset(cfg, data))
        try:
            Trainer(cfg, bundle, use_tensorboard=False).train()
        finally:
            for h in list(logging.getLogger().handlers):
                if isinstance(h, logging.FileHandler):
                    logging.getLogger().removeHandler(h)
                    h.close()
    return root


def test_collect_matrix_prints_the_scripts_text(matrix_root, tmp_path):
    logs = [os.path.join(d, "log.txt") for d, _, f in os.walk(matrix_root)
            if "log.txt" in f]
    assert len(logs) == 4
    printed = []
    for root in (matrix_root, str(tmp_path / "empty")):
        want = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "collect_matrix.py"), root],
            capture_output=True, text=True, timeout=120, check=True).stdout
        got = io.StringIO()
        with contextlib.redirect_stdout(got):
            cli.main(["collect_matrix", root])
        assert got.getvalue() == want
        printed.append(want)
    assert "| ACDC_a |" in printed[0] and "(2/5 folds)" in printed[0]
    assert "ACDC_c" not in printed[0] and printed[1].startswith("no cells")
