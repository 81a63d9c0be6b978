"""Data parallelism (``wsl4mis_torch.parallel``) on the CPU: gloo process
groups of W = 2 and W = 4 processes against one process at the global
batch, and against the JAX package's step on its 8-device CPU mesh.

* All 17 methods, 64x64 planes, narrow models (UNet features 4..16,
  ScribbleVC base 8, embed 32, 2 heads), batch 8 (the semi family 4
  labeled + 4 unlabeled, each part sharded on its own), f32, 2 steps:
  chip_smoke's phase-8 worker (``chip_smoke.dp_group``) runs one group a
  world size in a module fixture, rank 0 first running every method with
  no group. The draws are the methods' own (not injected): each rank
  draws its rows of the global batch's draws. Each step is held to the
  single-process step from the same state, with tests/test_sharding.py's
  tolerances (chip_smoke.dp_compare: parameters and extra state 1e-4 under
  SGD, 3e-4 for deep_adversarial, 1.2e-3 for scribblevc; the loss 1e-4
  relative; the class memory 5e-2 under a 0.5 gate-flip ceiling; the
  memory's gate metrics exactly; BN running statistics 1e-4 of the
  layer's second moment; the step's change of each first optimizer
  moment, SGD's momentum and Adam's mu, DAN's discriminator's too, within
  1e-2 in norm of the single process's, 3e-2 for scribblevc:
  chip_smoke.dp_moments), and the ranks' states are bit-equal after
  every step.
* fully_supervised, dmpls and mean_teacher at W = 2 against the JAX step
  on the 8-device mesh (``wsl4mis_tpu.parallel.mesh``): the same numpy
  batch, the JAX init's weights carried over (``utils.params``), the
  draws injected (no augmentation, no ConvBlock dropout, DMPLS's beta and
  channel masks, the teacher's noise; each rank takes its rows), one
  step; tests/test_torch_train_step.py's one-step tolerances.
* ``shard_batch`` and the per-part rule raise where the JAX mesh's
  shard_batch raises; the train command with ``--device cpu
  --num_devices 2`` trains and only rank 0 writes.
"""

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import wsl4mis_tpu.engine.methods.common as jcommon  # noqa: E402
import wsl4mis_tpu.engine.methods.mean_teacher as jmt  # noqa: E402
import wsl4mis_tpu.models.unet as junet  # noqa: E402
from wsl4mis_tpu.engine.config import TrainConfig as JaxConfig  # noqa: E402
from wsl4mis_tpu.engine.methods import get_method as jax_method  # noqa: E402
from wsl4mis_tpu.engine.methods.common import split_rngs as jax_split  # noqa: E402
from wsl4mis_tpu.engine.optim import reference_sgd  # noqa: E402
from wsl4mis_tpu.engine.state import TrainState as JaxState  # noqa: E402
from wsl4mis_tpu.parallel import mesh as jmesh  # noqa: E402
from wsl4mis_torch import parallel  # noqa: E402
from wsl4mis_torch.engine.methods import available_methods  # noqa: E402
from wsl4mis_torch.utils.params import from_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, LBS = 64, 8, 4
WORLDS = (2, 4)
METHODS = sorted(available_methods())
FEATURES = (4, 8, 8, 16, 16)
NO_DROPOUT = (0.0,) * 5
WIDTHS = {"features": FEATURES,
          "scribblevc": dict(base_channel=8, embed_dim=32, num_heads=2)}
JAX_METHODS = ("fully_supervised", "dmpls", "mean_teacher")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{W: the ranks' outputs} of one gloo group a world size running every
    method (chip_smoke.dp_rank; rank 0 with the single-process runs), the
    groups side by side."""
    cells = [chip_smoke.dp_cell(m, B) for m in METHODS]
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(
            chip_smoke.dp_group, w, cells, "cpu",
            str(tmp_path_factory.mktemp(f"w{w}")), hw=HW, widths=WIDTHS,
            keep_states=True) for w in WORLDS}
        return {w: r.result() for w, r in runs.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", METHODS)
def test_step_equals_the_single_process_step(groups, method, world):
    outs = groups[world]
    runs = [o["cells"][method] for o in outs]
    r0 = runs[0]
    assert r0["fails"] == [], r0["fails"][:10]
    assert r0["diff"]["loss_rel"] < chip_smoke.DP_LOSS_RTOL
    assert len(r0["losses"]) == chip_smoke.DP_STEPS
    # every rank's state the same, bit for bit, after each step
    assert len({tuple(r["digests"]) for r in runs}) == 1
    # the final states, rank 0's against the single process's, and the
    # ranks' against each other
    _, fails = chip_smoke.dp_compare(method, outs[0]["states"][method],
                                     outs[0]["reference"][method],
                                     outs[0]["params"][method])
    assert fails == [], fails[:10]
    for o in outs[1:]:
        for k, v in o["states"][method].items():
            u = outs[0]["states"][method][k]
            assert (torch.equal(u, v) if isinstance(v, torch.Tensor)
                    else u == v), k


def test_s2l_buffer_and_scribblevc_memory_are_shared(groups):
    """S2L's weight buffer (after its refresh sweep) and ScribbleVC's class
    memory (its gate open: initialized 1, both branches taken) are
    bit-equal on every rank, and the memory moved from zero."""
    for outs in groups.values():
        for method, keys in (("s2l", ("/extra/weight",)),
                             ("scribblevc", ("/extra/class_memory/hist_conv",
                                             "/extra/class_memory/hist_tran",
                                             "/extra/class_memory/"
                                             "initialized"))):
            ref = outs[0]["reference"][method]
            for k in keys:
                for o in outs:
                    assert torch.equal(o["states"][method][k],
                                       outs[0]["states"][method][k]), k
                assert float(ref[k].abs().max()) > 0, k
        svc = outs[0]["states"]["scribblevc"]
        assert float(svc["/extra/class_memory/initialized"]) == 1.0
        metrics = outs[0]["cells"]["scribblevc"]["metrics"]
        assert len(metrics["proto_acc_conv"]) == chip_smoke.DP_STEPS


# ---- against the JAX mesh ----------------------------------------------------


def _jax_inputs(method):
    """The JAX step's config, model and patched draws for `method`, the
    global batch, and the draws the port takes ({"beta", "channel_masks",
    "noise"}, global batch rows)."""
    rs = np.random.RandomState(11)
    labels = rs.randint(0, 4, (B, HW, HW)).astype(np.int32)
    sup = "label"
    if method == "dmpls":
        sup = "scribble"
        labels = np.where(rs.rand(B, HW, HW) < 0.2, labels, 4).astype(
            np.int32)
    images = (labels * 0.3 + rs.standard_normal((B, HW, HW)) * 0.1).astype(
        np.float32)
    draws = {}
    if method == "dmpls":
        draws["channel_masks"] = [rs.rand(B, 1, 1, c) < 0.5 for c in FEATURES]
    if method == "mean_teacher":
        noise = rs.standard_normal((B - LBS, HW, HW, 1)) * 0.1
        draws["noise"] = np.clip(noise, -0.2, 0.2).astype(np.float32)
    common = dict(method=method, batch_size=B, labeled_bs=LBS,
                  patch_size=(HW, HW), max_iterations=100,
                  compute_dtype="float32", sup_type=sup,
                  aug_mode="host" if method != "mean_teacher" else "device")
    return common, {"image": images, "label": labels}, draws


def _jax_mesh_step(method, monkeypatch):
    """(initial flax variables, the state after one JAX step on the
    8-device mesh, the batch, the port's draws, the config fields)."""
    common, batch, draws = _jax_inputs(method)
    if method == "dmpls":
        masks = draws["channel_masks"]
        calls = []

        def fixed_channel_dropout(rng, x, rate=0.5):
            keep = jnp.asarray(masks[len(calls) % len(masks)])
            calls.append(x.shape)
            return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)

        monkeypatch.setattr(junet, "channel_dropout", fixed_channel_dropout)
    if method == "mean_teacher":
        monkeypatch.setattr(jcommon, "_augment_impl", lambda: (
            lambda rng, images, labels: (images, labels)))
        monkeypatch.setattr(jmt, "clamped_noise", lambda rng, shape, dtype=(
            jnp.float32): jnp.asarray(draws["noise"]).astype(dtype))
    cls = junet.UNetCCT if method == "dmpls" else junet.UNet
    jmodel = cls(features=FEATURES, dropout=NO_DROPOUT, dtype=jnp.float32)
    key = jax.random.key(0)
    variables = jax.tree.map(np.array, jmodel.init(
        {"params": key, "dropout": key, "feature_perturb": key},
        jnp.zeros((1, HW, HW, 1)), train=False))
    jcfg = JaxConfig(**common)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxState.create(
        apply_fn=jmodel.apply, params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        tx=reference_sgd(jcfg.base_lr, jcfg.max_iterations),
        extra={"ema_params": jax.tree.map(jnp.copy, params)}
        if method == "mean_teacher" else None)
    rng = jax.random.key(100)
    if method == "dmpls":
        draws["beta"] = float(jax.random.uniform(jax_split(rng)["method"])
                              + 1e-10)
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8
    step = jax.jit(jax_method(method).make_step(jcfg))
    jstate, _ = step(jmesh.replicate_tree(mesh, jstate),
                     jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in
                                              batch.items()}), rng)
    return variables, jstate, batch, draws, common


def _port_rank(rank, specs, out):
    """One rank of the port's group (parallel.spawn): each method's step on
    the rank's rows of the batch and of the injected draws, from the JAX
    init's weights; writes its state dict (and EMA parameters)."""
    import wsl4mis_torch.engine.methods.common as tcommon
    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.methods import get_method
    from wsl4mis_torch.engine.methods.common import split_rngs
    from wsl4mis_torch.engine.optim import ReferenceSGD
    from wsl4mis_torch.engine.state import TrainState, ema_copy
    from wsl4mis_torch.models import net_factory
    from wsl4mis_torch.utils.params import load_flax_variables

    tcommon.augment_batch = lambda gen, images, labels: (images, labels)
    mesh = parallel.current_mesh()
    for method, spec in specs.items():
        cfg = TrainConfig(device="cpu", **spec["common"])
        model = net_factory("unet_cct" if method == "dmpls" else "unet", 4,
                            dtype=torch.float32, features=FEATURES,
                            dropout=NO_DROPOUT)
        load_flax_variables(model, spec["variables"])
        state = TrainState(model=model, opt=ReferenceSGD(
            model.parameters(), cfg.base_lr, cfg.max_iterations),
            extra={"ema_params": ema_copy(model)}
            if method == "mean_teacher" else None)
        parts = (LBS, B - LBS) if method == "mean_teacher" else None
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 parallel.shard_batch(mesh, spec["batch"], parts).items()}
        kwargs = {}
        draws = spec["draws"]
        if method == "dmpls":
            kwargs = {"beta": draws["beta"], "channel_masks": [
                parallel.local_rows(torch.from_numpy(m))
                for m in draws["channel_masks"]]}
        if method == "mean_teacher":
            kwargs = {"noise": parallel.local_rows(
                torch.from_numpy(draws["noise"]))}
        get_method(method).make_step(cfg)(state, batch,
                                          split_rngs(0, 0, "cpu"), **kwargs)
        ema = state.extra["ema_params"] if state.extra else {}
        torch.save({"model": model.state_dict(), "ema": ema},
                   os.path.join(out, f"{method}_rank{rank}.pt"))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{method: (the JAX mesh step's state, the port's two ranks' states)}:
    the JAX steps first, then one group of two running all three."""
    out = tmp_path_factory.mktemp("jax")
    states, specs = {}, {}
    for method in JAX_METHODS:
        with pytest.MonkeyPatch.context() as monkeypatch:
            variables, jstate, batch, draws, common = _jax_mesh_step(
                method, monkeypatch)
        states[method] = jstate
        specs[method] = {"common": common, "variables": variables,
                         "batch": batch, "draws": draws}
    parallel.spawn(_port_rank, 2, "cpu", args=(specs, str(out)),
                   init_method="file://" + str(out / "rendezvous"))
    return {m: (states[m], [torch.load(out / f"{m}_rank{r}.pt")
                            for r in (0, 1)]) for m in JAX_METHODS}


@pytest.mark.parametrize("method", JAX_METHODS)
def test_step_equals_the_jax_mesh_step(jax_runs, method):
    jstate, ranks = jax_runs[method]
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    want = from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = ranks[0]["model"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if method == "mean_teacher":
        ema = from_flax(jax.tree.map(np.asarray, jstate.extra["ema_params"]))
        for k, v in ema.items():
            np.testing.assert_allclose(ranks[0]["ema"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# ---- the batch rule, and the train command -----------------------------------


@pytest.mark.parametrize("rows, world, parts, ok", [
    (8, 8, None, True), (16, 8, None, True), (6, 8, None, False),
    (6, 4, None, False), (8, 2, (4, 4), True), (8, 4, (4, 4), True),
    (8, 8, (4, 4), False), (12, 4, (6, 6), False), (8, 2, (2, 6), True),
    (8, 2, (3, 5), False)])
def test_shard_batch_raises_where_the_jax_mesh_does(rows, world, parts, ok):
    """The rank's rows of each part, or ValueError naming the numbers where
    a part does not divide over the ranks; without parts the JAX mesh's
    shard_batch raises on the same batches (for every part alone: each
    part is a batch the student runs on)."""
    batch = {"image": np.arange(rows * 2, dtype=np.float32).reshape(rows, 2),
             "step": np.float32(3)}
    jax_ok = all(p % world == 0 for p in (parts or (rows,)))
    if world == 8:  # the JAX mesh of tests/conftest.py
        for p in parts or (rows,):
            try:
                jmesh.shard_batch(jmesh.make_mesh(),
                                  {"image": np.zeros((p, 2), np.float32)})
            except ValueError:
                jax_ok = False
    assert jax_ok == ok
    if not ok:
        with pytest.raises(ValueError, match=str(world)):
            parallel.shard_batch(parallel.Mesh(0, world), batch, parts)
        return
    got = [parallel.shard_batch(parallel.Mesh(r, world), batch, parts)
           for r in range(world)]
    assert all(g["step"] == 3 for g in got)
    sizes = parts or (rows,)
    want = [np.concatenate([
        batch["image"][sum(sizes[:i]):sum(sizes[:i + 1])][
            r * n // world:(r + 1) * n // world]
        for i, n in enumerate(sizes)]) for r in range(world)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w)


def test_train_command_runs_two_cpu_ranks(tmp_path):
    """`train fully_supervised --device cpu --num_devices 2`: two gloo
    processes take 3 steps at batch 4; rank 0 alone writes the snapshot
    (one log line a logged step), the checkpoints and the validation."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cli import _tree

    root = _tree(tmp_path / "acdc")
    snap = tmp_path / "model"
    cmd = [sys.executable, "-m", "wsl4mis_torch.cli", "train",
           "fully_supervised", "--root_path", root, "--fold", "fold1",
           "--batch_size", "4", "--max_iterations", "3", "--val_every", "3",
           "--ckpt_every", "3", "--patch_size", "[32, 32]",
           "--snapshot_root", str(snap), "--compute_dtype", "float32",
           "--device", "cpu", "--num_devices", "2"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Training Finished!" in out.stdout
    run = snap / "ACDC_fold1" / "label"
    for name in ("iter_3.pth", "latest_full.ckpt", "log.txt"):
        assert (run / name).is_file(), name
    log = (run / "log.txt").read_text()
    assert log.count("iterations per epoch") == 1
    assert log.count("iteration 3 : mean_dice") == 1
    for it in (1, 2, 3):
        assert log.count(f"iteration {it} : total_loss") == 1, log


def test_more_cards_than_visible_raise():
    """No fallback: a CUDA request with no card raises, and so would more
    cards than are visible."""
    with pytest.raises(RuntimeError):
        parallel.visible_cards("cuda", 2)
    assert parallel.visible_cards("cpu", None) == 1
    assert parallel.visible_cards("cpu", 3) == 3
    with pytest.raises(ValueError):
        parallel.visible_cards("cpu", 0)
