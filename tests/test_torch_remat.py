"""ScribbleVC's ``remat`` (checkpointed Conformer stages 2-12: cfg.remat,
``--remat``) in the port, on the CPU in f32, at test_torch_scribblevc.py's
reduced config (depth 12, base 8, embed 32, 2 heads, 64x64, batch 2).

* ``remat=True`` against ``remat=False`` on the same weights and the same
  drop-path generator, in train mode with drop path 0.1 and the memory
  gate open, one backward of a loss over every output: the outputs, every
  parameter's gradient, the BN running statistics and the class memory
  are equal bit for bit. With the recompute's BN statistics left live
  (the statistics folded in twice) they are not.
* The port's ``remat=True`` model against the JAX ``ScribbleVC(remat=
  True)`` on carried weights, drop path 0, in train mode with the memory
  gate open: test_torch_scribblevc.py's tolerances (outputs and memory
  TRAIN_TOL of the largest magnitude, BN statistics rtol 1e-3, atol
  2e-4).
* ``train --remat 1`` and ``train_scribblevc ACDC --remat 1`` parse to the
  JAX parsers' defaults and reach TrainConfig.remat and the bundle's
  model; ``train_scribblevc MSCMR`` refuses the flag, as its JAX script
  has none.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_cli as tcli  # noqa: E402
import test_torch_scribblevc as tsvc  # noqa: E402
import wsl4mis_tpu.cli as jcli  # noqa: E402
import wsl4mis_tpu.models.scribblevc as jmodel  # noqa: E402
import wsl4mis_torch.models.scribblevc as tmodel  # noqa: E402
from wsl4mis_torch import cli  # noqa: E402
from wsl4mis_torch.data import synthetic_slices, synthetic_volumes  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import scribblevc as msvc  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.utils.params import (  # noqa: E402
    from_flax,
    scribblevc_key,
    to_flax_variables,
)

KW = tsvc.KW
B, HW = tsvc.B, tsvc.HW


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(remat, drop_path_rate, seed=4):
    kw = {k: v for k, v in KW.items() if k != "num_classes"}
    kw["drop_path_rate"] = drop_path_rate
    return net_factory("scribblevc", dtype=torch.float32, remat=remat,
                       generator=torch.Generator().manual_seed(seed), **kw)


def _live_memory(model, seed):
    """A stored memory (initialized 1) of random prototypes."""
    rs = np.random.RandomState(seed)
    memory = model.init_memory((HW, HW))
    for k in ("hist_conv", "hist_tran"):
        memory[k].copy_(torch.from_numpy(
            (0.3 * rs.standard_normal(memory[k].shape)).astype(np.float32)))
    memory["initialized"].fill_(1.0)
    return memory


def _loss(out):
    seg_conv, seg_trans, (conv_cls, tran_cls) = out
    return ((seg_conv ** 2).mean() + (seg_trans ** 2).mean()
            + conv_cls.sum() + tran_cls.sum())


def _run(remat, x, seed=4):
    """(outputs, gradients by name, BN statistics, memory) of one
    train-mode forward and backward, drop path 0.1, gate open."""
    model = _model(remat, 0.1, seed)
    memory = _live_memory(model, seed)
    out = model(x, train=True, memory=memory, use_class_rep=True,
                rngs={"dropout": torch.Generator().manual_seed(7)})
    _loss(out).backward()
    seg_conv, seg_trans, (conv_cls, tran_cls) = out
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return ([o.detach() for o in (seg_conv, seg_trans, conv_cls, tran_cls)],
            grads, stats, memory)


def _differing(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("case", ["sound", "statistics twice"])
def test_remat_equals_the_plain_forward(monkeypatch, case):
    x = torch.from_numpy(tsvc._images(3))
    if case == "statistics twice":
        monkeypatch.setattr(tmodel, "_remat_contexts", lambda: (
            tmodel.contextlib.nullcontext(),
            tmodel.contextlib.nullcontext()))
    plain = _run(False, x)
    remat = _run(True, x)
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    assert _differing(plain[1], remat[1]) == []
    assert _differing(plain[3], remat[3]) == []
    stats = _differing(plain[2], remat[2])
    if case == "sound":
        assert stats == []
    else:  # every BN of stages 2-12 folded its batch in twice
        assert len(stats) >= 2 * 11 * 7, len(stats)


def test_remat_draws_the_plain_forwards_masks():
    """The masks passed into the checkpointed stages are the draws the
    plain forward makes, in its order: the generator ends where it does."""
    x = torch.from_numpy(tsvc._images(3))
    ends = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        model = _model(remat, 0.1)
        model(x, train=True, rngs={"dropout": gen})
        ends.append(torch.rand((), generator=gen))
    assert torch.equal(*ends)


def test_remat_matches_the_jax_remat_model():
    """Train mode under autograd (the port's checkpointed path), gate open,
    from a stored memory: outputs, memory and BN statistics within
    test_torch_scribblevc's tolerances of the JAX remat model's. (The
    gradients: remat's are the plain forward's bit for bit, above, and
    those test_torch_scribblevc holds to JAX's step by step.)"""
    jm = jmodel.ScribbleVC(dtype=jnp.float32, remat=True, **KW)
    port = tsvc._port_model()  # the flax tree's shapes, as the port maps it
    shapes = {**to_flax_variables(port),
              "class_memory": port.init_memory((HW, HW))}
    variables, model, memory = tsvc._variables(shapes, 2, random_stats=True)
    model.remat = True
    x = tsvc._images(2)
    out, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, use_class_rep=True, rep_gate=1.0,
        mutable=["batch_stats", "class_memory"]))(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x), train=True, memory=memory,
                use_class_rep=True)
    assert got[0].requires_grad
    errs = [tsvc._rel(g, w) for g, w in zip(tsvc._outputs(got),
                                            tsvc._outputs(out))]
    assert max(errs) <= tsvc.TRAIN_TOL, errs
    for k, v in memory.items():
        assert tsvc._rel(v, np.asarray(mut["class_memory"][k])) <= \
            tsvc.TRAIN_TOL, k
    stats = from_flax({"params": variables["params"],
                       "batch_stats": mut["batch_stats"]}, scribblevc_key)
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(tsvc._np(v), stats[k].numpy(),
                                       rtol=1e-3, atol=2e-4, err_msg=k)


def test_train_parser_takes_remat():
    port = cli.build_parser({})
    assert port.parse_args([]).remat == jcli.build_parser({}).parse_args(
        []).remat == 0
    cfg = cli.config_from_args(port.parse_args(["--remat", "1", "--device",
                                                "cpu"]), "scribblevc")
    assert cfg.remat is True
    assert cli.config_from_args(port.parse_args([]), "unet").remat is False


def test_train_scribblevc_takes_remat_on_acdc_only(monkeypatch):
    assert cli.scribblevc_parser("ACDC").parse_args([]).remat == 0
    rec = tcli._Recorder()
    monkeypatch.setattr(cli, "get_method", rec.get_method)
    monkeypatch.setattr(cli, "Trainer", rec.trainer)
    cli.scribblevc_main(["--remat", "1", "--device", "cpu"], "ACDC")
    cli.scribblevc_main(["--device", "cpu"], "ACDC")
    assert [c.remat for c in rec.cfgs] == [True, False]
    with pytest.raises(SystemExit):
        cli.scribblevc_parser("MSCMR").parse_args(["--remat", "1"])


@pytest.mark.parametrize("remat", [False, True])
def test_bundle_builds_the_model_with_remat(monkeypatch, remat):
    monkeypatch.setattr(msvc, "net_factory", functools.partial(
        net_factory, base_channel=8, embed_dim=32, num_heads=2))
    cfg = TrainConfig(method="scribblevc", device="cpu", batch_size=2,
                      patch_size=(HW, HW), compute_dtype="float32",
                      sup_type="scribble", remat=remat)
    bundle = msvc.make_bundle(
        cfg, synthetic_slices(4, (HW, HW), sup_type="scribble"),
        synthetic_volumes(1, 3, 40, 48))
    assert bundle.model.remat is remat
