"""chip_smoke.py off the card (on the CPU): it refuses to run without CUDA,
the conv and pool shapes and per-step launch counts it holds the card's run
to are those of the port's UNet, UNet_CCT and ScribbleVC training steps
(the semi-supervised ones and ScribbleVC through the bundles it builds),
ScribbleVC's synthetic set opens the memory gate inside its run, its pool
and GatedCRF checks run (plain against plain) at tiny sizes, its kernel
summary lists every kernel with every key, its reference check's
known-wrong variant runs every conv kernel in bf16, its ScribbleVC
card-versus-CPU check runs (CPU against CPU) at a narrow width, and its
entry-points phase (the train command's argv and config, a host-augmented
run with no augment launch, the test command's check of the best
checkpoint) runs with narrow models, from an H5 tree and from memory."""

import copy
import functools
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from wsl4mis_torch.data import (  # noqa: E402
    ArraySliceDataset,
    augment_device,
    synthetic_slices,
    synthetic_volumes,
    zoomed_with_native,
)
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods import s2l as ts2l  # noqa: E402
from wsl4mis_torch.engine.methods import scribblevc as tsvc  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.models.unet import Conv3x3  # noqa: E402
from wsl4mis_torch.ops import augment as taug  # noqa: E402
from wsl4mis_torch.ops import conv3x3 as tconv  # noqa: E402
from wsl4mis_torch.ops import gated_crf as tgcrf  # noqa: E402
from wsl4mis_torch.ops import maxpool as tpool  # noqa: E402
from wsl4mis_torch.utils import checkpoint as tck  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on a few cores, where torch's oversubscribed thread pools made
    its CPU steps tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_and_prints_nothing_without_a_card(tmp_path, alone):
    """In the repo and as a lone copy, with no card visible: no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_conv_shapes_are_the_unets():
    """unet_convs() lists the full-width UNet's 19 convs in module order,
    with their input channels, output channels and spatial size."""
    model = net_factory("unet", 4, dtype=torch.float32)
    got = [tuple(m.kernel.shape[2:]) for m in model.modules()
           if isinstance(m, Conv3x3)]
    want = chip_smoke.unet_convs()
    assert [(c, o) for _, c, o, _ in want] == got
    sizes = {n: h for n, _, _, h in want}
    assert sizes["enc0.conv1"] == sizes["head"] == chip_smoke.HW
    assert sizes["enc4.conv2"] == chip_smoke.HW // 16


def test_pool_shapes_are_the_unets(monkeypatch):
    """unet_pools() lists the full-width encoder's four pool inputs: their
    channels, and their sizes scaled from a 32x32 forward to 256x256."""
    seen = []
    fwd = tpool.max_pool_2x2_fwd
    monkeypatch.setattr(tpool, "max_pool_2x2_fwd",
                        lambda x: seen.append(tuple(x.shape)) or fwd(x))
    model = net_factory("unet", 4, dtype=torch.float32)
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 1)), train=False)
    scale = chip_smoke.HW // 32
    assert [(c, h * scale) for _, h, _, c in seen] == \
        [(c, h) for _, c, h in chip_smoke.unet_pools()]


def _count_wrapper_calls(monkeypatch, calls):
    """Patch every kernel wrapper to count its calls into `calls` (on the
    card each call is one launch of its kernel)."""
    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in ("conv3x3_fwd", "conv3x3_fwd_stats", "conv3x3_wgrad"):
        monkeypatch.setattr(tconv, name, counted(name, getattr(tconv, name)))
    monkeypatch.setattr(augment_device._augment, "augment_batch",
                        counted("augment", taug.augment_batch))
    monkeypatch.setattr(ts2l, "augment_batch_s2l",
                        counted("augment_s2l",
                                augment_device.augment_batch_s2l))
    for name in ("maxpool_fwd", "maxpool_bwd"):
        fn = "max_pool_2x2_" + name[-3:]
        monkeypatch.setattr(tpool, fn, counted(name, getattr(tpool, fn)))
    monkeypatch.setattr(tgcrf, "gated_crf_products",
                        counted("gated_crf", tgcrf.gated_crf_products))


@pytest.mark.parametrize("method,model_name", [
    ("fully_supervised", "unet"), ("dmpls", "unet_cct"),
    ("pce_gatedcrf", "unet"), ("pce_tv", "unet"),
    ("mean_teacher", "unet"), ("uamt", "unet"),
    ("entropy_minimization", "unet"), ("partially_supervised", "unet"),
    ("deep_adversarial", "unet"), ("ustm", "unet")])
def test_per_step_counts_match_one_step(monkeypatch, method, model_name):
    """One train step on the CPU, counting the calls that reach each
    wrapper (on the card each is one launch): chip_smoke's expected
    per-step counts. The semi-supervised methods and ustm step through
    chip_smoke.method_bundle (full width at 32x32, batch 4, labeled_bs 2;
    the semi family on a paired index batch over a staged stack)."""
    calls = {k: 0 for k in chip_smoke.per_step_counts(model_name, method)}
    _count_wrapper_calls(monkeypatch, calls)
    if method in chip_smoke.STEP_PASSES:
        cfg = TrainConfig(method=method, device="cpu", batch_size=4,
                          labeled_bs=2, patch_size=(32, 32),
                          compute_dtype="float32")
        data = (synthetic_slices(4, (32, 32), seed=1),
                synthetic_slices(6, (32, 32), seed=2))
        if method == "ustm":
            data = synthetic_slices(6, (32, 32), seed=3, sup_type="scribble")
        bundle, _ = chip_smoke.method_bundle(cfg, data, None)
        batch = next(bundle.data_iter)
        bundle.step_fn(bundle.state, batch, split_rngs(0, 0, "cpu"),
                       bundle.aux)
        if method in chip_smoke.SEMI:
            assert (batch["index"][:2] < 4).all()
            assert (batch["index"][2:] >= 4).all()
    else:
        cfg = TrainConfig(method=method, device="cpu", batch_size=2,
                          compute_dtype="float32")
        model = net_factory(model_name, 4, dtype=torch.float32,
                            features=(4, 8, 8, 16, 16))
        state = TrainState(model=model, opt=ReferenceSGD(
            model.parameters(), cfg.base_lr, cfg.max_iterations))
        rs = np.random.RandomState(0)
        staged = {"images": torch.from_numpy(
            rs.standard_normal((4, 32, 32)).astype(np.float32)),
            "labels": torch.from_numpy(rs.randint(0, 5, (4, 32, 32)).astype(
                np.uint8))}
        get_method(method).make_step(cfg)(
            state, {"index": np.array([0, 2], np.int32)},
            split_rngs(0, 0, "cpu"), staged)
    assert calls == chip_smoke.per_step_counts(model_name, method)
    assert calls["gated_crf"] == (method == "pce_gatedcrf")
    fwd, bwd, evl = chip_smoke.STEP_PASSES.get(method, (1, 1, 0))
    assert calls["maxpool_fwd"] == 4 * (fwd + evl)
    assert calls["maxpool_bwd"] == 4 * bwd


def _s2l_bundle(n=40):
    """s2l through chip_smoke.method_bundle: full width at 32x32, batch 4,
    n scribble slices (40: two refresh chunks, the last one padded)."""
    cfg = TrainConfig(method="s2l", device="cpu", batch_size=4,
                      patch_size=(32, 32), compute_dtype="float32",
                      thr_iter=0)
    data = synthetic_slices(n, (32, 32), seed=4, sup_type="scribble")
    bundle, _ = chip_smoke.method_bundle(cfg, data, None)
    return cfg, bundle


def test_s2l_step_counts_match_one_step(monkeypatch):
    """One s2l step on the CPU (the pseudo-label term open): the wrapper
    calls are chip_smoke's per-step counts for s2l, one augment_s2l call
    and no K4 call (so no fill-flag launch)."""
    calls = {k: 0 for k in chip_smoke.per_step_counts("unet", "s2l")}
    _count_wrapper_calls(monkeypatch, calls)
    _, bundle = _s2l_bundle()
    bundle.step_fn(bundle.state, next(bundle.data_iter),
                   split_rngs(0, 0, "cpu"), bundle.aux)
    assert calls == chip_smoke.per_step_counts("unet", "s2l")
    assert calls["augment_s2l"] == 1 and calls["augment"] == 0
    assert calls == {**chip_smoke.per_step_counts("unet"), "augment": 0,
                     "augment_s2l": 1}


def test_s2l_refresh_counts_are_chunks_times_eval_counts(monkeypatch):
    """One refresh through the bundle's host hook at 40 slices: two
    eval-forward chunks of 32, so 2 x eval_counts and nothing else; the
    hook refreshes on multiples of period_iter only."""
    calls = {k: 0 for k in chip_smoke.per_step_counts("unet", "s2l")}
    _count_wrapper_calls(monkeypatch, calls)
    cfg, bundle = _s2l_bundle()
    bundle.host_hook(bundle, bundle.state, cfg.period_iter + 1)
    bundle.host_hook(bundle, bundle.state, 0)
    assert not any(calls.values())
    bundle.host_hook(bundle, bundle.state, cfg.period_iter)
    assert chip_smoke.REFRESH_N == ts2l.REFRESH_BS == 32
    want = chip_smoke.refresh_counts("unet", 40)
    assert want == {k: 2 * v for k, v in
                    chip_smoke.eval_counts("unet").items()}
    assert {k: v for k, v in calls.items() if v} == want
    assert float(bundle.state.extra["weight"].min()) > 0


SVC_NARROW = dict(base_channel=8, embed_dim=32, num_heads=2)


def _svc_bundle(monkeypatch, n=chip_smoke.SVC_SLICES):
    """scribblevc through chip_smoke.method_bundle at 32x32, batch 6, n
    scribble phantoms, narrow widths (depth 12)."""
    monkeypatch.setattr(tsvc, "net_factory",
                        functools.partial(net_factory, **SVC_NARROW))
    cfg = TrainConfig(method="scribblevc", model="scribblevc", device="cpu",
                      batch_size=chip_smoke.SVC_N, patch_size=(32, 32),
                      compute_dtype="float32", sup_type="scribble")
    data = synthetic_slices(n, (32, 32), seed=5, sup_type="scribble")
    bundle, _ = chip_smoke.method_bundle(cfg, data, None)
    return cfg, bundle


def test_scribblevc_step_counts_match_one_step(monkeypatch):
    """Two scribblevc steps on the CPU, the memory gate closed and then
    open: each reaches the augment and GatedCRF wrappers once and no conv
    or pool wrapper (the Conformer's convs and pools are cuDNN's and
    PyTorch's, as they are XLA's in the JAX package), chip_smoke's
    per-step counts; an eval forward reaches none."""
    per = chip_smoke.per_step_counts("scribblevc", "scribblevc")
    assert per == {**{k: 0 for k in per}, "augment": 1, "gated_crf": 1}
    calls = {k: 0 for k in per}
    _count_wrapper_calls(monkeypatch, calls)
    _, bundle = _svc_bundle(monkeypatch)
    gate = chip_smoke.svc_gate_step(chip_smoke.SVC_SLICES, chip_smoke.SVC_N)
    memory = bundle.state.extra["class_memory"]
    for step in (gate - 1, gate):
        bundle.state.step = step
        before = dict(calls)
        bundle.step_fn(bundle.state, next(bundle.data_iter),
                       split_rngs(0, step, "cpu"), bundle.aux)
        assert {k: calls[k] - before[k] for k in calls} == per
        assert float(memory["initialized"]) == (step == gate)
    before = dict(calls)
    with torch.no_grad():
        bundle.model(torch.zeros((2, 32, 32, 1)), train=False, memory=memory,
                     use_class_rep=True)
    assert calls == before and chip_smoke.eval_counts("scribblevc") == {}


def test_scribblevc_gate_opens_inside_the_run(monkeypatch):
    """SVC_SLICES phantoms at batch SVC_N make one step an epoch, so the
    gate (epoch > 4) opens at step 5, inside the SVC_STEPS-step run, with
    steps on both sides of it; the bundle's steps_per_epoch agrees."""
    gate = chip_smoke.svc_gate_step(chip_smoke.SVC_SLICES, chip_smoke.SVC_N)
    assert gate == 5 and 0 < gate < chip_smoke.SVC_STEPS
    _, bundle = _svc_bundle(monkeypatch)
    assert 5 * bundle.steps_per_epoch == gate
    assert chip_smoke.svc_gate_step(2 * chip_smoke.SVC_N,
                                    chip_smoke.SVC_N) == 10


def test_svc_reference_check_runs_on_the_cpu():
    """The card-versus-CPU ScribbleVC check with the CPU in both roles at
    32x32 and a quarter of the widths (base 16, embed 64): no error, a
    spread under the tolerance, and the exact-GELU variant caught by both
    checks (at base 8 its gradient error, 0.08, stays under the full
    width's tolerance)."""
    rec = chip_smoke.svc_reference_check(0, dev="cpu", hw=32, draws=1,
                                         base_channel=16, embed_dim=64,
                                         num_heads=2)
    assert rec["eval_rel_err"] == [0.0] * 4 and rec["grad_norm_err"] == 0.0
    assert rec["loss_rel_err"] == 0.0
    assert 0 < max(rec["cpu_reorder_err"], rec["cpu_perturb_err"]) \
        <= chip_smoke.SVC_GRAD_TOL
    assert rec["wrong_variant_eval_err"] > chip_smoke.SVC_EVAL_TOL
    assert rec["wrong_variant_grad_err"] > chip_smoke.SVC_GRAD_TOL
    assert rec["shapes"] == [[2, 32, 32, 4]] * 2 + [[2, 3]] * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
def test_pool_check_runs_on_the_cpu(dtype, ties):
    """check_pool at a tiny size on the CPU (the wrapper's plain route
    against the plain version): two exact records with the byte bound of
    x + y, and of x + g + dx."""
    recs = chip_smoke.check_pool("pool0", 8, 8, dtype, 2, ties, timed=False,
                                 dev="cpu")
    assert [r["kernel"] for r in recs] == ["maxpool_fwd", "maxpool_bwd"]
    es = 2 if dtype == "bfloat16" else 4
    x_bytes = 2 * 8 * 8 * 8 * es
    for r, nbytes in zip(recs, (x_bytes * 5 // 4, x_bytes * 9 // 4)):
        assert r["ok"] and r["mismatched"] == 0 and r["max_abs_err"] == 0.0
        assert r["bound_by"] == "bytes"
        assert r["bound_ms"] == pytest.approx(
            1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)
    only_fwd = chip_smoke.check_pool("pool0", 8, 8, dtype, 2, ties,
                                     timed=False, backward=False, dev="cpu")
    assert [r["kernel"] for r in only_fwd] == ["maxpool_fwd"]


def test_gated_crf_check_runs_on_the_cpu_and_counts_its_work():
    """check_gated_crf at a tiny size on the CPU, default and two
    descriptors, and gcrf_work at the training shape: 22 operations per
    pixel-offset over 120 offsets, operations-bound."""
    for desc in (tgcrf.DEFAULT_KERNELS_DESC, chip_smoke.TWO_DESC):
        (rec,) = chip_smoke.check_gated_crf(2, 10, 12, 2, desc, False, 0,
                                            "path", dev="cpu")
        assert rec["ok"] and rec["descriptors"] == len(desc)
        assert rec["loss"] > 0 and rec["grad_rel_err"] <= 1e-5
    nbytes, ops = chip_smoke.gcrf_work(6, 256, 256, 4, 5, [3])
    assert nbytes == 6 * 256 * 256 * 11 * 4
    assert ops == 6 * 256 * 256 * 120 * 22
    assert chip_smoke.bound(nbytes, ops, "float32")["bound_by"] == \
        "operations"
    probs, image = chip_smoke.gcrf_inputs(2, 10, 12, 0, dev="cpu")
    assert tuple(image.shape) == (2, 10, 12, 1)
    torch.testing.assert_close(probs.sum(-1), torch.ones((2, 10, 12)))


def test_summary_lists_every_kernel_with_every_key():
    """summarize() gives one entry per kernel wrapper of the port, each
    with the keys of the kernels line; records off the training path (a
    stats launch of the head, GatedCRF at another batch) stay out."""
    timing = {"ms": 2.0, "plain_ms": 3.0, "library_ms": 1.0,
              "bound_ms": 0.5, "bound_by": "bytes"}

    def rec(kernel, dtype, err, **kw):
        return {"kernel": kernel, "dtype": dtype, "max_abs_err": err,
                **timing, **kw}

    recs = [
        rec("conv3x3_fwd", "bfloat16", 0.1, conv="head"),
        rec("conv3x3_fwd", "bfloat16", 0.9, conv="enc0.conv2"),  # off path
        rec("conv3x3_fwd_stats", "bfloat16", 0.2, conv="enc0.conv1"),
        rec("conv3x3_fwd_stats", "bfloat16", 0.9, conv="head"),  # off path
        rec("conv3x3_wgrad", "bfloat16", 0.3, conv="head"),
        rec("augment", "float32+int32", 0.0, library_ms=None),
        rec("augment_s2l", "float32+int32+float32x4", 0.0, library_ms=None,
            case="path"),
        rec("augment_s2l", "float32+int32+float32x4", 0.9,
            case="batch 32"),  # off path
        rec("gated_crf", "float32", 0.4, role="path", library_ms=None,
            bound_by="operations"),
        rec("gated_crf", "float32", 0.9, role="batch 24"),  # off path
        rec("maxpool_fwd", "bfloat16", 0.0, pool="pool0"),
        rec("maxpool_fwd", "float32", 0.9, pool="pool0"),  # not the path's
        rec("maxpool_bwd", "bfloat16", 0.0, pool="pool0"),
    ]
    launches = {k: 0 for d in chip_smoke._counters() for k in d}
    rows = chip_smoke.summarize(recs, launches)
    assert sorted(r["name"] for r in rows) == sorted(launches)
    assert len(rows) == 8
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for r in rows:
        assert set(r) == keys and r["route"] == "cuda"
        assert os.path.isfile(os.path.join(REPO, r["source"]))
        path, line = r["replaces"].split(":")
        with open(os.path.join(REPO, path)) as f:
            # a Pallas kernel; S2L's variant replaces an XLA function
            want = ("def augment_batch_s2l(" if r["name"] == "augment_s2l"
                    else "_kernel(")
            assert want in f.readlines()[int(line) - 1]
        assert r["max_abs_err"] < 0.9 and r["ms"] == 2.0
    by_name = {r["name"]: r for r in rows}
    assert by_name["gated_crf"]["library_ms"] is None
    assert by_name["gated_crf"]["bound_by"] == "operations"
    assert by_name["maxpool_bwd"]["library_ms"] == 1.0


def test_bound_is_the_larger_side():
    """bound() takes the larger of the bytes' and the operations' time,
    and a sum of launches is bounded by the side that holds most of it."""
    b = chip_smoke.bound(3.35e9, 989e9, "bfloat16")  # 1 ms each way
    assert b["bound_ms"] == pytest.approx(1.0)
    assert chip_smoke.bound(3.35e9, 0.0, "float32") == {
        "bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
    assert chip_smoke.bound(0.0, 67e9, "float32")["bound_by"] == "operations"
    recs = [{"bound_ms": 1.0, "bound_by": "bytes"},
            {"bound_ms": 3.0, "bound_by": "operations"}]
    assert chip_smoke._bound_by(recs) == "operations"
    assert chip_smoke._bound_by(recs[:1]) == "bytes"


def test_bf16_kernels_variant_rounds_every_conv_and_restores(monkeypatch):
    """Inside bf16_kernels every conv wrapper of an f32 model's train step
    computes in bf16 (so its gradients leave the f32 ones); outside, the
    same step is f32 throughout and the wrappers are the originals."""
    names = ("conv3x3_fwd", "conv3x3_fwd_stats", "conv3x3_wgrad")
    before = {k: getattr(tconv, k) for k in names}
    dtypes = []

    def seen(name, fn):
        def wrapper(x, *args):
            dtypes.append((name, x.dtype))
            return fn(x, *args)
        return wrapper

    plains = ("conv3x3_plain", "conv3x3_stats_plain", "conv3x3_wgrad_plain")
    for name in plains:
        monkeypatch.setattr(tconv, name, seen(name, getattr(tconv, name)))
    model, x, lab, _ = chip_smoke.ref_case(0, 16)
    loss, want = chip_smoke.loss_and_grads(copy.deepcopy(model), x, lab)
    assert set(dtypes) == {(name, torch.float32) for name in plains}
    dtypes.clear()
    with chip_smoke.bf16_kernels():
        loss_w, got = chip_smoke.loss_and_grads(copy.deepcopy(model), x, lab)
    assert set(dtypes) == {(name, torch.bfloat16) for name in plains}
    assert {k: getattr(tconv, k) for k in names} == before
    assert np.isfinite(loss_w) and loss_w != loss
    assert chip_smoke.grad_err(got, want) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,o,h,w", chip_smoke.RAGGED_CONVS)
def test_conv_check_runs_on_the_cpu_at_the_ragged_shapes(c, o, h, w, dtype):
    """check_conv at each ragged shape on the CPU (the wrapper's plain route
    against the plain version): the four roles, each within its limit and
    bit-equal on a repeat, tagged off the training path, with the bound of
    the bytes each role moves."""
    recs = chip_smoke.check_conv(f"ragged {c}->{o}", c, o, h, dtype, 2,
                                 timed=False, dev="cpu", width=w,
                                 case="ragged", repeat=True)
    assert [(r["kernel"], r.get("role")) for r in recs] == [
        ("conv3x3_fwd", None), ("conv3x3_fwd_stats", None),
        ("conv3x3_fwd", "dgrad"), ("conv3x3_wgrad", None)]
    assert [r["shape"] for r in recs] == [[2, h, w, c, o]] * 2 + \
        [[2, h, w, o, c], [2, h, w, c, o]]
    es = 2 if dtype == "bfloat16" else 4
    px = 2 * h * w
    for r in recs:
        assert r["ok"] and r["repeat_bit_equal"] and r["case"] == "ragged"
        assert not chip_smoke._on_path(r)
    assert recs[0]["bound_ms"] == pytest.approx(max(
        1e3 * (px * c + 9 * c * o + o + px * o) * es
        / chip_smoke.HBM_BYTES_PER_S,
        1e3 * 2.0 * px * 9 * c * o / chip_smoke.PEAK_FLOPS[dtype]))


def test_port_kernels_are_the_csrc_global_functions():
    """PORT_KERNELS, by which the profile attributes device time, names
    exactly the __global__ functions of wsl4mis_torch/csrc/*.cu."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(REPO, "wsl4mis_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            src = f.read()
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            src))
    assert names == set(chip_smoke.PORT_KERNELS)
    assert len(chip_smoke.PORT_KERNELS) == len(names)


# device names of one launch of each kernel as a trace may show them:
# demangled, and mangled (the kernels live in an anonymous namespace)
TRACE_NAMES = {
    "conv3x3_fwd_stats": (
        "void (anonymous namespace)::conv3x3_fwd_mma_kernel<64, true>("
        "__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int)",
        "_ZN12_GLOBAL__N_118conv3x3_fwd_kernelIfLb1EEEvPKT_S3_PS1_Pfiiii"),
    "conv3x3_fwd": (
        "void (anonymous namespace)::conv3x3_fwd_kernel<float, false>("
        "float const*, float*, int)",
        "_ZN12_GLOBAL__N_122conv3x3_fwd_mma_kernelILi16ELb0EEEvPK13__nv_"
        "bfloat16"),
    "conv3x3_wgrad": (
        "void (anonymous namespace)::conv3x3_wgrad_mma_kernel<32>(float*)",
        "_ZN12_GLOBAL__N_120conv3x3_wgrad_kernelIfLi8ELi16EEEvPKT_"),
    "augment": ("void (anonymous namespace)::augment_kernel<true>(int)",
                "_ZN12_GLOBAL__N_114augment_kernelILb0EEEvPKfPKi"),
    "augment_s2l": (
        "void (anonymous namespace)::augment_s2l_kernel<true>(int)",
        "_ZN12_GLOBAL__N_118augment_s2l_kernelILb0EEEvPKf"),
    "maxpool_fwd": (
        "void (anonymous namespace)::maxpool_fwd_kernel<float, 4>(int)",
        "_ZN12_GLOBAL__N_118maxpool_fwd_kernelI13__nv_bfloat16Li8EEEvPKT_"),
    "maxpool_bwd": (
        "void (anonymous namespace)::maxpool_bwd_kernel<float, 4>(int)",
        "_ZN12_GLOBAL__N_118maxpool_bwd_kernelIfLi4EEEvPKT_"),
    "gated_crf": (
        "void (anonymous namespace)::gated_crf_kernel<4, 1, 1, 5>(int)",
        "_ZN12_GLOBAL__N_116gated_crf_kernelILi4ELi8ELi4ELin1EEEvPKf"),
}
TRACE_OTHERS = (  # launches no counter counts
    "void (anonymous namespace)::augment_fill_kernel<true>(int)",
    "_ZN12_GLOBAL__N_121gated_crf_fold_kernelEPKfPdi",
    "void at::native::vectorized_elementwise_kernel<4>(int)",
    "sm90_xmma_gemm_bf16bf16_bf16f32")


def test_trace_launches_reads_each_kernels_names():
    """trace_launches, by which phase 10 counts a replay's launches, counts
    each kernel's launches under its counter, its names demangled or
    mangled, and no launch of the fill-flag, fold or PyTorch kernels."""
    events = [(name, 1.0) for names in TRACE_NAMES.values()
              for name in names] + [(name, 1.0) for name in TRACE_OTHERS]
    counts = chip_smoke.trace_launches(events)
    assert counts == {k: 2 for k in TRACE_NAMES}
    assert sorted(counts) == sorted(chip_smoke.launch_counts())


CANNED_SASS = """
Fatbin elf code:
================
arch = sm_90a
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122conv3x3_fwd_mma_kernelILi16ELb1EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0450*/                   LDSM.16.M88.4 R8, [R12] ;
        /*0460*/                   HMMA.16816.F32.BF16 R4, R8, R16, R4 ;
        /*0470*/                   HMMA.16816.F32.BF16 R20, R8, R18, R20 ;
        /*0480*/                   FFMA R2, R3, R4, R2 ;
		Function : _ZN12_GLOBAL__N_118conv3x3_fwd_kernelIfLb0EEEvPKT_
        /*0000*/                   FFMA R2, R3, R4, R2 ;
        /*0010*/                   MOV R5, 0x0 ;
		Function : wgmma_kernel
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0010*/                   WARPGROUP.ARRIVE ;
"""


def test_mma_counts_reads_a_sass_dump():
    """mma_counts counts HMMA and HGMMA lines per function of a cuobjdump
    -sass listing, and nothing else (LDSM, FFMA, WARPGROUP)."""
    counts = chip_smoke.mma_counts(CANNED_SASS)
    assert counts == {
        "_ZN12_GLOBAL__N_122conv3x3_fwd_mma_kernelILi16ELb1EEEvPK13"
        "__nv_bfloat16": 2,
        "_ZN12_GLOBAL__N_118conv3x3_fwd_kernelIfLb0EEEvPKT_": 0,
        "wgmma_kernel": 1}
    assert chip_smoke.mma_counts("") == {}


def test_conv_table_has_a_row_per_conv_from_the_step_records():
    """conv_table lists the 19 UNet convs in order, each with the b24 bf16
    step's forward (fwd_stats, the fwd for the head, cuDNN from the plain
    forward's record), dgrad and wgrad: records of another batch, dtype
    or case stay out."""
    def rec(kernel, conv, ms, lib, role=None, n=chip_smoke.N,
            dtype="bfloat16", case=None):
        r = {"kernel": kernel, "conv": conv, "dtype": dtype,
             "shape": [n, 8, 8, 1, 1], "ms": ms, "bound_ms": 0.5,
             "library_ms": lib}
        if role:
            r["role"] = role
        if case:
            r["case"] = case
        return r

    recs = [rec("conv3x3_fwd", "enc0.conv2", 9.0, 3.0),
            rec("conv3x3_fwd_stats", "enc0.conv2", 2.0, None),
            rec("conv3x3_fwd", "enc0.conv2", 1.5, 2.5, role="dgrad"),
            rec("conv3x3_wgrad", "enc0.conv2", 1.25, 4.0),
            rec("conv3x3_wgrad", "enc0.conv2", 7.0, 7.0, n=6),
            rec("conv3x3_wgrad", "enc0.conv2", 7.0, 7.0, dtype="float32"),
            rec("conv3x3_fwd_stats", "ragged n1", 7.0, None, case="ragged"),
            rec("conv3x3_fwd", "head", 0.75, 1.0),
            {"kernel": "maxpool_fwd", "pool": "pool0", "dtype": "bfloat16",
             "shape": [chip_smoke.N, 8, 8, 1], "ms": 1.0, "bound_ms": 0.5,
             "library_ms": 1.0}]
    rows = chip_smoke.conv_table(recs)
    assert len(rows) == 2 + 19
    names = [row.split("|")[1].strip() for row in rows[2:]]
    assert names == [name for name, *_ in chip_smoke.unet_convs()]
    enc0 = rows[2 + names.index("enc0.conv2")].split("|")
    assert [cell.strip() for cell in enc0[4:7]] == [
        "2.0000 / 0.5000 / 3.0000", "1.5000 / 0.5000 / 2.5000",
        "1.2500 / 0.5000 / 4.0000"]
    head = rows[2 + names.index("head")].split("|")
    assert head[4].strip() == "0.7500 / 0.5000 / 1.0000"
    assert head[5].strip() == head[6].strip() == "—"


def test_summary_leaves_out_the_ragged_shapes():
    """The ragged-shape records are no launch of a training path: they
    enter neither the kernels line's error nor its times."""
    base = {"ms": 1.0, "plain_ms": 1.0, "library_ms": 1.0, "bound_ms": 1.0,
            "bound_by": "bytes"}
    recs = []
    for kernel, dtype, extra in (
            ("conv3x3_fwd", "bfloat16", {"conv": "head"}),
            ("conv3x3_fwd_stats", "bfloat16", {"conv": "enc0.conv1"}),
            ("conv3x3_wgrad", "bfloat16", {"conv": "head"}),
            ("augment", "float32+int32", {}),
            ("augment_s2l", "float32+int32+float32x4", {"case": "path"}),
            ("gated_crf", "float32", {"role": "path"}),
            ("maxpool_fwd", "bfloat16", {"pool": "pool0"}),
            ("maxpool_bwd", "bfloat16", {"pool": "pool0"})):
        recs.append({"kernel": kernel, "dtype": dtype, "max_abs_err": 0.1,
                     **base, **extra})
        if kernel.startswith("conv3x3"):
            recs.append({"kernel": kernel, "dtype": dtype, "conv": "ragged",
                         "case": "ragged", "max_abs_err": 5.0,
                         **base, "ms": 100.0})
    launches = {k: 1 for d in chip_smoke._counters() for k in d}
    for row in chip_smoke.summarize(recs, launches):
        assert row["max_abs_err"] == 0.1 and row["ms"] == 1.0


def test_augment_checks_run_on_the_cpu():
    """check_augment and check_augment_angles on the CPU (the wrapper's
    plain route against the plain version): every policy the sampler
    draws, the 40 angles among them, on planes that are no tile multiple,
    tagged off the path but for the path's batch."""
    (path,) = chip_smoke.check_augment(0, 3, False, dev="cpu")
    assert path["ok"] and path["case"] == "path"
    assert chip_smoke._on_path(path)
    for h in (9, 10):
        (rec,) = chip_smoke.check_augment_angles(1, h, dev="cpu")
        assert rec["ok"] and rec["mismatched_pixels"] == 0
        assert rec["shape"] == [49, h, h] and rec["branches"] == [0, 1, 2]
        assert not chip_smoke._on_path(rec)


def test_s2l_augment_checks_run_on_the_cpu():
    """The same checks of K4's S2L variant (image, scribble and weight
    rows) on the CPU: exact on every policy at planes that are no tile
    multiple, 48 bytes a pixel in the bound, off the path but for the
    path's batch (a refresh-sized batch is tagged off it)."""
    (path,) = chip_smoke.check_augment(0, 3, False, dev="cpu", s2l=True)
    assert path["ok"] and path["case"] == "path"
    assert path["kernel"] == "augment_s2l" and chip_smoke._on_path(path)
    assert path["bound_ms"] == pytest.approx(
        1e3 * (3 * 256 * 256 * 48 + 3 * 16) / chip_smoke.HBM_BYTES_PER_S)
    for h in (9, 10):
        (rec,) = chip_smoke.check_augment_angles(1, h, dev="cpu", s2l=True)
        assert rec["ok"] and rec["mismatched_pixels"] == 0
        assert rec["shape"] == [49, h, h] and rec["branches"] == [0, 1, 2]
        assert not chip_smoke._on_path(rec)
    (off,) = chip_smoke.check_augment(2, 5, False, dev="cpu", s2l=True,
                                      case="batch 5")
    assert off["ok"] and not chip_smoke._on_path(off)


def test_gated_crf_check_takes_both_feature_routes_on_the_cpu():
    """check_gated_crf's contraction on the path's route (xy from the
    coordinates) and with every feature stored: both records pass and
    count the same work, that of the full stacked features."""
    recs = [chip_smoke.check_gated_crf(2, 7, 9, 2, chip_smoke.TWO_DESC,
                                       False, 0, "two descriptors",
                                       dev="cpu", stored_xy=stored)[0]
            for stored in (False, True)]
    assert [r["xy"] for r in recs] == ["coordinates", "stored"]
    for r in recs:
        assert r["ok"] and r["shape"] == [2, 7, 9, 4, 5]
        assert not chip_smoke._on_path(r)
    assert recs[0]["bound_ms"] == recs[1]["bound_ms"]


def test_spill_check_covers_conv_augment_and_gated_crf():
    """spilling() reports a spill in any function of the conv, augment or
    GatedCRF libraries, and nothing for a clean report or another
    library."""
    clean = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    dirty = "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"
    lines = [f"{lib}: {clean}" for lib in ("conv3x3", "augment",
                                            "gated_crf", "maxpool")]
    assert chip_smoke.spilling(lines) == []
    for lib in ("conv3x3", "augment", "gated_crf"):
        assert chip_smoke.spilling(lines + [f"{lib}: {dirty}"]) == \
            [f"{lib}: {dirty}"]
    assert chip_smoke.spilling([f"maxpool: {dirty}"]) == []


def test_port_kernel_ms_sums_each_kernel_per_call():
    """port_kernel_ms sums the device µs of each of the port's kernels over
    a trace's device events, per call, and nothing else; device_events
    finds no device event in a CPU-only trace."""
    from torch.profiler import ProfilerActivity, profile

    events = [("void (anonymous namespace)::conv3x3_fwd_mma_kernel<16, "
               "true>(...)", 30.0),
              ("conv3x3_fwd_mma_kernel<64, false>", 10.0),
              ("conv3x3_wgrad_kernel<float, 4, 16>", 4.0),
              ("void at::native::elementwise_kernel<128, 4>", 50.0)]
    assert chip_smoke.port_kernel_ms(events, 2) == {
        "conv3x3_fwd_mma_kernel": pytest.approx(0.02),
        "conv3x3_wgrad_kernel": pytest.approx(0.002)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).add_(1)
    assert chip_smoke.device_events(prof) == []


def test_kernel_classes_split_port_library_and_the_rest():
    """kernel_classes puts the port's kernels (their names hold "conv"
    too) first, cuBLAS / cuDNN / CUTLASS kernels by name second, and every
    other device event in the rest, per step."""
    events = [("void (anonymous namespace)::conv3x3_wgrad_mma_kernel<64>"
               "(...)", 100.0),
              ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128",
               200.0),
              ("nvjet_hsh_64x64_64x16_2x1_v_bz_coopA_NNN", 50.0),
              ("void cudnn::engines_precompiled::nchwToNhwcKernel", 10.0),
              ("void at::native::reduce_kernel<128, 4>", 300.0)]
    assert chip_smoke.kernel_classes(events, 2) == {
        "port": pytest.approx(0.05),
        "library_matmul_conv": pytest.approx(0.13),
        "other": pytest.approx(0.15)}


def _count_launches(monkeypatch):
    """chip_smoke's launch counters, read from the calls that reach each
    wrapper (on the card each call is one launch)."""
    calls = {k: 0 for k in chip_smoke.per_step_counts("unet")}
    _count_wrapper_calls(monkeypatch, calls)
    monkeypatch.setattr(chip_smoke, "launch_counts", lambda: dict(calls))
    monkeypatch.setattr(chip_smoke, "reset_counts",
                        lambda: calls.update(dict.fromkeys(calls, 0)))
    return calls


@pytest.fixture
def narrow_entry(monkeypatch, tmp_path):
    """The entry-points phase on the CPU: narrow models (features 4..16,
    the factory patched where the train and test commands build them),
    8-slice validation chunks, counted wrapper calls, its files under
    tmp_path, no learning bound."""
    from wsl4mis_torch.eval.val2d import VolumePredictor

    narrow = functools.partial(net_factory, features=(4, 8, 8, 16, 16))
    monkeypatch.setattr(VolumePredictor, "__init__", functools.partialmethod(
        VolumePredictor.__init__, chunk=8))
    monkeypatch.setattr(chip_smoke, "EVAL_N", 8)
    monkeypatch.setattr("wsl4mis_torch.engine.methods.common.net_factory",
                        narrow)
    monkeypatch.setattr("wsl4mis_torch.eval.infer.net_factory", narrow)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "LEARN_RISE", -1.0)
    return _count_launches(monkeypatch)


def test_entry_argv_builds_the_run_config():
    """The phase's flags through the command's own parser over
    train_fully_supervised_2D's defaults."""
    from wsl4mis_torch import cli

    method, defaults = cli.resolve_script("train_fully_supervised_2D")
    argv = chip_smoke.entry_argv(24, 200, 100, "snap", 7) + [
        "--device", "cuda", "--aug_mode", "host"]
    cfg = cli.config_from_args(cli.build_parser(defaults).parse_args(argv),
                               method)
    assert (cfg.batch_size, cfg.max_iterations, cfg.val_every,
            cfg.ckpt_every, cfg.seed) == (24, 200, 100, 200, 7)
    assert (cfg.method, cfg.fold, cfg.sup_type, cfg.base_lr) == \
        ("fully_supervised", "fold5", "label", 0.03)
    assert cfg.patch_size == (256, 256) and cfg.snapshot_root == "snap"
    assert (cfg.device, cfg.aug_mode) == ("cuda", "host")
    assert chip_smoke.per_step_counts("unet", "fully_supervised",
                                      host_aug=True)["augment"] == 0
    for _, _, _, steps, bound in chip_smoke.LEARN_RUNS:
        assert steps % 2 == 0 and 0 < bound < 1


def test_entry_phase_runs_on_the_cpu(narrow_entry, monkeypatch):
    """The whole phase at 256x256 on the CPU (h5py here: the train command
    reads an H5 tree chip_smoke writes): launches as expected (the host
    run's augment 0), the test command's Dice equal to the validation's,
    its NIfTI files equal to the predictions."""
    monkeypatch.setattr(chip_smoke, "N", 2)
    data = synthetic_slices(24, (256, 256), seed=0)
    scribbles = synthetic_slices(24, (256, 256), seed=0, sup_type="scribble")
    val = synthetic_volumes(2, 3, 40, 48, seed=1)
    runs = (("train_fully_supervised_2D", "unet", 2, 2, -1.0),
            ("train_weakly_supervised_segmentation_pCE_ours_proposed",
             "unet_cct", 2, 2, -1.0))
    out = chip_smoke.entry_points(0, data, scribbles, val, "cpu", dev="cpu",
                                  runs=runs, host_steps=2,
                                  host_native=(21, 23))
    assert out["h5py"]
    for rec in out["runs"]:
        assert rec["launches"] == rec["expected"]
        assert len(rec["val_dice"]) == 2
        assert rec["inference"]["dice_err"] == 0.0
        assert all(rec["inference"]["nifti_equal"])
    host = out["host_aug"]
    assert host["aug_mode"] == "host" and host["launches"]["augment"] == 0
    assert host["launches"] == host["expected"]


def test_entry_run_from_memory_on_the_cpu(narrow_entry, tmp_path):
    """Without an H5 tree (a machine without h5py): the command's argv
    through its parser, the bundle from in-memory slices, host batches
    from their native sizes; then the test command's check."""
    val = synthetic_volumes(2, 3, 40, 48, seed=1)
    native = zoomed_with_native(synthetic_slices(4, (21, 23), seed=2),
                                (256, 256))
    argv = chip_smoke.entry_argv(2, 2, 1, str(tmp_path / "snap"), 0) + [
        "--device", "cpu", "--aug_mode", "host"]
    trainer, rec, evals = chip_smoke.run_cli(
        "fully_supervised", "unet", argv, native, val, dev="cpu")
    assert rec["launches"]["augment"] == 0 and len(evals) == 2
    assert rec["launches"] == rec["expected"]
    assert max(rec["val_dice"]) > 0  # so a best checkpoint was saved
    inf = chip_smoke.check_inference(trainer, evals, "unet", dev="cpu")
    assert inf["dice_err"] == 0.0


def test_resume_phase_runs_on_the_cpu(narrow_entry, monkeypatch):
    """Phase 7 on the CPU at 32x32 with narrow models (ScribbleVC's too),
    batches of 2 (fully_supervised, the train command) and 4, and the
    chunk threshold lowered to 4 KiB, so that s2l's 40-slice buffer is
    written as 160 chunks: every layout takes the JAX format and restores
    bit for bit, the resumed steps equal the uninterrupted ones with
    their launch counts (and repeat on the CPU without the deterministic
    algorithms too), and the train command resumes the JAX-layout file at
    step 3 and takes exactly steps 3..6."""
    monkeypatch.setattr(tsvc, "net_factory",
                        functools.partial(net_factory, **SVC_NARROW))
    monkeypatch.setattr(chip_smoke, "N", 2)
    monkeypatch.setattr(chip_smoke, "SEMI_N", 4)
    monkeypatch.setattr(tck, "MAX_CHUNK_BYTES", 2 ** 12)
    data = synthetic_slices(8, (32, 32), seed=0)
    scribbles = synthetic_slices(8, (32, 32), seed=0, sup_type="scribble")
    val = synthetic_volumes(1, 3, 40, 48, seed=1)
    labeled = ArraySliceDataset(data.images[:4], data.labels[:4])
    unlabeled = ArraySliceDataset(data.images[4:], data.labels[4:])
    svc_data = synthetic_slices(chip_smoke.SVC_SLICES, (32, 32), seed=2,
                                sup_type="scribble")
    out = chip_smoke.resume_phase(0, data, scribbles, val, labeled,
                                  unlabeled, svc_data, "cpu", dev="cpu",
                                  hw=32, s2l_slices=40)
    runs = {r["method"]: r for r in out["runs"]}
    assert list(runs) == [m for m, *_ in chip_smoke.resume_runs()]
    for r in runs.values():
        assert r["format"] == "jax" and r["restore_diff"] == []
        assert r["after_diff"] == {"leaves": 0, "max_abs": 0.0}
        assert r["default_mode_repeat"] == {"leaves": 0, "max_abs": 0.0}
        assert r["restored_leaves"] > 50
    # the buffer, the largest leaf (at 4 KiB the parameters chunk too)
    assert max(runs["s2l"]["chunked_leaves"]) == 40 * 32 * 32 * 4 * 4 // 2 ** 12
    assert runs["scribblevc"]["steps_before"] == 6
    cli = out["cli"]
    assert cli["steps"] == [3, 4, 5, 6] and cli["logged"]
    assert cli["torch_format_after"] and all(cli["files"].values())
    assert out["warnings"] == [] and not torch.are_deterministic_algorithms_enabled()


def test_leaves_diff_finds_a_changed_leaf():
    """The phase's comparison: equal trees give nothing; one flipped bit,
    a count or a missing leaf is found."""
    model = net_factory("unet", 4, dtype=torch.float32,
                        features=(4, 8, 8, 16, 16))
    state = TrainState(model=model, opt=ReferenceSGD(model.parameters(),
                                                     0.01, 10))
    a = chip_smoke._snapshot(chip_smoke.state_leaves(state))
    assert chip_smoke.leaves_diff(a, chip_smoke.state_leaves(state)) == (
        [], 0.0)
    with torch.no_grad():
        state.opt.momentum_buffers[3].view(-1)[0] = 1e-30
    bad, worst = chip_smoke.leaves_diff(a, chip_smoke.state_leaves(state))
    assert bad == ["/opt/momentum/3"] and worst == pytest.approx(1e-30)
    state.opt.count = 1
    assert "/opt/count" in chip_smoke.leaves_diff(
        a, chip_smoke.state_leaves(state))[0]
    b = dict(a)
    b.pop("/step")
    assert chip_smoke.leaves_diff(a, b) == (["/step"], math.inf)


def test_main_returns_2_and_no_result_line_without_a_card(capsys):
    """With the entry-points phase in: no card, exit code 2, nothing on
    standard output (so no result line)."""
    assert not torch.cuda.is_available()
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


# narrow widths of the zoo phase's models on the CPU
ZOO_WIDTHS = {
    **{name: {"features": (4, 8, 8, 16, 16)} for name in chip_smoke.UNET_HEADS},
    "pnet": {"num_filters": 8},
    "efficient_unet": {"encoder_name": "efficientnet-b0"},
    "unet_3D": {"feature_scale": 16}, "attention_unet": {"feature_scale": 16},
    "vnet": {"n_filters": 4}, "voxresnet": {"feature_chns": 8},
    "scribblevc": {"base_channel": 8, "embed_dim": 32, "num_heads": 2},
}


def _narrow_factory(name, *args, **kwargs):
    return net_factory(name, *args, **{**ZOO_WIDTHS.get(name, {}), **kwargs})


@pytest.fixture
def narrow_zoo(monkeypatch, tmp_path):
    """The zoo phase on the CPU: the narrow widths above wherever the
    commands build a model, 8-slice validation chunks, counted wrapper
    calls, its files under tmp_path."""
    from wsl4mis_torch.eval.val2d import VolumePredictor

    monkeypatch.setattr(VolumePredictor, "__init__", functools.partialmethod(
        VolumePredictor.__init__, chunk=8))
    monkeypatch.setattr(chip_smoke, "EVAL_N", 8)
    monkeypatch.setattr("wsl4mis_torch.engine.methods.common.net_factory",
                        _narrow_factory)
    monkeypatch.setattr("wsl4mis_torch.eval.infer.net_factory",
                        _narrow_factory)
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    return _count_launches(monkeypatch)


def test_zoo_phase_runs_on_the_cpu(narrow_zoo, tmp_path):
    """The whole zoo phase at 64x64 (3D: 16^3), batch 2, narrow widths:
    every 2D and 3D model timed and held against itself on the CPU, the
    multi-head UNets' wrapper calls of a forward + backward equal to
    fwd_bwd_counts, the train command on pnet / efficient_unet (one with
    --encoder_weights) and pce on pnet with one augment a step, the test
    command's and test_scribblevc's Dice equal to their validations' (the
    latter also on the checkpoint with shifted heads, where its Dice is
    not 0).
    The checkpoints it reads stand in for phases 3 and 5's: a narrow UNet
    and a narrow bf16 ScribbleVC (the test command's compute dtype) with
    its select-rule validation."""
    from wsl4mis_torch.engine.methods.scribblevc import mean_softmax_decision
    from wsl4mis_torch.eval.val2d import VolumePredictor, evaluate_fold
    from wsl4mis_torch.utils.checkpoint import save_model_checkpoint

    data = synthetic_slices(8, (64, 64), seed=0)
    scribbles = synthetic_slices(8, (64, 64), seed=0, sup_type="scribble")
    val = synthetic_volumes(2, 3, 40, 48, seed=1)
    unet_path = str(tmp_path / "unet.pth")
    save_model_checkpoint(unet_path, chip_smoke._as_state(_narrow_factory(
        "unet", 4, generator=torch.Generator().manual_seed(0))))
    svc = _narrow_factory("scribblevc", 4, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    memory = svc.init_memory((256, 256))
    snap = {"snapshot_root": str(tmp_path / "svc"), "exp": "ACDC",
            "fold": "fold1", "sup_type": "scribble"}
    state = chip_smoke._as_state(svc)
    state.extra = {"class_memory": memory}
    save_model_checkpoint(str(tmp_path / "svc" / "ACDC_fold1" / "scribble"
                              / "iter_3.pth"), state,
                          eval_extra=("class_memory",))
    select = VolumePredictor(svc, (256, 256), device="cpu",
                             decision_fn=mean_softmax_decision,
                             forward_kwargs={"use_class_rep": False})
    svc_run = {"steps": 3, "snapshot": snap, "select_val": evaluate_fold(
        select, val, 4, nan_aware=True, variables={"memory": memory})}
    runs = tuple((s, m, 2, w) for s, m, _, w in chip_smoke.ZOO_RUNS)
    out = chip_smoke.zoo_phase(0, data, scribbles, val, "cpu", unet_path,
                               svc_run, dev="cpu", hw=64, batch=2,
                               widths=ZOO_WIDTHS, shape3d=(1, 16, 16, 16, 1),
                               ref3d=(1, 16, 16, 16, 1), runs=runs, steps=2)
    assert [r["model"] for r in out["models"]] == list(chip_smoke.ZOO_2D)
    assert [r["model"] for r in out["nets3d"]] == list(chip_smoke.ZOO_3D)
    for r in out["models"] + out["nets3d"]:
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 and r["ref_err"] == 0
    counted = [r for r in out["models"] if "launches" in r]
    assert [r["model"] for r in counted] == ["unet_cct_3h", "unet_ds",
                                             "unet_urds"]
    assert all(r["launches"] == r["expected"] for r in counted)
    assert [r["encoder_weights"] for r in out["train"]] == [
        False, False, True, False]
    for r in out["train"]:
        assert r["launches"] == r["expected"]
        assert r["launches"]["augment"] == 2 and sum(
            r["launches"].values()) == 2
    assert [r["dice_err"] for r in out["inference"]] == [0.0, 0.0]
    assert out["svc_test"]["dice_err"] == 0.0
    shifted = out["svc_test"]["shifted"]
    assert shifted["dice_err"] == 0.0 and max(shifted["val_dice"]) > 0


def test_zoo_counts_follow_the_model_shape():
    """fwd_bwd_counts: a train-mode forward launches the stats kernel for
    every ConvBlock conv and the fwd kernel for every head; the backward
    a dgrad for every conv but the stem and a wgrad for every conv."""
    assert chip_smoke.fwd_bwd_counts("unet_ds") == {
        "conv3x3_fwd_stats": 18, "conv3x3_fwd": 4 + 21, "conv3x3_wgrad": 22,
        "augment": 0, "augment_s2l": 0, "maxpool_fwd": 4, "maxpool_bwd": 4,
        "gated_crf": 0}
    c3h = chip_smoke.fwd_bwd_counts("unet_cct_3h")
    assert (c3h["conv3x3_fwd_stats"], c3h["conv3x3_fwd"],
            c3h["conv3x3_wgrad"]) == (34, 3 + 36, 37)
    assert chip_smoke.fwd_bwd_counts("unet_urds") == \
        chip_smoke.fwd_bwd_counts("unet_ds")
    for name in ("pnet", "efficient_unet"):
        assert chip_smoke.eval_counts(name) == {}
        assert chip_smoke.per_step_counts(name, "pce") == dict(
            chip_smoke.per_step_counts("scribblevc"), gated_crf=0)


def test_method_bundle_builds_dmpls_on_unet_cct():
    """dmpls from memory (the card has no h5py) builds UNet_CCT, as its
    build() does, past the single-output check of make_model_and_state."""
    cfg = TrainConfig(method="dmpls", model="unet_cct", device="cpu",
                      batch_size=2, patch_size=(32, 32),
                      compute_dtype="float32", sup_type="scribble")
    bundle, _ = chip_smoke.method_bundle(
        cfg, synthetic_slices(4, (32, 32), seed=1, sup_type="scribble"),
        None)
    assert type(bundle.model).__name__ == "UNetCCT"


DP_WIDTHS = {"features": (4, 8, 8, 16, 16), "scribblevc": SVC_NARROW}


def test_data_parallel_phase_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phase 8 on the CPU at 64x64 with narrow models and small batches:
    (a) two gloo ranks on each cell, every step within dp_compare's
    tolerances of the single process from the same state and the ranks
    bit-equal; (b) a group of one (gloo here) bit for bit the run with no
    group, its collectives counted; (c) recorded as not run."""
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    cells = [chip_smoke.dp_cell(m, b) for m, b in (
        ("fully_supervised", 4), ("dmpls", 2), ("uamt", 4), ("s2l", 4),
        ("scribblevc", 6))]
    out = chip_smoke.dp_phase(0, "cpu", dev="cpu", hw=64, cells=cells,
                              widths=DP_WIDTHS, nccl_batch=4,
                              nccl_dtype="float32")
    two = out["two_ranks_gloo"]
    assert list(two) == [c[0] for c in cells]
    for method, r in two.items():
        assert r["ranks_bit_equal"] and r["ranks"] == 2
        assert r["collectives_per_step"]["all_reduce"] > 0, method
        assert r["diff"]["loss_rel"] < chip_smoke.DP_LOSS_RTOL
    assert two["scribblevc"]["diff"]["gate"] == 0.0
    assert "ema" in two["uamt"]["diff"] and "weight" in two["s2l"]["diff"]
    # the first moments were held (dp_moments), not only recorded
    assert two["fully_supervised"]["diff"]["opt/momentum"] <= \
        chip_smoke.DP_MOMENT_RTOL[None]
    assert two["scribblevc"]["diff"]["opt/mu"] <= \
        chip_smoke.DP_MOMENT_RTOL["scribblevc"]
    one = out["nccl_one_rank"]
    assert one["leaves_differing"] == 0 and one["steps"] == 10
    assert one["collectives_per_step"]["all_reduce"] > 0
    assert out["multi_card"] == {"run": False, "cards": 0}
    printed = capsys.readouterr().out
    assert "data parallel: the multi-card run was not run (0 cards)" in \
        printed
    line = next(x for x in printed.splitlines()
                if x.startswith("data_parallel "))
    assert set(json.loads(line.split(" ", 1)[1])) == {
        "card", "phase_s", "two_ranks_gloo", "nccl_one_rank", "multi_card"}


def _adam_leaves(rs, g, disc_g, nu_scale=1.0):
    """state_leaves of a model parameter "w" under Adam (the optimizer's
    mu / nu lists) and a discriminator's Adam state, after a step of
    gradient g (disc_g) from the moments in `rs`'s first draws."""
    mu0, nu0, dmu0 = (torch.from_numpy(rs.standard_normal(50)).float()
                      for _ in range(3))
    return {"/step": 1, "/model/w": torch.zeros(50), "/opt/count": 1,
            "/opt/mu/0": 0.9 * mu0 + 0.1 * g,
            "/opt/nu/0": 0.999 * nu0.abs() + 0.001 * nu_scale * g * g,
            "/extra/disc_opt_state/count": 1,
            "/extra/disc_opt_state/mu/k": 0.9 * dmu0 + 0.1 * disc_g}


@pytest.mark.parametrize("method, got_g, got_disc, nu_scale, fails", [
    ("deep_adversarial", 1.0, 1.0, 1.0, []),
    ("deep_adversarial", 1.0 + 5e-3, 1.0, 1.0, []),
    ("deep_adversarial", 2.0, 1.0, 1.0, ["opt/mu"]),        # summed
    ("deep_adversarial", 1.0, 2.0, 1.0, ["disc_opt/mu"]),   # D summed
    ("deep_adversarial", 1.0, 0.5, 1.0, ["disc_opt/mu"]),   # D halved
    ("deep_adversarial", 1.0, 1.0, 3.0, []),                # nu recorded
    ("deep_adversarial", 1.02, 1.0, 1.0, ["opt/mu"]),
    ("scribblevc", 1.02, 1.0, 1.0, []),
    ("scribblevc", 1.05, 1.0, 1.0, ["opt/mu"]),
])
def test_dp_moments_hold_the_first_moments(method, got_g, got_disc,
                                           nu_scale, fails):
    """dp_moments against a step whose gradient is a factor off: the
    first moments' change is held in norm to DP_MOMENT_RTOL (a gradient
    off by 1/2 or x2, as a missing average makes it, fails, in the model's
    or the discriminator's Adam state alone), nu only recorded."""
    g = torch.from_numpy(np.random.RandomState(1).standard_normal(50))
    g = g.float()
    before = _adam_leaves(np.random.RandomState(0), 0.0 * g, 0.0 * g)
    # before's moments, then the step's change
    for k in ("/opt/mu/0", "/extra/disc_opt_state/mu/k"):
        before[k] = before[k] / 0.9
    before["/opt/nu/0"] = before["/opt/nu/0"] / 0.999
    want = _adam_leaves(np.random.RandomState(0), g, g)
    got = _adam_leaves(np.random.RandomState(0), got_g * g, got_disc * g,
                       nu_scale)
    rel, failures = chip_smoke.dp_moments(method, got, want, before, {"w"})
    assert set(rel) == {"opt/mu", "opt/nu", "disc_opt/mu"}
    assert [f.split(" ")[0] for f in failures] == fails
    np.testing.assert_allclose(rel["opt/mu"], abs(got_g - 1.0) * 0.1
                               * float(g.norm()) / float(
                                   (want["/opt/mu/0"] - before["/opt/mu/0"])
                                   .norm()), rtol=1e-4)
    _, leaf_fails = chip_smoke.dp_compare(method, got, want, {"w"}, before)
    assert [f.split(" ")[0] for f in leaf_fails] == fails


def test_surface_phase_runs_on_the_cpu(narrow_zoo, tmp_path, capsys):
    """Phase 9 on the CPU at 64x64 (VNet at 16^3, 16 filters: GroupNorm's
    16 groups), batch 2, a narrow UNet and ScribbleVC: test_single_volume
    equal to evaluate_fold per volume with an eval forward's calls per
    chunk; apply_model bit for bit the module's own forward and its
    batch_stats, with one forward's calls; each VNet normalization; the
    pytree checkpoint round trip; test_scribblevc --checkpoints with a
    missing file, at MULTI_SPACING. The checkpoints stand in for phases 3,
    5 and 6's: a narrow UNet, a narrow bf16 ScribbleVC and its copy with
    shifted heads."""
    from wsl4mis_torch.utils.checkpoint import save_model_checkpoint

    val = synthetic_volumes(2, 3, 40, 48, seed=1)
    unet_path = str(tmp_path / "unet.pth")
    save_model_checkpoint(unet_path, chip_smoke._as_state(_narrow_factory(
        "unet", 4, generator=torch.Generator().manual_seed(0))))
    svc = _narrow_factory("scribblevc", 4, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    memory = svc.init_memory((256, 256))
    snap = {"snapshot_root": str(tmp_path / "svc"), "exp": "ACDC",
            "fold": "fold1", "sup_type": "scribble"}
    snapdir = tmp_path / "svc" / "ACDC_fold1" / "scribble"
    state = chip_smoke._as_state(svc)
    state.extra = {"class_memory": memory}
    save_model_checkpoint(str(snapdir / "iter_3.pth"), state,
                          eval_extra=("class_memory",))
    chip_smoke._svc_shifted(svc, memory, val, "cpu")
    save_model_checkpoint(str(snapdir / "zoo_shifted.pth"), state,
                          eval_extra=("class_memory",))
    widths = {"unet": ZOO_WIDTHS["unet"], "vnet": {"n_filters": 16}}
    out = chip_smoke.surface_phase(
        0, val, "cpu", unet_path, {"steps": 3, "snapshot": snap}, dev="cpu",
        hw=64, batch=2, widths=widths, shape3d=(1, 16, 16, 16, 1),
        ref3d=(1, 16, 16, 16, 1), n_volumes=2)
    sv = out["single_volume"]
    assert sv["per_volume_diff"] == 0.0 and sv["mean_diff"] == 0.0
    assert sv["f32_agree"] == 1.0
    # 10 slices: 16 with the bucket's padding, two 8-slice chunks a volume
    assert sv["launches"] == {"conv3x3_fwd": 19 * 4, "maxpool_fwd": 4 * 4}
    am = out["apply_model"]
    assert am["eval_bit_equal"] and am["train_bit_equal"]
    assert am["batch_stats_equal"] and am["batch_stats_leaves"] == 36
    assert am["eval_launches"] == am["eval_expected"]
    assert am["train_launches"] == {"conv3x3_fwd_stats": 18,
                                    "conv3x3_fwd": 1, "maxpool_fwd": 4}
    assert [r["model"] for r in out["vnet"]] == [
        f"vnet {n}" for n in chip_smoke.VNET_NORMS]
    assert all(r["ref_err"] == 0 for r in out["vnet"])
    assert out["checkpoint"]["differing"] == 0
    # 23 kernels and biases (19 convs, 4 transposed), 18 BN scales and
    # biases; 18 BN means and variances; the bf16 logits
    assert out["checkpoint"]["leaves"] == 46 + 36 + 36 + 1
    multi = out["svc_multi"]
    assert multi["spacing"] == [10.0, 1.0, 1.0]
    assert multi["iter_3.pth"]["diff"] == 0.0
    assert multi["zoo_shifted.pth"]["diff"] == 0.0
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith("surface "))
    assert set(json.loads(line.split(" ", 1)[1])) == {
        "card", "phase_s", "test_single_volume", "apply_model", "vnet",
        "checkpoint", "test_scribblevc_checkpoints"}
    assert out["phase_s"] < 60
