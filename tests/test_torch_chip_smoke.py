"""chip_smoke.py off the card (on the CPU): it refuses to run without CUDA,
the conv and pool shapes and per-step launch counts it holds the card's run
to are those of the port's UNet and UNet_CCT training steps (the
semi-supervised ones through the bundles it builds), its pool and
GatedCRF checks run (plain against plain) at tiny sizes, its kernel summary
lists every kernel with every key, and its reference check's known-wrong
variant runs every conv kernel in bf16."""

import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from wsl4mis_torch.data import augment_device, synthetic_slices  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods import s2l as ts2l  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.models.unet import Conv3x3  # noqa: E402
from wsl4mis_torch.ops import augment as taug  # noqa: E402
from wsl4mis_torch.ops import conv3x3 as tconv  # noqa: E402
from wsl4mis_torch.ops import gated_crf as tgcrf  # noqa: E402
from wsl4mis_torch.ops import maxpool as tpool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
