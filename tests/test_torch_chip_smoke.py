"""chip_smoke.py off the card (on the CPU): it refuses to run without CUDA,
the conv shapes and per-step launch counts it holds the card's run to are
those of the port's UNet and UNet_CCT training steps, and its reference
check's known-wrong variant runs every conv kernel in bf16."""

import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from wsl4mis_torch.data import augment_device  # noqa: E402
from wsl4mis_torch.engine.config import TrainConfig  # noqa: E402
from wsl4mis_torch.engine.methods import get_method  # noqa: E402
from wsl4mis_torch.engine.methods.common import split_rngs  # noqa: E402
from wsl4mis_torch.engine.optim import ReferenceSGD  # noqa: E402
from wsl4mis_torch.engine.state import TrainState  # noqa: E402
from wsl4mis_torch.models import net_factory  # noqa: E402
from wsl4mis_torch.models.unet import Conv3x3  # noqa: E402
from wsl4mis_torch.ops import augment as taug  # noqa: E402
from wsl4mis_torch.ops import conv3x3 as tconv  # noqa: E402

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


@pytest.mark.parametrize("method,model_name", [("fully_supervised", "unet"),
                                               ("dmpls", "unet_cct")])
def test_per_step_counts_match_one_step(monkeypatch, method, model_name):
    """One train step on the CPU, counting the calls that reach each
    wrapper (on the card each is one launch): chip_smoke's expected
    per-step counts."""
    calls = {k: 0 for k in chip_smoke.per_step_counts(model_name)}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in ("conv3x3_fwd", "conv3x3_fwd_stats", "conv3x3_wgrad"):
        monkeypatch.setattr(tconv, name, counted(name, getattr(tconv, name)))
    monkeypatch.setattr(augment_device._augment, "augment_batch",
                        counted("augment", taug.augment_batch))
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
    assert calls == chip_smoke.per_step_counts(model_name)


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
