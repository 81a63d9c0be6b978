"""The work counts against hand counts, at a reduced size and at the
published one, through the configurations' modules and the methods'
``work`` as the drivers read them."""

import pytest

from conftest import small_cell
from harness import work

TINY = {"feature_chns": [2, 4], "in_chns": 1, "class_num": 4,
        "patch_size": [8, 8]}
UNET = {"feature_chns": [16, 32, 64, 128, 256], "in_chns": 1,
        "class_num": 4, "patch_size": [256, 256]}


def test_forward_operations_by_hand():
    # enc0: 1->2, 2->2 at 8x8; enc1: 2->4, 4->4 at 4x4; tconv 4->2 from
    # 4x4; up0: 4->2, 2->2 at 8x8; head 2->4 at 8x8
    convs = [(1, 2, 64), (2, 2, 64), (2, 4, 16), (4, 4, 16), (4, 2, 64),
             (2, 2, 64), (2, 4, 64)]
    tconv = 2 * 4 * 4 * 2 * 16
    by_hand = sum(2 * 9 * c * o * px for c, o, px in convs) + tconv
    assert work.unet_forward_flops(TINY, 1) == by_hand == 37888


def test_backward_operations_by_hand():
    # twice the forward, less the stem's input gradient
    assert work.unet_backward_flops(TINY, 1) == 2 * 37888 - 2 * 9 * 1 * 2 * 64


def test_two_decoders_double_the_decoder():
    dec = 2 * 4 * 4 * 2 * 16 + sum(2 * 9 * c * o * 64
                                   for c, o in ((4, 2), (2, 2), (2, 4)))
    assert work.unet_forward_flops(TINY, 2) == 37888 + dec


def test_conv_bytes_by_hand():
    convs = work.unet_convs(TINY, 1)
    launches = {(n, r): (b, f) for n, r, b, f in
                work.conv3x3_launches(convs, 3, "bfloat16", True)}
    px = 3 * 64
    # the stem: forward with moments, weight gradient, no input gradient
    assert launches[("enc0.conv1", "fwd_stats")][0] == \
        (px * 1 + 9 * 1 * 2 + 2 + px * 2) * 2 + 2 * 2 * 4
    assert ("enc0.conv1", "dgrad") not in launches
    assert launches[("enc1.conv1", "dgrad")][0] == \
        (3 * 16 * 4 + 9 * 2 * 4 + 3 * 16 * 2) * 2
    assert launches[("enc1.conv1", "wgrad")][0] == \
        (3 * 16 * 2 + 3 * 16 * 4) * 2 + 9 * 2 * 4 * 4
    # the head has no BN: a plain forward
    assert ("dec0.head", "fwd") in launches
    infer = work.conv3x3_launches(convs, 3, "float32", False)
    assert {r for _, r, _, _ in infer} == {"fwd"} and len(infer) == 7


@pytest.mark.parametrize("name,decoders", [("unet.pce_b24", 1),
                                           ("unet_cct.dmpls_b6", 2)])
def test_a_step_counts_through_the_method(name, decoders):
    # the drivers' route: the method's work from the configuration's module
    cell = small_cell(name, hw=8, batch=3)
    cell.config.update(TINY)
    net, method = cell.reference_model(), cell.reference_method()
    flops, launches = method.work(net, cell.config, 3, "bfloat16")
    assert flops == 3 * (work.unet_forward_flops(TINY, decoders)
                         + work.unet_backward_flops(TINY, decoders))
    assert launches == work.conv3x3_launches(
        work.unet_convs(TINY, decoders), 3, "bfloat16", True)


def test_published_unet_counts():
    # 6.10 GFLOP a 256x256 slice; a b24 step about 439 GFLOP (XLA's 436.8
    # in BENCH_r05.json); the conv bound of a b24 step 0.83 ms in bf16 and
    # 6.343 ms in f32, as chip_smoke's per-launch sums (PERF.md, PR 17)
    cell = small_cell("unet.pce_b24", hw=256)
    net, method = cell.reference_model(), cell.reference_method()
    assert net.forward_flops(UNET) == pytest.approx(6.1006e9, rel=1e-4)
    flops, bf16 = method.work(net, UNET, 24, "bfloat16")
    assert flops == pytest.approx(438.8e9, rel=1e-3)
    _, f32 = method.work(net, UNET, 24, "float32")
    assert 1e3 * work.launches_bound_s(f32, "float32") == \
        pytest.approx(6.343, abs=1e-3)
    assert 1e3 * work.launches_bound_s(bf16, "bfloat16") == \
        pytest.approx(0.8335, abs=1e-3)
