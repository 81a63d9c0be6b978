#!/usr/bin/env python3
"""Smoke run of wsl4mis_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--detail PATH]

Run from the repository root. It needs CUDA and the CUDA toolkit (nvcc);
without a card it exits 2 and prints no result. Phases, each fatal on
failure:

1. The card (nvidia-smi name and power limit), and the build of every
   kernel from ``wsl4mis_torch/csrc`` (timed). ptxas must report no spill
   in any conv, augment or GatedCRF kernel, and every bf16 conv kernel's
   SASS (cuobjdump) must hold tensor-core instructions (HMMA / HGMMA;
   counts printed).
2. Kernels: each kernel of the training paths against its plain
   PyTorch version on the card, at the paths' shapes (every UNet 3x3 conv
   at 256x256, in bf16 and f32: forward, forward + moments, input
   gradient and weight gradient at batch 24, 12 and 6, the forward
   alone at the validation's 64-slice chunk and the s2l refresh's 32;
   the augmentation on all three branches at batch 24, 12 and 6, and
   every policy the sampler draws (the 40 angles, the 8 rot90 / flip
   pairs, the identity) on planes of 256, 200 (no multiple of the
   32-pixel tile) and 54 (no multiple of 4: the 4-byte route), and the
   same for its S2L variant (image, scribble and f32 weight rows, every
   map filled with 0) at batch 12 and 32; the 2x2 max pool at the four
   encoder levels, forward and backward at batch 24, 12 and 6 and the
   forward at 64 and 32, in bf16 and f32, on a tie-heavy input drawn
   from five levels and on a random one; the GatedCRF contraction, loss and
   gradient at (B, 256, 256), radius 5, for B = 6 and 24 with the default
   descriptor, at a ragged 40x72 with the default descriptor at radius 3
   and 5 and with two descriptors, the xy features built from the
   coordinates, and once with every feature read from memory). Off the
   paths, the conv
   also runs in all four roles at the ragged shapes of
   tests/test_torch_conv3x3.py (batch 2) and at 32->16, 256x256, batch 1;
   and every batch-24 bf16 conv launch is repeated and must be bit-equal.
   The host time of one call of each conv wrapper, the augment wrapper at
   batch 24, its S2L variant at 12 and the GatedCRF wrapper at batch 6 is
   recorded (wrapper_host_us), and one call of each of the last three
   runs under torch.cuda.set_sync_debug_mode("error"): a host-device sync
   fails the run. The batch-24 bf16 launches (GatedCRF: batch 6, its
   training batch, and 24; f32; the S2L augment: batch 12) are timed:
   CUDA-event medians of 12 calls after 3 warm-up calls (the augment and
   GatedCRF calls also in a torch.profiler trace of 10 calls: the
   kernels alone, kernel_ms), for the kernel, its plain version and,
   where one PyTorch call
   computes the same function, that call (library_ms; the S2L augment's
   trace must hold augment_s2l_kernel alone, no fill-flag kernel; cuDNN's
   conv, F.max_pool2d and its backward on a channels-last view). bound_ms
   is max(bytes / 3.35 TB/s, flops / peak) with bf16 at 989 TFLOP/s and
   f32 at 67 TFLOP/s (H100 SXM data sheet). Tolerances:
   f32 (TF32 off) 1e-4 of the largest reference magnitude; bf16 outputs 2
   bf16 ulps (ulp floored at 2^-8 of the largest magnitude); moments 1e-4
   of the largest, against the sums over the kernel's own y; weight
   gradient 1e-3 (f32) / 1e-2 (bf16) in norm;
   augmentation and max pool exact; GatedCRF: see check_gated_crf.
3. The training path at full width (features 16..256, 256x256, bf16) on
   synthetic phantom data made from --seed, through Trainer: fully_supervised
   (UNet, batch 24, 20 steps, one validation), pce (5 steps), dmpls
   (UNet_CCT, batch 6, 10 steps), pce_gatedcrf (UNet, batch 6, 10 steps)
   and 3 untimed steps each of pce_tv, pce_entropy_mini,
   pce_intensity_variance (batch 24) and pce_mumford_shah (batch 12);
   then the semi-supervised slice at batch 12, labeled_bs 6, each through
   its own make_bundle: uamt (10 steps, one validation; the paired stream
   over a staged [labeled; unlabeled] stack), ustm (10 steps, scribbles)
   and 3 untimed steps each of mean_teacher, entropy_minimization,
   partially_supervised and deep_adversarial; then slice 4: s2l (batch
   12, 10 steps, a refresh every 5 and the pseudo-label term open from
   step 5) and 3 untimed steps of pce_random_walker (batch 24) on the
   random walker's labels of 24 scribble slices (host scipy, timed).
   Launch counters are zeroed before each run and must show every kernel
   at its per-step count (STEP_PASSES: the teacher's and the MC passes'
   forwards, DAN's eval forwards; s2l's refreshes: an eval forward per
   32-slice chunk); losses must be finite and fall for fully_supervised;
   checkpoints must exist; an EMA teacher must have moved and differ from
   its student; DAN's discriminator must have taken an Adam update a step;
   s2l's buffer must have moved and its pseudo-label loss be non-zero
   once open, and one more refresh must launch exactly its chunks' eval
   forwards and leave the first chunk's rows at alpha * softmax + (1 -
   alpha) * w within 1e-6 of a separate eval forward (then its wall and
   device ms are recorded). Then, for the timed runs,
   ms/step and slices/s of each step in a synchronized loop of 10 steps,
   and a torch.profiler trace of the same 10 (device kernel time by name,
   the device's busy share).
4. Reference: a full-width UNet in f32, batch 2, at 64x64 and at 128x128
   on three seeds: its eval logits and train-mode loss and gradients on
   the card (kernels) against the same model on the CPU (plain
   versions), beside the CPU's own gradient spread and a known-wrong
   variant (bf16 kernels); see reference_check for the tolerances.

Output: detail lines, a per-conv table of the batch-24 step's conv
launches (conv-table lines), the per-kernel JSON line, the nvidia-smi
line, and last {"ok": true, "device": {...}}. All records also go to one
JSON file, build/chip_smoke/chip_smoke.json unless --detail names another.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N, HW = 24, 256  # fully_supervised / pce batch, slice size
DMPLS_N = 6  # dmpls and pce_gatedcrf batch
MS_N = 12  # pce_mumford_shah batch
SEMI_N = 12  # the semi-supervised methods', ustm's and s2l's batch
EVAL_N = 64  # slices per validation forward (VolumePredictor's chunk)
REFRESH_N = 32  # slices per eval forward of s2l's refresh sweep
RW_SLICES = 24  # synthetic slices labelled by the random walker (host scipy)
FEATURES = (16, 32, 64, 128, 256)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SRC_CONV = "wsl4mis_torch/csrc/conv3x3.cu"
PALLAS_CONV = "wsl4mis_tpu/ops/pallas/banded_conv_pallas.py"
SRC_POOL = "wsl4mis_torch/csrc/maxpool.cu"
PALLAS_POOL = "wsl4mis_tpu/ops/pallas/maxpool_pallas.py"
GCRF_RADIUS = 5
# device function names of the port's kernels, as a trace shows them: every
# __global__ of wsl4mis_torch/csrc (the conv's f32 SIMT kernels and its bf16
# tensor-core ones apart)
PORT_KERNELS = ("conv3x3_fwd_kernel", "conv3x3_wgrad_kernel",
                "conv3x3_fwd_mma_kernel", "conv3x3_wgrad_mma_kernel",
                "augment_fill_kernel", "augment_kernel",
                "augment_s2l_kernel",
                "maxpool_fwd_kernel", "maxpool_bwd_kernel",
                "gated_crf_kernel", "gated_crf_fold_kernel")
# the libraries whose ptxas report must show no spill
NO_SPILL = ("conv3x3", "augment", "gated_crf")
# augment planes: the path's, no multiple of the tile, no multiple of 4
AUG_PLANES = (256, 200, 54)
# (C, O, H, W) of tests/test_torch_conv3x3.py: the stem (C = 1), the head's
# dgrad family (C = 4), the head (O = 4), a width that is no multiple of 16
RAGGED_CONVS = ((1, 16, 8, 256), (4, 16, 8, 256), (16, 4, 8, 32),
                (32, 16, 8, 250))
TWO_DESC = ({"weight": 0.9, "xy": 6.0, "rgb": 0.1},
            {"weight": 0.1, "xy": 6.0})


def unet_convs():
    """(name, C, O, H) of the 19 UNet 3x3 convs at 256x256; the head last."""
    f = FEATURES
    out = []
    cin, h = 1, HW
    for i, c in enumerate(f):
        out += [(f"enc{i}.conv1", cin, c, h), (f"enc{i}.conv2", c, c, h)]
        cin, h = c, h // 2
    h = HW // 16
    for i, c in zip(range(4), (f[3], f[2], f[1], f[0])):
        h *= 2
        out += [(f"up{i}.conv1", 2 * c, c, h), (f"up{i}.conv2", c, c, h)]
    out.append(("head", f[0], 4, HW))
    return out


def unet_pools():
    """(name, C, H) of the input of the UNet encoder's four 2x2 pools."""
    return [(f"pool{i}", FEATURES[i], HW >> i) for i in range(4)]


def time_ms(fn, reps=12, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(prof):
    """(name, µs) of every device event of a torch.profiler trace, read
    from the profiler's raw results: prof.events() would first build the
    tree of every CPU op, which took most of a ten-step uamt profile's
    time."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        hidden = getattr(e, "is_hidden_event", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA and not hidden:
            out.append((e.name(), 1e-3 * e.duration_ns()))
    return out


def port_kernel_ms(events, calls):
    """Device ms per call (or step) of each of the port's kernels among
    the device events of a trace of `calls` calls."""
    own = {}
    for name, us in events:
        for kernel in PORT_KERNELS:
            if kernel in name:
                own[kernel] = own.get(kernel, 0.0) + 1e-3 * us / calls
    return own


def trace_ms(fn, reps=10):
    """The kernels alone: device ms per call of each of the port's kernels
    that fn launches, from a torch.profiler trace of `reps` calls after a
    warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return port_kernel_ms(device_events(prof), reps)


def bound(nbytes, flops, dtype):
    """{"bound_ms", "bound_by"}: the larger of the bytes' time at the
    memory rate and the operations' time at the type's peak rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ulp_err(got, want):
    """max |got - want| in bf16 ulps of want (floored at 2^-8 of max)."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.maximum(w.abs(), w.abs().max() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def rel_max(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def rel_norm(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


class Failure(RuntimeError):
    pass


def expect(ok, what):
    if not ok:
        raise Failure(what)


# ---- phase 2: kernels -------------------------------------------------------


def check_conv(name, c, o, h, dtype_name, n, timed, eval_only=False,
               dev="cuda", width=None, case=None, repeat=False):
    """Check (and, if timed, time) fwd, fwd_stats and wgrad at one conv
    shape (n, h, width or h, c -> o), and the dgrad (the fwd kernel on g
    with rotated weights). eval_only checks the fwd alone: the validation
    forward runs every conv through it. case tags the records (e.g.
    "ragged": off the training path); repeat also checks that a second
    call of each kernel is bit-equal to the first. Returns records."""
    import torch
    import torch.nn.functional as F

    from wsl4mis_torch.ops import conv3x3 as cv

    dt = getattr(torch, dtype_name)
    wd = width or h
    gen = torch.Generator(device=dev).manual_seed(c * 1009 + o * 7 + h)
    init = 1.0 / math.sqrt(9 * c)  # torch's default init bound
    x = torch.randn((n, h, wd, c), generator=gen, device=dev).to(dt)
    w = ((torch.rand((3, 3, c, o), generator=gen, device=dev) * 2 - 1)
         * init).to(dt)
    b = ((torch.rand((o,), generator=gen, device=dev) * 2 - 1)
         * init).to(dt)
    g = torch.randn((n, h, wd, o), generator=gen, device=dev).to(dt)
    w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
    es = x.element_size()
    px = n * h * wd
    flops = 2.0 * px * 9 * c * o
    recs = []

    def out_err(got, want):
        if dt == torch.bfloat16:
            e = ulp_err(got, want)
            return e, e <= 2.0, "ulp"
        e = rel_max(got, want)
        return e, e <= 1e-4, "rel"

    def lib_conv(inp, weight, bias):
        xi = inp.permute(0, 3, 1, 2)  # channels_last view, no copy
        wi = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xi, wi, bias, padding=1)

    def record(kernel, shape, got, want, err, ok, unit, nbytes, fn_k, fn_p,
               fn_l, extra=None):
        rec = {"kernel": kernel, "conv": name, "dtype": dtype_name,
               "shape": shape, "max_abs_err": float(
                   (got.float() - want.float()).abs().max()),
               "err": err, "err_unit": unit, "ok": ok,
               **bound(nbytes, flops, dtype_name)}
        if case:
            rec["case"] = case
        if extra:
            rec.update(extra)
        if repeat:
            rec["repeat_bit_equal"] = bit_equal(fn_k(), fn_k())
            ok = ok and rec["repeat_bit_equal"]
        if timed:
            rec["ms"] = time_ms(fn_k)
            rec["plain_ms"] = time_ms(fn_p)
            rec["library_ms"] = time_ms(fn_l) if fn_l else None
        recs.append(rec)
        print("kernel-check " + json.dumps(rec), flush=True)
        expect(ok, f"{kernel} {name} {dtype_name} {shape}: err {err} {unit}"
                   f", repeat {rec.get('repeat_bit_equal')}")

    # forward
    y = cv.conv3x3_fwd(x, w, b)
    yp = cv.conv3x3_plain(x, w, b)
    err, ok, unit = out_err(y, yp)
    nb_fwd = (px * c + 9 * c * o + o + px * o) * es
    record("conv3x3_fwd", [n, h, wd, c, o], y, yp, err, ok, unit, nb_fwd,
           lambda: cv.conv3x3_fwd(x, w, b), lambda: cv.conv3x3_plain(x, w, b),
           lib_conv(x, w, b), {"role": "eval"} if eval_only else None)
    if eval_only:
        return recs
    # forward + moments
    ys, s1, s2 = cv.conv3x3_fwd_stats(x, w, b)
    yps, p1, p2 = cv.conv3x3_stats_plain(x, w, b)
    err, ok, unit = out_err(ys, yps)
    # The moments are sums over the kernel's own rounded y: held to those
    # sums. Against the plain moments they also carry y's 1-ulp bf16
    # differences, which per-channel cancellation in sum y can magnify.
    yf = ys.float()
    m_err = max(rel_max(s1, yf.sum((0, 1, 2))),
                rel_max(s2, (yf * yf).sum((0, 1, 2))))
    record("conv3x3_fwd_stats", [n, h, wd, c, o], ys, yps, err,
           ok and m_err <= 1e-4, unit, nb_fwd + 2 * o * 4,
           lambda: cv.conv3x3_fwd_stats(x, w, b),
           lambda: cv.conv3x3_stats_plain(x, w, b), None,
           {"moments_rel_err": m_err,
            "moments_vs_plain_rel_err": max(rel_max(s1, p1),
                                            rel_max(s2, p2))})
    # input gradient: the forward kernel on g with rotated weights
    if name != "enc0.conv1":  # the stem needs no input gradient
        dx = cv.conv3x3_fwd(g, w_rot)
        dxp = cv.conv3x3_plain(g, w_rot)
        err, ok, unit = out_err(dx, dxp)
        record("conv3x3_fwd", [n, h, wd, o, c], dx, dxp, err, ok, unit,
               (px * o + 9 * c * o + px * c) * es,
               lambda: cv.conv3x3_fwd(g, w_rot),
               lambda: cv.conv3x3_plain(g, w_rot), lib_conv(g, w_rot, None),
               {"role": "dgrad"})
    # weight gradient
    dk = cv.conv3x3_wgrad(x, g)
    dkp = cv.conv3x3_wgrad_plain(x, g)
    err = rel_norm(dk, dkp)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-3
    xi, gi = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wi = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def lib_wgrad():
        return torch.ops.aten.convolution_backward(
            gi, xi, wi, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])

    record("conv3x3_wgrad", [n, h, wd, c, o], dk, dkp, err, err <= tol,
           "rel_norm", (px * c + px * o) * es + 9 * c * o * 4,
           lambda: cv.conv3x3_wgrad(x, g),
           lambda: cv.conv3x3_wgrad_plain(x, g), lib_wgrad)
    return recs


def bit_equal(a, b):
    """Whether two kernel results (a tensor or a tuple of them) are equal
    bit for bit."""
    import torch

    if isinstance(a, tuple):
        return all(bit_equal(u, v) for u, v in zip(a, b))
    return bool(torch.equal(a, b))


def augment_inputs(gen, b, h, dev="cuda", s2l=False):
    """A (b, h, h) image batch and int32 labels in 0..4, the first half of
    the samples without the ignore class 4; for s2l also (b, h, h, 4) f32
    weight rows in [0, 1)."""
    import torch

    images = torch.randn((b, h, h), generator=gen, device=dev)
    labels = torch.randint(0, 5, (b, h, h), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[: b // 2] = labels[: b // 2].clamp(max=3)  # half without class 4
    if s2l:
        return images, labels, torch.rand((b, h, h, 4), generator=gen,
                                          device=dev)
    return images, labels


def augment_record(case, maps, policy, timed):
    """The augment kernel against its plain version: every pixel equal.
    maps: (images, labels) for K4, (images, scribbles, weights) for its
    S2L variant (every map filled with 0, no fill-flag kernel: a timed
    record's trace must show augment_s2l_kernel alone)."""
    from wsl4mis_torch.ops import augment as ag

    s2l = len(maps) == 3
    b, h, _ = maps[0].shape
    if s2l:
        def kernel():
            return ag.augment_batch_s2l(*maps, policy)

        def plain():
            return ag.augment_batch_plain(maps[0], maps[1], policy,
                                          weights=maps[2], label_fill=0)
        name, dtype, px_bytes = "augment_s2l", "float32+int32+float32x4", 48
    else:
        def kernel():
            return ag.augment_batch(*maps, policy)

        def plain():
            return ag.augment_batch_plain(*maps, policy)
        name, dtype, px_bytes = "augment", "float32+int32", 16
    got, want = kernel(), plain()
    mismatched = int(sum(int((g != w).sum()) for g, w in zip(got, want)))
    rec = {"kernel": name, "case": case, "shape": [b, h, h],
           "dtype": dtype,
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           "mismatched_pixels": mismatched, "ok": mismatched == 0,
           "branches": sorted(set(policy[:, 0].tolist())),
           # each map read once and written once (bytes a pixel: 4 + 4 in
           # and out; S2L 4 + 4 + 16), and the policy
           **bound(b * h * h * px_bytes + b * 16, 0.0, "float32")}
    if timed:
        rec["ms"] = time_ms(kernel)
        rec["plain_ms"] = time_ms(plain)
        rec["library_ms"] = None
        rec["kernel_ms"] = trace_ms(kernel)
        if s2l:  # the fill-off route launches no fill-flag kernel
            rec["ok"] = rec["ok"] and set(rec["kernel_ms"]) == {
                "augment_s2l_kernel"}
    print("kernel-check " + json.dumps(rec), flush=True)
    expect(rec["ok"] and rec["branches"] == [0, 1, 2],
           f"{name} {case} {rec['shape']}: {mismatched} pixels differ from "
           f"the plain version; kernels traced {rec.get('kernel_ms')}")
    return rec


def check_augment(seed, b, timed, dev="cuda", s2l=False, case="path"):
    """The augment kernel (s2l: its S2L variant) against its plain version
    on a (b, 256, 256) batch. The first rows of the policy are set so that
    every batch of 3 or more holds all three branches; the rest are
    drawn. case "path" marks a batch a training step launches."""
    import torch

    from wsl4mis_torch.data.augment_device import sample_policy

    gen = torch.Generator(device=dev).manual_seed(seed)
    maps = augment_inputs(gen, b, HW, dev, s2l)
    flips = [(0, k, a, 0) for k in range(4) for a in range(2)]
    turns = [(1, 0, 0, ang) for ang in (-20, -13, -7, -1, 0, 5, 11, 19)]
    rows = [r for trio in zip(flips, turns, [(2, 0, 0, 0)] * 8)
            for r in trio][:b]
    policy = sample_policy(gen, maps[1])
    policy[: len(rows)] = torch.tensor(rows, dtype=torch.int32, device=dev)
    return [augment_record(case, maps, policy, timed)]


def check_augment_angles(seed, h, dev="cuda", s2l=False):
    """Every policy the sampler draws on one (49, h, h) batch: the 40
    rotation angles -20..19, the 8 rot90 / flip pairs and the identity."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = [(1, 0, 0, a) for a in range(-20, 20)]
    rows += [(0, k, a, 0) for k in range(4) for a in range(2)]
    rows.append((2, 0, 0, 0))
    maps = augment_inputs(gen, len(rows), h, dev, s2l)
    policy = torch.tensor(rows, dtype=torch.int32, device=dev)
    return [augment_record(f"all policies {h}x{h}", maps, policy, False)]


def check_pool(name, c, h, dtype_name, n, ties, timed, backward=True,
               dev="cuda"):
    """The max pool's forward (and backward) against the plain version at
    one encoder level and batch n: every element must be equal. `ties`
    draws the input from five levels (zeros among them), so that most
    windows tie and the first-max rule decides dx. Returns records."""
    import torch
    import torch.nn.functional as F

    from wsl4mis_torch.ops import maxpool as mp

    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(c * 31 + h + n + ties)
    if ties:
        x = (torch.randint(-2, 3, (n, h, h, c), generator=gen, device=dev)
             * 0.5).to(dt)
    else:
        x = torch.randn((n, h, h, c), generator=gen, device=dev).to(dt)
    g = torch.randn((n, h // 2, h // 2, c), generator=gen, device=dev).to(dt)
    es = x.element_size()
    recs = []

    def record(kernel, got, want, nbytes, fn_k, fn_p, fn_l):
        mismatched = int((got != want).sum())
        rec = {"kernel": kernel, "pool": name, "dtype": dtype_name,
               "shape": [n, h, h, c], "ties": ties,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "mismatched": mismatched, "ok": mismatched == 0,
               **bound(nbytes, 3.0 * got.numel(), dtype_name)}
        if timed:
            rec["ms"] = time_ms(fn_k)
            rec["plain_ms"] = time_ms(fn_p)
            rec["library_ms"] = time_ms(fn_l)
        recs.append(rec)
        print("kernel-check " + json.dumps(rec), flush=True)
        expect(rec["ok"], f"{kernel} {name} {dtype_name} n={n}: "
                          f"{mismatched} elements differ from the plain "
                          "version")

    xv = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    record("maxpool_fwd", mp.max_pool_2x2_fwd(x),
           mp.max_pool_2x2_fwd_plain(x), x.numel() * es * 5 // 4,
           lambda: mp.max_pool_2x2_fwd(x),
           lambda: mp.max_pool_2x2_fwd_plain(x),
           lambda: F.max_pool2d(xv, 2, 2))
    if not backward:
        return recs
    gv = g.permute(0, 3, 1, 2)
    _, idx = torch.ops.aten.max_pool2d_with_indices(xv, [2, 2], [2, 2])
    record("maxpool_bwd", mp.max_pool_2x2_bwd(x, g),
           mp.max_pool_2x2_bwd_plain(x, g), x.numel() * es * 9 // 4,
           lambda: mp.max_pool_2x2_bwd(x, g),
           lambda: mp.max_pool_2x2_bwd_plain(x, g),
           lambda: torch.ops.aten.max_pool2d_with_indices_backward(
               gv, xv, [2, 2], [2, 2], [0, 0], [1, 1], False, idx))
    return recs


def gcrf_work(b, h, w, c, radius, nf_splits):
    """(bytes, f32 operations) of one GatedCRF contraction: probs and feats
    read once, prod written once; per pixel and non-centre offset, per
    descriptor 3 operations per feature (subtract, square, add) and 4 for
    the -0.5 scale, the exp and the weighted add, then a multiply-add per
    class for prod and one add for sum k. The work does not depend on the
    data (outside offsets are computed, not skipped)."""
    f = sum(nf_splits)
    offsets = (2 * radius + 1) ** 2 - 1
    per_offset = sum(3 * nf + 4 for nf in nf_splits) + 2 * c + 1
    return b * h * w * (2 * c + f) * 4, float(b * h * w * offsets * per_offset)


def gcrf_inputs(b, h, w, seed, dev="cuda"):
    """Softmax probabilities (b,h,w,4) of sharp random logits and an image
    (b,h,w,1) in [0, 1] that is piecewise constant on 8x8 cells plus 0.02
    noise, so that the rgb kernel (sigma 0.1) is neither all 0 nor all 1."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    probs = torch.softmax(
        2.0 * torch.randn((b, h, w, 4), generator=gen, device=dev), -1)
    cells = torch.rand((b, -(-h // 8), -(-w // 8)), generator=gen, device=dev)
    image = cells.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w]
    image = image + 0.02 * torch.randn((b, h, w), generator=gen, device=dev)
    return probs, image.clamp(0, 1)[..., None].contiguous()


def check_gated_crf(b, h, w, radius, kernels_desc, timed, seed, role,
                    dev="cuda", stored_xy=False):
    """The GatedCRF contraction, loss and gradient against the plain loop.
    role "path" marks the shape the pce_gatedcrf step launches. The
    contraction takes the path's route (split_features: the kernel builds
    the xy features from the coordinates) unless stored_xy, where every
    feature, the xy meshes too, comes in from memory; the plain loop always
    takes the full stacked features.

    Tolerances, all f32 against f32 with the pixel sums folded in f64 on
    both sides: prod (a sum of (2r+1)^2-1 terms of k p <= sum(w) per pixel,
    in another order, with expf against torch.exp) within 1e-5 of its
    largest magnitude; per-image sum k within 1e-6 relative; the loss
    within 1e-5 of sum k / (B H W), the scale of the two sums whose
    difference it is; grad_probs (the Function's -2 g prod / (B H W)
    against autograd through the plain loop) within 1e-5 of its largest
    magnitude."""
    import torch

    from wsl4mis_torch.ops import gated_crf as gc

    probs, image = gcrf_inputs(b, h, w, seed, dev)
    feats, weights, splits = gc.stacked_features(image, kernels_desc, h, w)
    if stored_xy:
        args = (feats, radius, weights, splits)
    else:
        planes, _, nf, xy = gc.split_features(image, kernels_desc, h, w)
        args = (planes, radius, weights, nf, xy)
    prod, ksum = gc.gated_crf_products(probs, *args)
    prod_p, ksum_p = gc.gated_crf_products_plain(probs, feats, radius,
                                                 weights, splits)
    p1 = probs.clone().requires_grad_()
    loss = gc.gated_crf_loss(p1, image, kernels_desc, radius)
    loss.backward()
    p2 = probs.clone().requires_grad_()
    loss_p = gc.gated_crf_loss_plain(p2, image, kernels_desc, radius)
    loss_p.backward()
    loss, loss_p = float(loss.detach()), float(loss_p.detach())
    scale = float(ksum_p.sum()) / (b * h * w)
    nbytes, ops = gcrf_work(b, h, w, probs.shape[-1], radius, splits)
    rec = {"kernel": "gated_crf", "dtype": "float32",
           "shape": [b, h, w, probs.shape[-1], feats.shape[-1]],
           "radius": radius, "descriptors": len(weights), "role": role,
           "xy": "stored" if stored_xy else "coordinates",
           "max_abs_err": float((prod - prod_p).abs().max()),
           "prod_rel_err": rel_max(prod, prod_p),
           "ksum_rel_err": float(((ksum - ksum_p).abs() / ksum_p).max()),
           "loss": loss, "plain_loss": loss_p,
           "loss_err_over_ksum_term": abs(loss - loss_p) / scale,
           "grad_rel_err": rel_max(p1.grad, p2.grad),
           "finite": bool(torch.isfinite(prod).all()
                          and torch.isfinite(p1.grad).all()),
           **bound(nbytes, ops, "float32")}
    rec["ok"] = (rec["finite"] and rec["prod_rel_err"] <= 1e-5
                 and rec["ksum_rel_err"] <= 1e-6
                 and rec["loss_err_over_ksum_term"] <= 1e-5
                 and rec["grad_rel_err"] <= 1e-5)
    if timed:
        rec["ms"] = time_ms(lambda: gc.gated_crf_products(probs, *args))
        rec["plain_ms"] = time_ms(lambda: gc.gated_crf_products_plain(
            probs, feats, radius, weights, splits), reps=3, warmup=1)
        rec["library_ms"] = None
        rec["kernel_ms"] = trace_ms(
            lambda: gc.gated_crf_products(probs, *args))
    print("kernel-check " + json.dumps(rec), flush=True)
    expect(rec["ok"], f"gated_crf {rec['shape']}: {rec}")
    return [rec]


# ---- phase 3: the training path ---------------------------------------------


def _counters():
    """The launch counters of every kernel wrapper of the port."""
    from wsl4mis_torch.ops import augment, conv3x3, gated_crf, maxpool

    return [m.launches for m in (conv3x3, augment, maxpool, gated_crf)]


def launch_counts():
    return {k: v for d in _counters() for k, v in d.items()}


def reset_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


# (train-mode forwards, backwards, eval forwards) a step, where not (1, 1, 0):
# a semi-supervised step runs the student on the labeled and the unlabeled
# part apart, the EMA teacher once, UAMT / USTM 4 MC passes of the doubled
# batch (all under no_grad), DAN the updated segmenter in eval mode on both
# parts
STEP_PASSES = {"partially_supervised": (1, 1, 0),
               "entropy_minimization": (2, 2, 0),
               "mean_teacher": (3, 2, 0), "uamt": (7, 2, 0),
               "deep_adversarial": (2, 2, 2), "ustm": (6, 1, 0)}
SEMI = ("mean_teacher", "uamt", "entropy_minimization",
        "partially_supervised", "deep_adversarial")  # paired data
EMA = ("mean_teacher", "uamt", "ustm")  # with an EMA teacher


def _unet_sizes(model_name):
    """(decoders, ConvBlocks, 3x3 convs) of a UNet or UNet_CCT."""
    decoders = 2 if model_name == "unet_cct" else 1
    blocks = 10 + 8 * decoders
    return decoders, blocks, blocks + decoders


def eval_counts(model_name):
    """Launches of one eval-mode forward: every conv a fwd launch, the
    encoder's four pools."""
    return {"conv3x3_fwd": _unet_sizes(model_name)[2], "maxpool_fwd": 4}


def per_step_counts(model_name, method=None):
    """Expected launches per training step. A train-mode forward: every
    ConvBlock conv a stats launch, each head a fwd launch, the encoder's
    four pools; a backward: every conv but the stem a dgrad (fwd) launch,
    every conv a wgrad launch, four pool backwards; an eval forward:
    eval_counts. One augment launch (s2l: one of its S2L variant, which
    launches no fill-flag kernel), and one GatedCRF contraction for
    pce_gatedcrf (its backward is an elementwise scale, no launch)."""
    fwd, bwd, evl = STEP_PASSES.get(method, (1, 1, 0))
    decoders, blocks, convs = _unet_sizes(model_name)
    ev = eval_counts(model_name)
    return {"conv3x3_fwd_stats": blocks * fwd,
            "conv3x3_fwd": decoders * fwd + (convs - 1) * bwd
            + ev["conv3x3_fwd"] * evl,
            "conv3x3_wgrad": convs * bwd, "augment": int(method != "s2l"),
            "augment_s2l": int(method == "s2l"),
            "maxpool_fwd": 4 * fwd + ev["maxpool_fwd"] * evl,
            "maxpool_bwd": 4 * bwd, "gated_crf": int(method == "pce_gatedcrf")}


def refresh_counts(model_name, n_slices):
    """Launches of one s2l refresh sweep over n_slices: an eval forward per
    chunk of REFRESH_N slices (the last one zero-padded)."""
    chunks = -(-n_slices // REFRESH_N)
    return {k: v * chunks for k, v in eval_counts(model_name).items()}


def check_refresh(bundle, cfg, model_name):
    """One more refresh through the bundle's host hook, after the run: its
    launches exactly refresh_counts; the first chunk's rows equal alpha *
    softmax(eval logits) + (1 - alpha) * w_before to 1e-6, the logits from a
    separate eval forward of that 32-slice chunk (the same launch shape,
    and the conv kernels repeat bit for bit); then the wall ms of one sweep
    (synchronized), its device ms (a torch.profiler trace of another), and
    the wall amortised per step at the reference period_iter of 100."""
    import torch

    from wsl4mis_torch.engine.config import TrainConfig

    state = bundle.state
    weight = state.extra["weight"]
    images = bundle.aux["images"]
    n = images.shape[0]
    with torch.no_grad():
        logits = bundle.model(images[:REFRESH_N, ..., None], train=False)
    want = (cfg.alpha * torch.softmax(logits.float(), dim=-1)
            + (1 - cfg.alpha) * weight[:REFRESH_N])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.host_hook(bundle, state, cfg.period_iter)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for k, v in launch_counts().items() if v}
    expected = refresh_counts(model_name, n)
    err = float((weight[:REFRESH_N] - want).abs().max())
    wall2 = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.host_hook(bundle, state, cfg.period_iter)
        torch.cuda.synchronize()
        wall2.append(1e3 * (time.perf_counter() - t0))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bundle.host_hook(bundle, state, cfg.period_iter)
        torch.cuda.synchronize()
    events = device_events(prof)
    period = TrainConfig().period_iter
    wall = min([wall_ms] + wall2)
    rec = {"slices": n, "chunk": REFRESH_N, "launches": counts,
           "expected": expected, "max_abs_err": err,
           "wall_ms": [wall_ms] + wall2,
           "device_ms": 1e-3 * sum(us for _, us in events),
           "port_kernels_ms": port_kernel_ms(events, 1),
           "reference_period_iter": period,
           "wall_ms_per_step_at_reference_period": wall / period,
           "finite": bool(torch.isfinite(weight).all())}
    print("s2l-refresh " + json.dumps(rec), flush=True)
    expect(counts == expected, f"s2l refresh: launches {counts} != "
                               f"{expected}")
    expect(err <= 1e-6 and rec["finite"],
           f"s2l refresh: buffer off the EMA update by {err}")
    return rec


def method_bundle(cfg, data, val):
    """(cfg.method's bundle on in-memory data, a maker of fresh batch
    streams like its own). The semi-supervised methods, ustm and s2l build
    theirs with make_bundle (the semi family: data = (labeled, unlabeled),
    the paired stream over the staged [labeled; unlabeled]); the others as
    their build() does."""
    from wsl4mis_torch.engine.methods import get_method
    from wsl4mis_torch.engine.methods.common import (
        MethodBundle,
        index_batches,
        make_model_and_state,
        paired_data,
        stage_dataset,
    )

    mod = get_method(cfg.method)
    if cfg.method in SEMI:
        return (mod.make_bundle(cfg, *data, val),
                lambda: paired_data(cfg, *data)[1])
    if cfg.method in ("ustm", "s2l"):
        bundle = mod.make_bundle(cfg, data, val)
    else:
        model, state = make_model_and_state(cfg)
        bundle = MethodBundle(
            model=model, state=state, step_fn=mod.make_step(cfg),
            data_iter=index_batches(cfg, data), val_volumes=val,
            steps_per_epoch=len(data) // cfg.batch_size,
            aux=stage_dataset(cfg, data))
    return bundle, lambda: index_batches(cfg, data)


def sup_type_of(method):
    if method == "pce_random_walker":
        return "random_walker"
    return ("label" if method == "fully_supervised" or method in SEMI
            else "scribble")


def run_method(method, model_name, batch, steps, validate, data, val,
               seed, time_steps=10, **flags):
    """Train `steps` steps through Trainer (flags: more TrainConfig fields)
    and check launches, losses and checkpoints; then, if time_steps, time
    and profile that many more steps. s2l: the host hook's refreshes enter
    the expected launches, and check_refresh checks and times one more."""
    import numpy as np
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.trainer import Trainer

    start = time.perf_counter()
    snap_root = os.path.join(ROOT, "build", "chip_smoke", method)
    cfg = TrainConfig(
        method=method, model=model_name, batch_size=batch,
        labeled_bs=batch // 2,
        max_iterations=steps, val_every=(steps if validate else 10 ** 9),
        ckpt_every=steps, log_every=5, compute_dtype="bfloat16",
        snapshot_root=snap_root, seed=seed, device="cuda",
        sup_type=sup_type_of(method), **flags,
    )
    bundle, new_batches = method_bundle(cfg, data, val)
    state, step_fn = bundle.state, bundle.step_fn
    losses, vals, loss_u = [], [], []

    def recording_step(state, batch, rngs, aux=None):
        m = step_fn(state, batch, rngs, aux)
        losses.append(m["total_loss"])
        if "loss_u" in m:
            loss_u.append(m["loss_u"])
        return m

    bundle.step_fn = recording_step
    ema = state.extra["ema_params"] if method in EMA else {}
    ema_start = {k: v.clone() for k, v in ema.items()}
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    validate_fn = trainer.validate
    trainer.validate = lambda it: vals.append(validate_fn(it)) or vals[-1]

    gc.collect()  # the earlier runs' bundles (cycles through their Trainer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    per = per_step_counts(model_name, method)
    expected = {k: v * steps for k, v in per.items()}
    if validate:  # eval forwards, one per chunk of slices
        depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in val)
        chunks = -(-depth // EVAL_N)
        for k, v in eval_counts(model_name).items():
            expected[k] += v * chunks
    if method == "s2l":  # the refreshes: eval forwards of the train stack
        for k, v in refresh_counts(model_name, len(data)).items():
            expected[k] += v * (steps // cfg.period_iter)
    loss_vals = [float(v) for v in losses]
    rec = {"method": method, "model": model_name, "batch": batch,
           "steps": steps, "launches": counts, "expected": expected,
           "per_step": per, "losses": loss_vals, "val": vals,
           "trainer_wall_s": wall}
    expect(counts == expected, f"{method}: launches {counts} != {expected}")
    expect(all(np.isfinite(loss_vals)), f"{method}: non-finite loss")
    expect(len(loss_vals) == steps, f"{method}: {len(loss_vals)} steps")
    if validate:
        expect(len(vals) == 1 and all(np.isfinite(vals[0])),
               f"{method}: validation {vals}")
    for name in (f"iter_{steps}.pth", "latest_full.ckpt"):
        expect(os.path.isfile(os.path.join(cfg.snapshot_path, name)),
               f"{method}: checkpoint {name} missing")
    if ema:  # the teacher follows the student, and lags it
        student = {k: p.detach() for k, p in bundle.model.named_parameters()}
        rec["ema_moved"] = max(float((ema[k] - ema_start[k]).abs().max())
                               for k in ema)
        rec["ema_student_gap"] = max(float((ema[k] - student[k]).abs().max())
                                     for k in ema)
        expect(rec["ema_moved"] > 0 and rec["ema_student_gap"] > 0,
               f"{method}: EMA teacher moved {rec['ema_moved']}, from the "
               f"student {rec['ema_student_gap']}")
    if method == "deep_adversarial":
        adam = state.extra["disc_opt_state"]
        expect(adam["count"] == steps and all(
            float(m.abs().max()) > 0 for m in adam["mu"].values()),
            f"{method}: discriminator Adam count {adam['count']}")
    if method == "s2l":  # the buffer moved; the gated term once it opens
        rec["loss_u"] = [float(v) for v in loss_u]
        rec["weight_max"] = float(state.extra["weight"].max())
        gated = rec["loss_u"][cfg.thr_iter:]
        expect(rec["weight_max"] > 0 and gated and all(v > 0 for v in gated),
               f"s2l: weight buffer max {rec['weight_max']}, loss_u after "
               f"step {cfg.thr_iter}: {gated}")
        rec["refresh"] = check_refresh(bundle, cfg, model_name)

    if time_steps:
        it = new_batches()
        rec.update(time_step(step_fn, state, bundle.aux, cfg,
                             [next(it) for _ in range(time_steps)], seed))
    rec["run_s"] = time.perf_counter() - start
    print("slice-run " + json.dumps(rec), flush=True)
    return rec


def time_step(step_fn, state, aux, cfg, batches, seed):
    """Steady-state step time (a synchronized loop over the batches after
    one warm step), the host's share of it, peak memory, and a profile of
    the same steps."""
    import torch

    from wsl4mis_torch.engine.methods.common import split_rngs

    time_steps = len(batches)
    rngs = [split_rngs(seed, 1000 + i, "cuda") for i in range(time_steps)]
    step_fn(state, batches[0], rngs[0], aux)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt, rg in zip(batches, rngs):
        step_fn(state, bt, rg, aux)
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / time_steps
    return {"ms_per_step": ms, "slices_per_s": 1e3 * cfg.batch_size / ms,
            # until the host has issued the last step (it waits inside a
            # step only where the step reads a value back)
            "host_ms_per_step": 1e3 * (t_host - t0) / time_steps,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": profile_steps(step_fn, state, batches, rngs, aux)}


def profile_steps(step_fn, state, batches, rngs, aux, top=12):
    """torch.profiler over the given steps: device kernel time by name
    (the top ones, and each of the port's own kernels), the device's busy
    share of the window, and the window's ms/step (the profiler slows the
    host side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bt, rg in zip(batches, rngs):
            step_fn(state, bt, rg, aux)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = device_events(prof)
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    expect(busy_us > 0, "profile: no device time recorded")
    steps = len(batches)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"ms_per_step": 1e-3 * wall_us / steps,
            "port_kernels_ms_per_step": port_kernel_ms(events, steps),
            "device_busy_ms_per_step": 1e-3 * busy_us / steps,
            "device_busy_share": busy_us / wall_us,
            "top_kernels_ms_per_step": [[name[:80], 1e-3 * us / steps]
                                        for name, us in rows[:top]]}


# ---- phase 4: reference on a small input ------------------------------------


REF_INPUTS = ((64, 0), (128, 0), (128, 1), (128, 2))  # (size, seed offset)
PERTURB_DRAWS = 3
GRAD_TOL = 5e-2  # between the spread and the wrong variant: PERF.md


def ref_case(seed, hw):
    """(model, x, labels, generator): a full-width f32 UNet without dropout
    (train mode makes no random draws) and a (2, hw, hw) input with labels,
    drawn in that order from one CPU generator seeded with `seed`."""
    import torch

    from wsl4mis_torch.models import net_factory

    gen = torch.Generator().manual_seed(seed)
    model = net_factory("unet", 4, dtype=torch.float32, generator=gen,
                        dropout=(0.0,) * 5)
    x = torch.randn((2, hw, hw, 1), generator=gen)
    lab = torch.randint(0, 4, (2, hw, hw), generator=gen, dtype=torch.int32)
    return model, x, lab, gen


def loss_and_grads(model, x, lab):
    """Train-mode cross-entropy and every conv kernel's gradient (CPU f32)."""
    from wsl4mis_torch.ops import losses

    model.zero_grad()
    loss = losses.cross_entropy(model(x, train=True), lab, ignore_index=4)
    loss.backward()
    return loss.item(), {k: p.grad.detach().float().cpu()
                         for k, p in model.named_parameters()
                         if k.endswith("kernel")}


def grad_err(got, want):
    """The largest norm-relative error over the kernel gradients."""
    return max(rel_norm(got[k], want[k]) for k in want)


def cpu_spread(model, x, lab, grads, gen, draws=PERTURB_DRAWS):
    """The CPU's own gradient spread at one input, against its `grads`:
    (reversed batch, the largest of `draws` input scalings by 1 + 1e-6
    noise). Neither changes the function, only f32 rounding."""
    import torch

    _, g_rev = loss_and_grads(model, x.flip(0), lab.flip(0))
    perturb = 0.0
    for _ in range(draws):
        noise = torch.randn(x.shape, generator=gen)
        _, g_p = loss_and_grads(model, x * (1 + 1e-6 * noise), lab)
        perturb = max(perturb, grad_err(g_p, grads))
    return grad_err(g_rev, grads), perturb


@contextlib.contextmanager
def bf16_kernels():
    """A known-wrong variant for the gradient check: every conv kernel call
    rounds its operands to bf16 (and computes and stores in bf16) while the
    rest of the f32 model stays f32."""
    import torch

    from wsl4mis_torch.ops import conv3x3 as cv

    names = ("conv3x3_fwd", "conv3x3_fwd_stats", "conv3x3_wgrad")
    saved = {k: getattr(cv, k) for k in names}
    bf = torch.bfloat16

    def fwd(x, w, b=None):
        return saved["conv3x3_fwd"](
            x.to(bf), w.to(bf), None if b is None else b.to(bf)).float()

    def fwd_stats(x, w, b=None):
        y, s1, s2 = saved["conv3x3_fwd_stats"](
            x.to(bf), w.to(bf), None if b is None else b.to(bf))
        return y.float(), s1, s2

    def wgrad(x, g):
        return saved["conv3x3_wgrad"](x.to(bf), g.to(bf))

    for k, fn in zip(names, (fwd, fwd_stats, wgrad)):
        setattr(cv, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(cv, k, fn)


def reference_check(seed):
    """Full-width f32 UNet, batch 2, at each of REF_INPUTS: the card
    (kernels) against the CPU (plain versions) in eval logits, train-mode
    loss and every conv kernel's gradient.

    The training gradient is not a smooth function of f32 rounding: a
    max-pool near-tie or a LeakyReLU input near 0 routes a gradient
    differently under another summation order and moves every upstream
    kernel gradient at once. So each input also records the CPU's own
    spread (cpu_spread) and the error of bf16_kernels, a variant that is
    wrong by design. GRAD_TOL must lie above every spread and the card's
    error, and below every reading of the wrong variant; a wrong dgrad,
    wgrad or moment fold is off by O(1)."""
    import copy

    import torch

    rows = []
    for hw, offset in REF_INPUTS:
        cpu, x, lab, gen = ref_case(seed + offset, hw)
        gpu = copy.deepcopy(cpu).cuda()
        xg, lg = x.cuda(), lab.cuda()
        with torch.no_grad():
            want = cpu(x, train=False)
            got = gpu(xg, train=False).cpu()
        loss_c, grad_c = loss_and_grads(cpu, x, lab)
        loss_g, grad_g = loss_and_grads(gpu, xg, lg)
        with bf16_kernels():
            _, grad_w = loss_and_grads(gpu, xg, lg)
        reorder, perturb = cpu_spread(cpu, x, lab, grad_c, gen)
        errs = sorted(((rel_norm(grad_g[k], grad_c[k]), k) for k in grad_c),
                      reverse=True)
        row = {"input": [2, hw, hw, 1], "seed": seed + offset,
               "eval_logits_rel_err": rel_max(got, want),
               "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
               "max_kernel_grad_rel_norm_err": errs[0][0],
               "median_kernel_grad_rel_norm_err": errs[len(errs) // 2][0],
               "worst_kernel_grads": [[k, e] for e, k in errs[:3]],
               "cpu_reorder_err": reorder, "cpu_perturb_err": perturb,
               "bf16_kernels_err": grad_err(grad_w, grad_c),
               "logits_finite": bool(torch.isfinite(got).all()),
               "logits_shape": list(got.shape)}
        print("reference " + json.dumps(row), flush=True)
        rows.append(row)
        expect(row["logits_finite"] and row["logits_shape"] == [2, hw, hw, 4],
               f"reference {hw}: logits")
        expect(row["eval_logits_rel_err"] <= 1e-3,
               f"reference {hw}: eval logits rel err "
               f"{row['eval_logits_rel_err']}")
        expect(row["loss_rel_err"] <= 1e-4,
               f"reference {hw}: loss rel err {row['loss_rel_err']}")
    rec = {"grad_tol": GRAD_TOL, "inputs": rows,
           "card_err": max(r["max_kernel_grad_rel_norm_err"] for r in rows),
           "cpu_spread": max(max(r["cpu_reorder_err"], r["cpu_perturb_err"])
                             for r in rows),
           "wrong_variant_err": min(r["bf16_kernels_err"] for r in rows)}
    print("reference-summary " + json.dumps(
        {k: v for k, v in rec.items() if k != "inputs"}), flush=True)
    expect(rec["card_err"] <= GRAD_TOL,
           f"reference: grad rel err {rec['card_err']} > {GRAD_TOL}")
    expect(rec["cpu_spread"] <= GRAD_TOL,
           f"reference: the CPU's own spread {rec['cpu_spread']} exceeds "
           f"the tolerance {GRAD_TOL}")
    expect(rec["wrong_variant_err"] > GRAD_TOL,
           f"reference: bf16 kernels pass the f32 check "
           f"({rec['wrong_variant_err']} <= {GRAD_TOL})")
    return rec


# ---- main --------------------------------------------------------------------


def summarize(recs, launches):
    """Per-kernel JSON entries: times summed over one fully_supervised
    training step's shapes (bf16, batch 24, the timed records; for
    gated_crf one pce_gatedcrf step's launch, f32, batch 6; for
    augment_s2l one s2l step's launch, batch 12); max_abs_err over every
    check, in the path's dtype, of a launch on a training path (batches
    24, 12 and 6, the validation forward and the refresh's)."""
    rows = {
        "conv3x3_fwd": (SRC_CONV, f"{PALLAS_CONV}:329", "bfloat16"),
        "conv3x3_fwd_stats": (SRC_CONV, f"{PALLAS_CONV}:340", "bfloat16"),
        "conv3x3_wgrad": (SRC_CONV, f"{PALLAS_CONV}:377", "bfloat16"),
        "augment": ("wsl4mis_torch/csrc/augment.cu",
                    "wsl4mis_tpu/ops/pallas/augment_pallas.py:137",
                    "float32+int32"),
        # no Pallas kernel: the JAX package runs this one in XLA
        "augment_s2l": ("wsl4mis_torch/csrc/augment.cu",
                        "wsl4mis_tpu/data/augment_device.py:108",
                        "float32+int32+float32x4"),
        "gated_crf": ("wsl4mis_torch/csrc/gated_crf.cu",
                      "wsl4mis_tpu/ops/pallas/gated_crf_pallas.py:37",
                      "float32"),
        "maxpool_fwd": (SRC_POOL, f"{PALLAS_POOL}:70", "bfloat16"),
        "maxpool_bwd": (SRC_POOL, f"{PALLAS_POOL}:92", "bfloat16"),
    }
    out = []
    for name, (source, replaces, dtype) in rows.items():
        path = [r for r in recs if r["kernel"] == name
                and r["dtype"] == dtype and _on_path(r)]
        mine = [r for r in path if "ms" in r]
        lib = [r["library_ms"] for r in mine]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": _bound_by(mine),
            "library_ms": None if None in lib else sum(lib),
        })
    return out


def _bound_by(recs):
    """What bounds a sum of launches: the side holding most of its bound."""
    by_bytes = sum(r["bound_ms"] for r in recs if r["bound_by"] == "bytes")
    total = sum(r["bound_ms"] for r in recs)
    return "bytes" if 2 * by_bytes >= total else "operations"


def _on_path(r):
    """Whether a kernel-check record is a launch of the training path:
    the stats kernel runs for ConvBlock convs, the fwd kernel for the
    head, for every dgrad and for every conv of the validation forward.
    The ragged shapes are no launch of a path."""
    if r.get("case") == "ragged":
        return False
    if r["kernel"] == "conv3x3_fwd_stats":
        return r["conv"] != "head"
    if r["kernel"] == "conv3x3_fwd":
        return r.get("role") in ("dgrad", "eval") or r["conv"] == "head"
    if r["kernel"] == "gated_crf":
        return r["role"] == "path"
    if r["kernel"] in ("augment", "augment_s2l"):
        return r.get("case", "path") == "path"
    return True


def conv_table(recs):
    """Markdown rows, one per UNet conv, of the b24 bf16 step's conv
    launches: the forward (fwd_stats, fwd for the head), the dgrad and
    the wgrad, each as ms / bound ms / cuDNN ms (the forward's cuDNN is
    F.conv2d, which computes no moments)."""
    mine = {}
    for r in recs:
        if (r["kernel"].startswith("conv3x3") and r["dtype"] == "bfloat16"
                and "ms" in r and r["shape"][0] == N
                and r.get("case") is None and _on_path(r)):
            role = ("wgrad" if r["kernel"] == "conv3x3_wgrad"
                    else r.get("role") or "fwd")
            mine[(r["conv"], role)] = r
    lib_fwd = {r["conv"]: r["library_ms"] for r in recs
               if r["kernel"] == "conv3x3_fwd" and "ms" in r
               and r["dtype"] == "bfloat16" and r.get("role") is None
               and r.get("case") is None and r["shape"][0] == N}

    def cell(r, lib=None):
        if r is None:
            return "—"
        lib = r["library_ms"] if lib is None else lib
        lib = "—" if lib is None else f"{lib:.4f}"
        return f"{r['ms']:.4f} / {r['bound_ms']:.4f} / {lib}"

    rows = ["| conv | C→O | H | fwd(+stats) ms / bound / cuDNN | dgrad | "
            "wgrad |", "|---|---|---|---|---|---|"]
    for name, c, o, h in unet_convs():
        fwd = mine.get((name, "fwd"))
        dg = mine.get((name, "dgrad"))
        rows.append(f"| {name} | {c}→{o} | {h} | {cell(fwd, lib_fwd.get(name))}"
                    f" | {cell(dg)} | {cell(mine.get((name, 'wgrad')))} |")
    return rows


def wrapper_calls():
    """(name, call, reps) of one call of each wrapper whose host time is
    recorded: the conv wrappers on a bf16 6x16x16x64 -> 64 conv, too small
    for the device to be the limit; the augment wrapper at the fs24 step's
    batch, its S2L variant at the s2l step's and the GatedCRF contraction
    at the pce_gatedcrf step's, their path shapes (fewer calls, so that
    the launch queue never fills)."""
    import torch

    from wsl4mis_torch.data.augment_device import sample_policy
    from wsl4mis_torch.ops import augment as ag
    from wsl4mis_torch.ops import conv3x3 as cv
    from wsl4mis_torch.ops import gated_crf as gc

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((6, 16, 16, 64), generator=gen, device="cuda").bfloat16()
    w = (0.1 * torch.randn((3, 3, 64, 64), generator=gen,
                           device="cuda")).bfloat16()
    b = torch.randn((64,), generator=gen, device="cuda").bfloat16()
    images, labels = augment_inputs(gen, N, HW)
    policy = sample_policy(gen, labels)
    s2l_maps = augment_inputs(gen, SEMI_N, HW, s2l=True)
    s2l_policy = sample_policy(gen, s2l_maps[1])
    probs, image = gcrf_inputs(DMPLS_N, HW, HW, 7)
    desc = gc.DEFAULT_KERNELS_DESC
    planes, weights, nf, xy = gc.split_features(image, desc, HW, HW)
    return [
        ("conv3x3_fwd", lambda: cv.conv3x3_fwd(x, w, b), 300),
        ("conv3x3_fwd_stats", lambda: cv.conv3x3_fwd_stats(x, w, b), 300),
        ("conv3x3_wgrad", lambda: cv.conv3x3_wgrad(x, x), 300),
        ("augment", lambda: ag.augment_batch(images, labels, policy), 100),
        ("augment_s2l", lambda: ag.augment_batch_s2l(*s2l_maps, s2l_policy),
         100),
        ("gated_crf", lambda: gc.gated_crf_products(
            probs, planes, GCRF_RADIUS, weights, nf, xy), 100),
    ]


def wrapper_host_us(calls):
    """Host time of one call of each wrapper: the mean over `reps` calls
    enqueued back to back, before the closing synchronize."""
    import torch

    out = {}
    for name, fn, reps in calls:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
    return out


def check_sync_free(calls, names=("augment", "augment_s2l", "gated_crf")):
    """One call of each named wrapper under torch.cuda.set_sync_debug_mode(
    "error"), in which any host-device synchronization raises."""
    import torch

    for name, fn, _ in calls:
        if name not in names:
            continue
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as err:
            raise Failure(f"{name}: the wrapper synchronizes: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"sync-free {list(names)}: no host-device sync", flush=True)
    return list(names)


def spilling(ptxas):
    """The ptxas lines of the NO_SPILL libraries that report a spill."""
    return [line for line in ptxas if line.split(":")[0] in NO_SPILL
            and "spill" in line
            and "0 bytes spill stores, 0 bytes spill loads" not in line]


def mma_counts(sass):
    """{function: number of HMMA / HGMMA instructions} in a cuobjdump
    -sass listing."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(?:G)?MMA\b", line):
            counts[fn] += 1
    return counts


def conv_sass_report(lib_path, nvcc):
    """Tensor-core instruction counts of every function in the built conv
    library (cuobjdump -sass), names demangled by cu++filt."""
    bindir = os.path.dirname(nvcc)
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                           lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = mma_counts(sass)
    names = list(counts)
    demangled = subprocess.run(
        [os.path.join(bindir, "cu++filt")], input="\n".join(names),
        capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines()
    return {d.strip(): counts[m] for m, d in zip(names, demangled)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detail", default=os.path.join(
        ROOT, "build", "chip_smoke", "chip_smoke.json"),
        help="where to write every record as one JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    from wsl4mis_torch.data import (
        ArraySliceDataset,
        synthetic_slices,
        synthetic_volumes,
    )
    from wsl4mis_torch.data.random_walker import pseudo_label_generator_acdc
    from wsl4mis_torch.ops import _build
    from wsl4mis_torch.ops.gated_crf import DEFAULT_KERNELS_DESC

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)

    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    phase_s = {"build": build_s}
    print(f"build: {sorted(_build.LIBRARIES)} in {build_s:.1f} s", flush=True)
    ptxas = [f"{name}: {line.strip()}"
             for name, log in sorted(_build.build_logs.items())
             for line in log.splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry function" in line]
    for line in ptxas:
        print(f"ptxas {line}", flush=True)
    spills = spilling(ptxas)
    expect(not spills, f"ptxas: kernels of {NO_SPILL} spill: {spills}")
    sass = conv_sass_report(_build.lib_path("conv3x3"), _build.nvcc_path())
    for fn, count in sorted(sass.items()):
        print(f"sass conv3x3: {count} HMMA/HGMMA in {fn}", flush=True)
    # 8 forward (BN 16..128, with and without moments), 3 wgrad (BN 16..64)
    mma = {fn: k for fn, k in sass.items() if "_mma_kernel" in fn}
    expect(len(mma) == 11 and all(mma.values()),
           f"sass: the bf16 conv kernels hold no tensor-core op: {mma}")

    recs = []
    for dtype in ("bfloat16", "float32"):
        for name, c, o, h in unet_convs():
            recs += check_conv(name, c, o, h, dtype, N,
                               timed=dtype == "bfloat16",
                               repeat=dtype == "bfloat16")
            for n in (MS_N, DMPLS_N):
                recs += check_conv(name, c, o, h, dtype, n, timed=False)
            for n in (EVAL_N, REFRESH_N):
                recs += check_conv(name, c, o, h, dtype, n, timed=False,
                                   eval_only=True)
        for c, o, h, wd in RAGGED_CONVS:
            recs += check_conv(f"ragged {c}->{o}", c, o, h, dtype, 2,
                               timed=False, width=wd, case="ragged")
        recs += check_conv("ragged n1", 32, 16, HW, dtype, 1, timed=False,
                           case="ragged")
        for name, c, h in unet_pools():
            for ties in (False, True):
                recs += check_pool(name, c, h, dtype, N, ties,
                                   timed=dtype == "bfloat16" and not ties)
                for n in (MS_N, DMPLS_N):
                    recs += check_pool(name, c, h, dtype, n, ties,
                                       timed=False)
                for n in (EVAL_N, REFRESH_N):
                    recs += check_pool(name, c, h, dtype, n, ties,
                                       timed=False, backward=False)
    calls = wrapper_calls()
    host_us = wrapper_host_us(calls)
    print("wrapper-host-us " + json.dumps(host_us), flush=True)
    sync_free = check_sync_free(calls)
    recs += check_augment(args.seed, N, timed=True)
    recs += check_augment(args.seed + 1, DMPLS_N, timed=False)
    recs += check_augment(args.seed + 2, MS_N, timed=False)
    for i, h in enumerate(AUG_PLANES):
        recs += check_augment_angles(args.seed + 3 + i, h)
    # S2L's variant: the s2l step's batch (timed), a refresh chunk's worth
    # of samples, and every policy on each plane
    recs += check_augment(args.seed + 6, SEMI_N, timed=True, s2l=True)
    recs += check_augment(args.seed + 7, REFRESH_N, timed=False, s2l=True,
                          case=f"batch {REFRESH_N}")
    for i, h in enumerate(AUG_PLANES):
        recs += check_augment_angles(args.seed + 8 + i, h, s2l=True)
    desc = DEFAULT_KERNELS_DESC
    recs += check_gated_crf(DMPLS_N, HW, HW, GCRF_RADIUS, desc, True,
                            args.seed, "path")
    recs += check_gated_crf(N, HW, HW, GCRF_RADIUS, desc, True,
                            args.seed + 1, "batch 24")
    # ragged tile edges (40 x 72 against 32 x 32 tiles): the default list
    # at radius 3 and 5, the general instantiation on two descriptors, and
    # with every feature (xy too) read from memory
    for r in (3, GCRF_RADIUS):
        recs += check_gated_crf(2, 40, 72, r, desc, False, args.seed + 2,
                                "ragged")
    recs += check_gated_crf(2, 40, 72, 3, TWO_DESC, False, args.seed + 2,
                            "two descriptors")
    recs += check_gated_crf(2, 40, 72, 3, TWO_DESC, False, args.seed + 2,
                            "two descriptors", stored_xy=True)

    phase_s["kernels"] = time.perf_counter() - t0 - build_s
    data = synthetic_slices(480, (HW, HW), seed=args.seed)
    scribbles = synthetic_slices(480, (HW, HW), seed=args.seed,
                                 sup_type="scribble")
    val = synthetic_volumes(2, 10, 216, 256, seed=args.seed + 1)
    runs = [
        run_method("fully_supervised", "unet", N, 20, True, data, val,
                   args.seed),
        run_method("pce", "unet", N, 5, False, scribbles, val, args.seed),
        run_method("dmpls", "unet_cct", DMPLS_N, 10, False, scribbles, val,
                   args.seed),
        run_method("pce_gatedcrf", "unet", DMPLS_N, 10, False, scribbles,
                   val, args.seed),
    ]
    for method, batch in (("pce_tv", N), ("pce_entropy_mini", N),
                          ("pce_mumford_shah", MS_N),
                          ("pce_intensity_variance", N)):
        runs.append(run_method(method, "unet", batch, 3, False, scribbles,
                               val, args.seed, time_steps=0))
    # pce_random_walker: fully_supervised's step on the random walker's
    # labels of RW_SLICES scribble slices (host scipy, timed)
    t_rw = time.perf_counter()
    rw_labels = np.stack([pseudo_label_generator_acdc(im, sc) for im, sc in
                          zip(scribbles.images[:RW_SLICES],
                              scribbles.labels[:RW_SLICES])])
    rw_s = time.perf_counter() - t_rw
    print(f"random-walker labels: {RW_SLICES} slices in {rw_s:.2f} s",
          flush=True)
    expect(set(np.unique(rw_labels)) == {0, 1, 2, 3},
           f"random walker labels hold {np.unique(rw_labels)}")
    runs.append(run_method(
        "pce_random_walker", "unet", N, 3, False,
        ArraySliceDataset(scribbles.images[:RW_SLICES], rw_labels), val,
        args.seed, time_steps=0))
    runs[-1]["label_s"] = rw_s
    # slice 3: the semi-supervised family on a labeled tenth and the rest
    # unlabeled (dense labels on both, as its build reads them), ustm on the
    # scribbles; batch 12, labeled_bs 6
    labeled = ArraySliceDataset(data.images[:48], data.labels[:48])
    unlabeled = ArraySliceDataset(data.images[48:], data.labels[48:])
    runs.append(run_method("uamt", "unet", SEMI_N, 10, True,
                           (labeled, unlabeled), val, args.seed))
    runs.append(run_method("ustm", "unet", SEMI_N, 10, False, scribbles, val,
                           args.seed))
    # slice 4: s2l, two refreshes inside 10 steps (period_iter 5) and the
    # pseudo-label term open from step 5. thr_conf 0.04 lies under every
    # pixel's largest buffer value after one refresh (alpha * max_c p_c >=
    # 0.2 / 4), so the term is live at once; at the reference 0.8 it takes
    # eight refreshes from a zero buffer.
    runs.append(run_method("s2l", "unet", SEMI_N, 10, False, scribbles, val,
                           args.seed, period_iter=5, thr_iter=5,
                           thr_conf=0.04))
    for method in ("mean_teacher", "entropy_minimization",
                   "partially_supervised", "deep_adversarial"):
        runs.append(run_method(method, "unet", SEMI_N, 3, False,
                               (labeled, unlabeled), val, args.seed,
                               time_steps=0))
    fs = runs[0]["losses"]
    expect(np.mean(fs[-5:]) < np.mean(fs[:5]),
           f"fully_supervised loss did not fall: {fs}")
    phase_s["training"] = time.perf_counter() - t0 - sum(phase_s.values())
    ref = reference_check(args.seed)
    phase_s["reference"] = time.perf_counter() - t0 - sum(phase_s.values())
    print("phase-s " + json.dumps(phase_s), flush=True)

    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    idle = sorted(k for k, v in launches.items() if v == 0)
    expect(not idle, f"kernels never launched on a training path: {idle}")
    kernels = summarize(recs, launches)
    table = conv_table(recs)
    for row in table:
        print(f"conv-table {row}", flush=True)
    detail = {"card": card, "torch": torch.__version__,
              "build_s": build_s, "phase_s": phase_s, "ptxas": ptxas,
              "sass_mma": sass,
              "wrapper_host_us": host_us, "sync_free": sync_free,
              "conv_table": table, "checks": recs,
              "runs": runs,
              "reference": ref, "kernels": kernels}
    os.makedirs(os.path.dirname(os.path.abspath(args.detail)), exist_ok=True)
    with open(args.detail, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
