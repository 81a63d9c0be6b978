#!/usr/bin/env python3
"""Smoke run of wsl4mis_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--detail PATH]

Run from the repository root. It needs CUDA and the CUDA toolkit (nvcc);
without a card it exits 2 and prints no result. Phases, each fatal on
failure:

1. The card (nvidia-smi name and power limit), and the build of every
   kernel from ``wsl4mis_torch/csrc`` (timed).
2. Kernels: each kernel of the U-Net training path against its plain
   PyTorch version on the card, at the path's shapes (every UNet 3x3 conv
   at 256x256, in bf16 and f32: forward, forward + moments, input
   gradient and weight gradient at batch 24 and at batch 6, the forward
   alone at the validation's 64-slice chunk; the augmentation on all
   three branches at batch 24 and 6). The batch-24 bf16 launches are
   timed: CUDA-event medians of 12 launches after 3 warm-up launches,
   for the kernel, its plain version and, where one PyTorch call
   computes the same function, that call (library_ms; cuDNN's
   conv). bound_ms is max(bytes / 3.35 TB/s, flops / peak) with bf16 at
   989 TFLOP/s and f32 at 67 TFLOP/s (H100 SXM data sheet). Tolerances:
   f32 (TF32 off) 1e-4 of the largest reference magnitude; bf16 outputs 2
   bf16 ulps (ulp floored at 2^-8 of the largest magnitude); moments 1e-4
   of the largest, against the sums over the kernel's own y; weight
   gradient 1e-3 (f32) / 1e-2 (bf16) in norm;
   augmentation exact.
3. The training path at full width (features 16..256, 256x256, bf16) on
   synthetic phantom data made from --seed, through Trainer: fully_supervised
   (UNet, batch 24, 20 steps, one validation), pce (5 steps) and dmpls
   (UNet_CCT, batch 6, 10 steps). Launch counters are zeroed before each
   run and must show every kernel at its per-step count; losses must be
   finite and fall for fully_supervised; checkpoints must exist. Then
   ms/step and slices/s of each step in a synchronized loop of 10 steps,
   and a torch.profiler trace of the same 10 (device kernel time by name,
   the device's busy share).
4. Reference: a full-width UNet in f32, batch 2, at 64x64 and at 128x128
   on three seeds: its eval logits and train-mode loss and gradients on
   the card (kernels) against the same model on the CPU (plain
   versions), beside the CPU's own gradient spread and a known-wrong
   variant (bf16 kernels); see reference_check for the tolerances.

Output: detail lines, the per-kernel JSON line, the nvidia-smi line, and
last {"ok": true, "device": {...}}. All records also go to one JSON file,
build/chip_smoke/chip_smoke.json unless --detail names another.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N, HW = 24, 256  # fully_supervised / pce batch, slice size
DMPLS_N = 6  # dmpls batch
EVAL_N = 64  # slices per validation forward (VolumePredictor's chunk)
FEATURES = (16, 32, 64, 128, 256)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SRC_CONV = "wsl4mis_torch/csrc/conv3x3.cu"
PALLAS_CONV = "wsl4mis_tpu/ops/pallas/banded_conv_pallas.py"


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


def check_conv(name, c, o, h, dtype_name, n, timed, eval_only=False):
    """Check (and, if timed, time) fwd, fwd_stats and wgrad at one conv
    shape and batch n, and the dgrad (the fwd kernel on g with rotated
    weights). eval_only checks the fwd alone: the validation forward runs
    every conv through it. Returns records."""
    import torch
    import torch.nn.functional as F

    from wsl4mis_torch.ops import conv3x3 as cv

    dt = getattr(torch, dtype_name)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(c * 1009 + o * 7 + h)
    init = 1.0 / math.sqrt(9 * c)  # torch's default init bound
    x = torch.randn((n, h, h, c), generator=gen, device=dev).to(dt)
    w = ((torch.rand((3, 3, c, o), generator=gen, device=dev) * 2 - 1)
         * init).to(dt)
    b = ((torch.rand((o,), generator=gen, device=dev) * 2 - 1)
         * init).to(dt)
    g = torch.randn((n, h, h, o), generator=gen, device=dev).to(dt)
    w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
    es = x.element_size()
    px = n * h * h
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
        if extra:
            rec.update(extra)
        if timed:
            rec["ms"] = time_ms(fn_k)
            rec["plain_ms"] = time_ms(fn_p)
            rec["library_ms"] = time_ms(fn_l) if fn_l else None
        recs.append(rec)
        print("kernel-check " + json.dumps(rec), flush=True)
        expect(ok, f"{kernel} {name} {dtype_name}: err {err} {unit}")

    # forward
    y = cv.conv3x3_fwd(x, w, b)
    yp = cv.conv3x3_plain(x, w, b)
    err, ok, unit = out_err(y, yp)
    nb_fwd = (px * c + 9 * c * o + o + px * o) * es
    record("conv3x3_fwd", [n, h, h, c, o], y, yp, err, ok, unit, nb_fwd,
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
    record("conv3x3_fwd_stats", [n, h, h, c, o], ys, yps, err,
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
        record("conv3x3_fwd", [n, h, h, o, c], dx, dxp, err, ok, unit,
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

    record("conv3x3_wgrad", [n, h, h, c, o], dk, dkp, err, err <= tol,
           "rel_norm", (px * c + px * o) * es + 9 * c * o * 4,
           lambda: cv.conv3x3_wgrad(x, g),
           lambda: cv.conv3x3_wgrad_plain(x, g), lib_wgrad)
    return recs


def check_augment(seed, b, timed):
    """The augment kernel against its plain version on a (b, 256, 256)
    batch. The first rows of the policy are set so that every batch of 3
    or more holds all three branches; the rest are drawn."""
    import torch

    from wsl4mis_torch.data.augment_device import sample_policy
    from wsl4mis_torch.ops import augment as ag

    dev, h = "cuda", HW
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((b, h, h), generator=gen, device=dev)
    labels = torch.randint(0, 5, (b, h, h), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[: b // 2] = labels[: b // 2].clamp(max=3)  # half without class 4
    flips = [(0, k, a, 0) for k in range(4) for a in range(2)]
    turns = [(1, 0, 0, ang) for ang in (-20, -13, -7, -1, 0, 5, 11, 19)]
    rows = [r for trio in zip(flips, turns, [(2, 0, 0, 0)] * 8)
            for r in trio][:b]
    policy = sample_policy(gen, labels)
    policy[: len(rows)] = torch.tensor(rows, dtype=torch.int32, device=dev)
    img, lab = ag.augment_batch(images, labels, policy)
    img_p, lab_p = ag.augment_batch_plain(images, labels, policy)
    mismatched = int((img != img_p).sum() + (lab != lab_p).sum())
    rec = {"kernel": "augment", "shape": [b, h, h], "dtype": "float32+int32",
           "max_abs_err": float((img - img_p).abs().max()),
           "mismatched_pixels": mismatched, "ok": mismatched == 0,
           "branches": sorted(set(policy[:, 0].tolist())),
           **bound(b * h * h * 16 + b * 16, 0.0, "float32")}
    if timed:
        rec["ms"] = time_ms(lambda: ag.augment_batch(images, labels, policy))
        rec["plain_ms"] = time_ms(
            lambda: ag.augment_batch_plain(images, labels, policy))
        rec["library_ms"] = None
    print("kernel-check " + json.dumps(rec), flush=True)
    expect(rec["ok"] and rec["branches"] == [0, 1, 2],
           f"augment: {mismatched} pixels differ from the plain version")
    return [rec]


# ---- phase 3: the training path ---------------------------------------------


def launch_counts():
    from wsl4mis_torch.ops import augment as ag
    from wsl4mis_torch.ops import conv3x3 as cv

    return {**cv.launches, **ag.launches}


def reset_counts():
    from wsl4mis_torch.ops import augment as ag
    from wsl4mis_torch.ops import conv3x3 as cv

    for d in (cv.launches, ag.launches):
        for k in d:
            d[k] = 0


def per_step_counts(model_name):
    """Expected launches per training step: every ConvBlock conv is a stats
    launch, each head a fwd launch, every conv but the stem a dgrad (fwd)
    launch, every conv a wgrad launch, and one augment launch."""
    decoders = 2 if model_name == "unet_cct" else 1
    blocks = 10 + 8 * decoders
    convs = blocks + decoders
    return {"conv3x3_fwd_stats": blocks, "conv3x3_fwd": decoders + convs - 1,
            "conv3x3_wgrad": convs, "augment": 1}


def run_method(method, model_name, batch, steps, validate, data, val,
               seed, time_steps=10):
    import numpy as np
    import torch

    from wsl4mis_torch.engine.config import TrainConfig
    from wsl4mis_torch.engine.methods import get_method
    from wsl4mis_torch.engine.methods.common import (
        MethodBundle,
        index_batches,
        make_model_and_state,
        split_rngs,
        stage_dataset,
    )
    from wsl4mis_torch.engine.trainer import Trainer

    snap_root = os.path.join(ROOT, "build", "chip_smoke", method)
    cfg = TrainConfig(
        method=method, model=model_name, batch_size=batch,
        max_iterations=steps, val_every=(steps if validate else 10 ** 9),
        ckpt_every=steps, log_every=5, compute_dtype="bfloat16",
        snapshot_root=snap_root, seed=seed, device="cuda",
        sup_type="label" if method == "fully_supervised" else "scribble",
    )
    model, state = make_model_and_state(cfg, model_name=model_name)
    step_fn = get_method(method).make_step(cfg)
    losses, vals = [], []

    def recording_step(state, batch, rngs, aux=None):
        m = step_fn(state, batch, rngs, aux)
        losses.append(m["total_loss"])
        return m

    bundle = MethodBundle(
        model=model, state=state, step_fn=recording_step,
        data_iter=index_batches(cfg, data), val_volumes=val,
        steps_per_epoch=len(data) // batch, aux=stage_dataset(cfg, data))
    trainer = Trainer(cfg, bundle, use_tensorboard=False)
    validate_fn = trainer.validate
    trainer.validate = lambda it: vals.append(validate_fn(it)) or vals[-1]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    per = per_step_counts(model_name)
    expected = {k: v * steps for k, v in per.items()}
    if validate:  # eval forwards: every conv is a fwd launch per chunk
        depth = sum(-(-v["image"].shape[0] // 8) * 8 for v in val)
        expected["conv3x3_fwd"] += per["conv3x3_wgrad"] * -(-depth // 64)
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

    # steady-state step time: synchronized loop over the same step
    it = index_batches(cfg, data)
    batches = [next(it) for _ in range(time_steps)]
    rngs = [split_rngs(seed, 1000 + i, "cuda") for i in range(time_steps)]
    step_fn(state, batches[0], rngs[0], bundle.aux)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt, rg in zip(batches, rngs):
        step_fn(state, bt, rg, bundle.aux)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / time_steps
    rec.update({"ms_per_step": ms, "slices_per_s": 1e3 * batch / ms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    rec["profile"] = profile_steps(step_fn, state, batches, rngs,
                                   bundle.aux)
    print("slice-run " + json.dumps(rec), flush=True)
    return rec


def profile_steps(step_fn, state, batches, rngs, aux, top=12):
    """torch.profiler over the given steps: device kernel time by name
    (the top ones), the device's busy share of the window, and the
    window's ms/step (the profiler slows the host side)."""
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
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    expect(busy_us > 0, "profile: no device time recorded")
    steps = len(batches)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"ms_per_step": 1e-3 * wall_us / steps,
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
    training step's shapes (bf16, batch 24, the timed records);
    max_abs_err over every bf16 check of a launch on the training path
    (batches 24 and 6, and the validation forward)."""
    rows = {
        "conv3x3_fwd": (SRC_CONV, f"{PALLAS_CONV}:329"),
        "conv3x3_fwd_stats": (SRC_CONV, f"{PALLAS_CONV}:340"),
        "conv3x3_wgrad": (SRC_CONV, f"{PALLAS_CONV}:377"),
        "augment": ("wsl4mis_torch/csrc/augment.cu",
                    "wsl4mis_tpu/ops/pallas/augment_pallas.py:137"),
    }
    out = []
    for name, (source, replaces) in rows.items():
        path = [r for r in recs if r["kernel"] == name
                and r["dtype"] in ("bfloat16", "float32+int32")
                and _on_path(r)]
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
    head, for every dgrad and for every conv of the validation forward."""
    if r["kernel"] == "conv3x3_fwd_stats":
        return r["conv"] != "head"
    if r["kernel"] == "conv3x3_fwd":
        return r.get("role") in ("dgrad", "eval") or r["conv"] == "head"
    return True


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

    from wsl4mis_torch.data import synthetic_slices, synthetic_volumes
    from wsl4mis_torch.ops import _build

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
    print(f"build: {sorted(_build.LIBRARIES)} in {build_s:.1f} s", flush=True)
    ptxas = [f"{name}: {line.strip()}"
             for name, log in sorted(_build.build_logs.items())
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas:
        print(f"ptxas {line}", flush=True)

    recs = []
    for dtype in ("bfloat16", "float32"):
        for name, c, o, h in unet_convs():
            recs += check_conv(name, c, o, h, dtype, N,
                               timed=dtype == "bfloat16")
            recs += check_conv(name, c, o, h, dtype, DMPLS_N, timed=False)
            recs += check_conv(name, c, o, h, dtype, EVAL_N, timed=False,
                               eval_only=True)
    recs += check_augment(args.seed, N, timed=True)
    recs += check_augment(args.seed + 1, DMPLS_N, timed=False)

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
    ]
    fs = runs[0]["losses"]
    expect(np.mean(fs[-5:]) < np.mean(fs[:5]),
           f"fully_supervised loss did not fall: {fs}")
    ref = reference_check(args.seed)

    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    kernels = summarize(recs, launches)
    detail = {"card": card, "torch": torch.__version__,
              "build_s": build_s, "ptxas": ptxas, "checks": recs,
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
